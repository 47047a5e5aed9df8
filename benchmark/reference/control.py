"""The control: the reference computed in fp8, the precision below bf16.

Every weight matrix and convolution kernel, and every input of a Linear or
a convolution, is rounded to fp8 (e4m3) with one scale a tensor, its
largest magnitude at 448, the way an fp8 GEMM on Hopper takes its operands;
the products still sum in f32. A program that took this step would read as
this control does, so the comparison has to fail it.
"""

import torch
from torch import nn

FP8_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 at a per-tensor scale, back in x's dtype."""
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / FP8_MAX
    return ((x.float() / scale).to(torch.float8_e4m3fn).float()
            * scale).to(x.dtype)


def _round_input(module, args):
    return (fp8(args[0]),) + tuple(args[1:])


@torch.no_grad()
def to_fp8(model: nn.Module) -> nn.Module:
    """Round `model`'s matrices and kernels to fp8 in place and make every
    Linear and convolution round its input; returns the model."""
    for p in model.parameters():
        if p.dim() >= 2:
            p.copy_(fp8(p))
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            mod.register_forward_pre_hook(_round_input)
    return model
