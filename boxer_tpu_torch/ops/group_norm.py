"""GroupNorm(32, C) + ReLU on an NHWC tensor at inference (K11), two
launches a call: the norm and activation between the BEV neck's
convolutions (`nn/backbone3d.py:ConvNet`).

`group_norm_relu_plain` is the function written out in torch: statistics
per frame and group over H x W x C / 32 values in f32 (in two passes: mean,
then the centred squares), the affine, the ReLU, rounded once to the
output's type. `group_norm_relu` takes it for a CPU tensor.

On a CUDA tensor `group_norm_relu` launches the kernel, `csrc/group_norm_
relu.cu`: a statistics pass (Welford by chunks, partials a pixel tile) and
an apply pass (the frame's partials merged, then y = max(x * scale +
shift, 0)), over one grid of (pixel tile, frame) blocks. It takes an
NHWC-contiguous x, bf16 or f32, C a multiple of 32 up to 1024, and a
weight and bias of one type, f32 or x's: a bf16 model's bf16 weights, an
f32 model's f32, or a bf16 convolution's output under autocast with the
f32 weights. Anything else raises, on either device.
The output's type is x's and the weights' promoted: f32 in the autocast
case, which is the type torch's route gives there (autocast runs
`group_norm` in f32). Its output has no `grad_fn`: the kernel has no
backward, so training keeps the module's `nn.GroupNorm` and `nn.ReLU`. It
differs from the plain version in rounding alone: its sums go in another
order. The source's note has the design.
"""

import ctypes
import functools

import torch

from boxer_tpu_torch.ops import _build

GROUPS = 32
MAX_CHANNELS = 1024
# the grid of both passes: blocks an SM, over the frames, and the fewest
# rows a tile; 1, 2, 4 and 8 blocks of 256 threads an SM in each pass read
# 2 x 2 the fastest at the pp3d.infer_b4 cell's shapes on an H100
BLOCKS_PER_SM = 2
MIN_TILE_ROWS = 32


def group_norm_relu_plain(x, weight, bias, eps):
    """x: (B, H, W, C); weight, bias: (C,). relu(GroupNorm(32, C)(x)) in
    NHWC, in x's and the weight's type promoted."""
    b, h, w, c = x.shape
    acc = torch.promote_types(x.dtype, torch.float32)
    g = x.to(acc).reshape(b, h * w, GROUPS, c // GROUPS)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = (g - mean).square().mean(dim=(1, 3), keepdim=True)
    scale = torch.rsqrt(var + eps) * weight.to(acc).reshape(GROUPS, -1)
    shift = bias.to(acc).reshape(GROUPS, -1) - mean * scale
    y = torch.relu(g * scale + shift).reshape(b, h, w, c)
    return y.to(torch.promote_types(x.dtype, weight.dtype))


def _check(x, weight, bias):
    """Raise on what the kernel does not take (the module docstring)."""
    name = "group_norm_relu"
    if x.dim() != 4 or 0 in x.shape:
        raise ValueError(f"{name}: x must be a non-empty (B, H, W, C), got "
                         f"{tuple(x.shape)}")
    c = x.shape[3]
    if c % GROUPS or c > MAX_CHANNELS:
        raise ValueError(f"{name}: C must be a multiple of {GROUPS} up to "
                         f"{MAX_CHANNELS}, got {c}")
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"{name}: weight and bias must be ({c},), got "
                         f"{tuple(weight.shape)} and {tuple(bias.shape)}")
    kinds = (torch.bfloat16, torch.float32)
    if (x.dtype not in kinds or weight.dtype != bias.dtype
            or weight.dtype not in (x.dtype, torch.float32)):
        raise TypeError(f"{name}: x bf16 or f32 and weight and bias of one "
                        f"type, f32 or x's; got {x.dtype}, {weight.dtype}, "
                        f"{bias.dtype}")
    for t in (weight, bias):
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on different devices")
    if not (x.is_contiguous() and weight.is_contiguous()
            and bias.is_contiguous()):
        raise ValueError(f"{name}: x must be NHWC-contiguous, weight and "
                         f"bias contiguous")


@functools.lru_cache(maxsize=None)
def _sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def tiles(sms, batch, hw):
    """Pixel tiles a frame on a card of `sms` SMs: `BLOCKS_PER_SM` blocks
    an SM over the frames, at most one a `MIN_TILE_ROWS` rows."""
    return max(1, min(hw // MIN_TILE_ROWS, -(-BLOCKS_PER_SM * sms // batch)))


def _launch(x, weight, bias, eps):
    b, h, w, c = x.shape
    if not x.is_cuda:
        raise ValueError(f"group_norm_relu: unsupported device {x.device}")
    nt = tiles(_sms(x.device.index), b, h * w)
    partials = torch.empty((b, nt, GROUPS, 3), dtype=torch.float32,
                           device=x.device)
    out = torch.empty(x.shape, dtype=weight.dtype, device=x.device)
    bf16 = torch.bfloat16
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.group_norm_relu(
            x.device.index, int(x.dtype == bf16), int(weight.dtype == bf16),
            x.data_ptr(), b, h * w, c, nt, ctypes.c_float(eps),
            weight.data_ptr(), bias.data_ptr(), partials.data_ptr(),
            out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "group_norm_relu")
    return out


def group_norm_relu(x, weight, bias, eps):
    """K11. x: (B, H, W, C) NHWC-contiguous, bf16 or f32, C a multiple of
    32 up to 1024; weight, bias: (C,), one type, f32 or x's; eps: the
    norm's. Returns relu(GroupNorm(32, C)(x)) as (B, H, W, C) in x's and
    the weight's type promoted, with no `grad_fn`. On a CPU tensor the
    plain version."""
    _check(x, weight, bias)
    if x.device.type == "cpu":
        return group_norm_relu_plain(x, weight, bias, eps)
    out = _launch(x, weight, bias, eps)
    group_norm_relu.launches += 1
    return out


group_norm_relu.launches = 0
