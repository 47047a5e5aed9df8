"""Seeded parameter initialisers with the JAX package's distributions.

Each takes an explicit `torch.Generator`, so a model built from a seed has
the same weights on every device it is moved to.
"""

import math

import torch


def _fans(t):
    """(fan_in, fan_out) of a Linear (O, I) or conv (O, I, kh, kw) weight."""
    receptive = t[0][0].numel() if t.dim() > 2 else 1
    return t.shape[1] * receptive, t.shape[0] * receptive


@torch.no_grad()
def lecun_normal_(t, g):
    """Truncated normal (2 std) with variance 1/fan_in (flax's default)."""
    std = math.sqrt(1.0 / _fans(t)[0]) / 0.87962566103423978
    t.copy_(torch.fmod(torch.randn(t.shape, generator=g), 2.0) * std)
    return t


@torch.no_grad()
def xavier_uniform_(t, g):
    fan_in, fan_out = _fans(t)
    a = math.sqrt(6.0 / (fan_in + fan_out))
    t.copy_(torch.rand(t.shape, generator=g) * (2 * a) - a)
    return t


@torch.no_grad()
def uniform_(t, g, lo=0.0, hi=1.0):
    t.copy_(torch.rand(t.shape, generator=g) * (hi - lo) + lo)
    return t


@torch.no_grad()
def reset_default_(module, g):
    """Flax defaults for every Linear / conv / norm in `module`: lecun-normal
    weights, zero biases, unit norm scales. Modules with other initialisers
    override them afterwards in their own `reset_parameters_(g)`."""
    for mod in module.modules():
        if isinstance(mod, (torch.nn.Linear, torch.nn.Conv2d,
                            torch.nn.ConvTranspose2d)):
            w = mod.weight
            # a transposed conv's weight is (I, O, kh, kw)
            lecun_normal_(w.transpose(0, 1) if isinstance(
                mod, torch.nn.ConvTranspose2d) else w, g)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    for mod in module.modules():
        if hasattr(mod, "reset_parameters_"):
            mod.reset_parameters_(g)
