"""Box attention and instance attention, plain: each level's bilinear
samples gathered in f32 and summed with their weights.

Sampling convention, the port's: locations normalized to [0, 1], pixel
coordinates `x = loc_x * W - 0.5`, zeros outside the level
(`general.bilinear_sample_norm01`). Inputs are query-minor, as the
attention modules make them: value (B, S, H, Ch), the grids and weights
(B, H, L, P, LQ).
"""

from typing import Tuple

import torch

from .general import bilinear_sample_norm01, level_start_index

Shapes = Tuple[Tuple[int, int], ...]


def _samples(value, shapes: Shapes, gx, gy):
    """Per level, the samples of `value` at its taps: (B, H, P, LQ, Ch)
    f32."""
    b, _, nh, ch = value.shape
    npt, lq = gx.shape[3:]
    v = value.float().permute(0, 2, 1, 3).reshape(b * nh, -1, ch)
    for start, (h, w), x, y in zip(level_start_index(shapes), shapes,
                                   gx.unbind(2), gy.unbind(2)):
        img = v[:, start:start + h * w].reshape(b * nh, h, w, ch)
        loc = torch.stack([x, y], dim=-1).float().reshape(b * nh, -1, 2)
        yield bilinear_sample_norm01(img, loc).reshape(b, nh, npt, lq, ch)


def box_attention_qminor(value, shapes: Shapes, gx, gy, attn_weight):
    """sum over levels and taps of attn_weight * sample -> (B, H, LQ, Ch)
    in value's dtype."""
    out = 0.0
    for s, w in zip(_samples(value, shapes, gx, gy), attn_weight.unbind(2)):
        out = out + (s * w.float()[..., None]).sum(dim=2)
    return out.to(value.dtype)


def instance_attention_qminor(value, shapes: Shapes, gx, gy, spatial_weight,
                              level_weight, kernel_size: int):
    """Instance attention's two sums over one set of samples:

      out[b,h,q]    = sum_{l,p} spatial_w * sample(l, p)
      mask[b,q,p,h] = sum_l     level_w   * sample(l, p)

    Returns (out (B, H, LQ, Ch), mask_out (B, LQ, k, k, H*Ch)), the taps p
    row-major over (ky, kx), in value's dtype."""
    out = mask = 0.0
    for s, sw, lw in zip(_samples(value, shapes, gx, gy),
                         spatial_weight.unbind(2), level_weight.unbind(2)):
        out = out + (s * sw.float()[..., None]).sum(dim=2)
        mask = mask + s * lw.float()[..., None]
    b, nh, _, lq, ch = mask.shape
    mask_out = mask.permute(0, 3, 2, 1, 4).reshape(
        b, lq, kernel_size, kernel_size, nh * ch)
    return out.to(value.dtype), mask_out.to(value.dtype)
