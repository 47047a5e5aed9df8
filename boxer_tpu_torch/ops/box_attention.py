"""Multi-scale box attention / instance attention sampling ops, inference.

PyTorch port of `boxer_tpu/ops/box_attention.py`: the quad-table layout
(`_build_quad_tables`), the folded inference path of `box_attention_qminor`
and the dual-output `instance_attention_qminor`, plus the reference-contract
wrappers:

  box_attention(value (B,S,H,Ch), shapes ((H1,W1),...), loc (B,Lq,H,L,P,2),
                weight (B,Lq,H,L,P)) -> (B, Lq, H*Ch)

  instance_attention(value, shapes, loc (...,P=k*k,2), spatial_w (B,Lq,H,L,P),
                     level_w (B,Lq,H,L,P)) -> (out (B,Lq,H*Ch),
                                               mask_out (B,Lq,k,k,H*Ch))

Sampling convention: locations normalized to [0,1]; pixel coords
`x = loc_x * W - 0.5` with zero padding outside, i.e. `F.grid_sample(...,
align_corners=False)` at grid `2*loc - 1`. Each level is packed into a quad
table whose row holds a pixel's 2x2 neighbourhood of the zero-bordered
level, so one row carries all four bilinear corners and a tap is valid as a
whole when its top-left corner lies in [-1, W-1] x [-1, H-1].

Taps are folded p-major: row order (p, b, h, lq), M = B*H*LQ. The P-sum and
the corner combine run in `quad_sample_reduce_raw` (K1, corner weights
formed in the kernel, P <= 8) or `quad_sample_reduce_w4` (K2, precomputed
corner weights, P > 8). The training path
(per-tap sampling and custom backward) is not part of this port yet.
"""

from typing import Tuple

import torch
import torch.nn.functional as F

from boxer_tpu_torch.ops.combine_reduce import (corner_weights,
                                                quad_sample_reduce_raw,
                                                quad_sample_reduce_w4)
from boxer_tpu_torch.utils.general import level_start_index

Shapes = Tuple[Tuple[int, int], ...]

# taps per output up to which the raw-weight mode (K1) is used; above it the
# corner weights are precomputed (K2), as in the JAX package
ONEPASS_MAX_P = 8


def _build_quad_tables(value, shapes: Shapes):
    """Pack each level's 2x2 pixel neighbourhoods into 4*Ch-wide rows.

    value: (B, S, H, Ch). Returns one table per level, (BH*(Hl+1)*(Wl+1),
    4*Ch), row r = [V[y,x], V[y,x+1], V[y+1,x], V[y+1,x+1]] of the
    zero-border-padded level, with BH slices of (Hl+1)*(Wl+1) rows.
    """
    b, s, nh, ch = value.shape
    bh = b * nh
    starts = level_start_index(shapes)
    v = value.permute(0, 2, 1, 3).reshape(bh, s, ch)
    tables = []
    for li, (hl, wl) in enumerate(shapes):
        lvl = v[:, starts[li]:starts[li] + hl * wl].reshape(bh, hl, wl, ch)
        lvl = F.pad(lvl, (0, 0, 1, 1, 1, 1))
        q = torch.cat([lvl[:, :-1, :-1], lvl[:, :-1, 1:],
                       lvl[:, 1:, :-1], lvl[:, 1:, 1:]], dim=-1)
        tables.append(q.reshape(bh * (hl + 1) * (wl + 1), 4 * ch))
    return tables


def _tap_rows(gx, gy, hl: int, wl: int):
    """gx, gy: (P, BH, LQ) f32 in [0,1] -> quad-table rows (P, BH, LQ) int32
    (with the per-BH slice offset), bilinear fractions lx, ly and the
    whole-tap validity."""
    bh = gx.shape[1]
    x = gx * wl - 0.5
    y = gy * hl - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    lx = x - x0
    ly = y - y0
    x0i = x0.to(torch.int32)
    y0i = y0.to(torch.int32)
    valid = (x0i >= -1) & (x0i <= wl - 1) & (y0i >= -1) & (y0i <= hl - 1)
    xq = (x0i + 1).clamp(0, wl)
    yq = (y0i + 1).clamp(0, hl)
    base = torch.arange(bh, dtype=torch.int32, device=gx.device)[None, :, None]
    idx = base * ((hl + 1) * (wl + 1)) + yq * (wl + 1) + xq
    return idx, lx, ly, valid


def _pmajor(t, bh: int, nl: int, npt: int, lq: int):
    """(B, H, L, P, LQ) -> (L, P, BH, LQ) f32, contiguous."""
    return t.reshape(bh, nl, npt, lq).permute(1, 2, 0, 3).float().contiguous()


def _merge_heads(raw):
    """(B, H, LQ, C) -> (B, LQ, H*C)."""
    b, nh, lq, ch = raw.shape
    return raw.permute(0, 2, 1, 3).reshape(b, lq, nh * ch)


def box_attention_qminor(value, shapes: Shapes, gx, gy, attn_weight,
                         raw: bool = False):
    """Box attention, query-minor inputs.

    value:       (B, S, H, Ch)
    gx, gy:      (B, H, L, P, LQ) normalized [0,1] sample coordinates
    attn_weight: (B, H, L, P, LQ), softmax-normalized over (L, P)
    returns      (B, LQ, H*Ch), or (B, H, LQ, Ch) when raw=True, in
                 value.dtype; accumulation is f32.
    """
    b, s, nh, ch = value.shape
    _, _, nl, npt, lq = gx.shape
    assert nl == len(shapes)
    bh = b * nh
    m = bh * lq

    tables = _build_quad_tables(value, shapes)
    gx = _pmajor(gx, bh, nl, npt, lq)
    gy = _pmajor(gy, bh, nl, npt, lq)
    aw = _pmajor(attn_weight, bh, nl, npt, lq)

    out = torch.zeros((m, ch), dtype=torch.float32, device=value.device)
    for li, (hl, wl) in enumerate(shapes):
        idx, lx, ly, valid = _tap_rows(gx[li], gy[li], hl, wl)
        w_tap = torch.where(valid, aw[li], 0.0)
        idx = idx.reshape(npt, m)
        if npt <= ONEPASS_MAX_P:
            out = out + quad_sample_reduce_raw(
                tables[li], idx, lx.reshape(npt, m), ly.reshape(npt, m),
                w_tap.reshape(npt, m))
        else:
            w4 = corner_weights(lx, ly, w_tap).reshape(npt, 4, m)
            out = out + quad_sample_reduce_w4(tables[li], idx, w4)
    out = out.to(value.dtype).reshape(b, nh, lq, ch)
    return out if raw else _merge_heads(out)


def box_attention(value, shapes: Shapes, sampling_loc, attn_weight):
    """Reference-contract wrapper.

    value:        (B, S, H, Ch)
    sampling_loc: (B, Lq, H, L, P, 2) in [0,1]
    attn_weight:  (B, Lq, H, L, P), softmax-normalized over (L, P)
    returns       (B, Lq, H*Ch) in value.dtype
    """
    gx = torch.movedim(sampling_loc[..., 0], 1, -1)      # (B, H, L, P, LQ)
    gy = torch.movedim(sampling_loc[..., 1], 1, -1)
    aw = torch.movedim(attn_weight, 1, -1)
    return box_attention_qminor(value, shapes, gx, gy, aw)


def instance_attention_qminor(value, shapes: Shapes, gx, gy, spatial_weight,
                              level_weight, kernel_size: int,
                              raw: bool = False):
    """Instance attention, query-minor inputs: one sampling pass, two sums.

      out[b,h,q]    = sum_{l,p} spatial_w * sample(l, p)
      mask[b,q,p,h] = sum_l     level_w   * sample(l, p)

    gx/gy/spatial_weight/level_weight: (B, H, L, P=k*k, LQ).
    Returns (out (B,LQ,H*Ch) — or (B,H,LQ,Ch) when raw=True — and mask_out
    (B,LQ,k,k,H*Ch)), in value.dtype. Plain torch: the JAX package runs this
    op in XLA with no Pallas kernel.
    """
    b, s, nh, ch = value.shape
    _, _, nl, npt, lq = gx.shape
    k = kernel_size
    assert npt == k * k
    bh = b * nh
    m = bh * lq

    tables = _build_quad_tables(value, shapes)
    gx = _pmajor(gx, bh, nl, npt, lq)
    gy = _pmajor(gy, bh, nl, npt, lq)
    sw = _pmajor(spatial_weight, bh, nl, npt, lq)
    lw = _pmajor(level_weight, bh, nl, npt, lq)

    out = torch.zeros((m, ch), dtype=torch.float32, device=value.device)
    mask = torch.zeros((npt, m, ch), dtype=torch.float32, device=value.device)
    for li, (hl, wl) in enumerate(shapes):
        idx, lx, ly, valid = _tap_rows(gx[li], gy[li], hl, wl)
        bw4 = corner_weights(lx, ly, valid.float()).reshape(npt, 4, m)
        g = tables[li][idx.reshape(-1).long()].float().reshape(npt, m, 4, ch)
        taps = (g * bw4.transpose(1, 2)[..., None]).sum(dim=2)   # (P, M, Ch)
        out = out + (taps * sw[li].reshape(npt, m, 1)).sum(dim=0)
        mask = mask + taps * lw[li].reshape(npt, m, 1)

    out = out.to(value.dtype).reshape(b, nh, lq, ch)
    # mask rows are (p=(ky,kx), b, h, lq) -> (B, LQ, k, k, H*Ch)
    mask_out = (mask.reshape(k, k, b, nh, lq, ch).permute(2, 4, 0, 1, 3, 5)
                .reshape(b, lq, k, k, nh * ch).to(value.dtype))
    if raw:
        return out, mask_out
    return _merge_heads(out), mask_out


def instance_attention(value, shapes: Shapes, sampling_loc, spatial_weight,
                       level_weight, kernel_size: int):
    """Reference-contract wrapper.

    value:          (B, S, H, Ch)
    sampling_loc:   (B, Lq, H, L, P=k*k, 2)
    spatial_weight: (B, Lq, H, L, P) — softmax over (L*P)
    level_weight:   (B, Lq, H, L, P) — softmax over L
    returns (out (B,Lq,H*Ch), mask_out (B,Lq,k,k,H*Ch))
    """
    gx = torch.movedim(sampling_loc[..., 0], 1, -1)
    gy = torch.movedim(sampling_loc[..., 1], 1, -1)
    sw = torch.movedim(spatial_weight, 1, -1)
    lw = torch.movedim(level_weight, 1, -1)
    return instance_attention_qminor(value, shapes, gx, gy, sw, lw,
                                     kernel_size)
