"""Box attention's inference sampling (K9), one launch a call.

    out[b, q, h, :] = sum_{l, p} sum_c w_c(l, p) * value[b, s_c(l, p), h, :]

for value (B, S, H, 32) and gx, gy, attn_weight (B, H, L, P, LQ): the taps
follow `combine_reduce.tap_rows` (x = gx*W - 0.5, floor, fractions; a tap
counts where x0 lies in [-1, W-1] and y0 in [-1, H-1]), the corners c are
the tap's 2x2 pixels of level l read straight from the value, zero outside
the level, and w_c = `corner_weights(lx, ly, wt)`. This is
`box_attention_qminor(fold=True)` under the p-major combine: the JAX
package's `_box_attention_qminor_folded(fused=True)` (quad tables, a
`jnp.take` a level, then `fused_combine_reduce_raw` (K1) or
`fused_combine_reduce` (K2), summed over the levels in f32). The kernel is
`csrc/box_sample.cu`; its note has the design.

`box_sample_reduce` launches it on a CUDA tensor and runs its plain
version, `box_sample_reduce_plain`, on a CPU tensor; there is no other
fallback. Both return the output in the (B, LQ, H, 32) layout, in the
value's dtype, summed in f32; the op hands out its (B, H, LQ, 32) view. The
kernel's output has no `grad_fn`.
"""

import ctypes

import torch

from boxer_tpu_torch.ops import _build
from boxer_tpu_torch.ops.combine_reduce import CH, corner_weights
from boxer_tpu_torch.utils.general import level_start_index

# the kernel takes the level shapes by value
MAX_LEVELS = 8
# the corners in `corner_weights`' order, as (dy, dx)
CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))


def box_sample_reduce_plain(value, shapes, gx, gy, attn_weight):
    """Plain version of K9: each level's four corners gathered from the
    value and weighted in f32, any head width. Returns (B, LQ, H, Ch) in
    the value's dtype."""
    b, s, nh, ch = value.shape
    _, _, nl, npt, lq = gx.shape
    flat = value.reshape(b * s * nh, ch).float()
    dev = value.device
    # the flat row of pixel 0 of each (b, h), against (B, H, P, LQ)
    base = (torch.arange(b, device=dev)[:, None, None, None] * (s * nh)
            + torch.arange(nh, device=dev)[None, :, None, None])
    out = torch.zeros((b, nh, lq, ch), dtype=torch.float32, device=dev)
    for li, ((hl, wl), start) in enumerate(zip(shapes,
                                               level_start_index(shapes))):
        x = gx[:, :, li].float() * wl - 0.5
        y = gy[:, :, li].float() * hl - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        lx, ly = x - x0, y - y0
        valid = (x0 >= -1) & (x0 <= wl - 1) & (y0 >= -1) & (y0 <= hl - 1)
        wt = torch.where(valid, attn_weight[:, :, li].float(), 0.0)
        # clamped before the conversion: a far tap reads nothing
        xi, yi = x0.clamp(-1, wl).long(), y0.clamp(-1, hl).long()
        for w, (dy, dx) in zip(corner_weights(lx, ly, wt).unbind(1),
                               CORNERS):
            xc, yc = xi + dx, yi + dy
            inside = (xc >= 0) & (xc < wl) & (yc >= 0) & (yc < hl)
            rows = base + (start + yc.clamp(0, hl - 1) * wl
                           + xc.clamp(0, wl - 1)) * nh
            v = flat.index_select(0, rows.reshape(-1)).reshape(
                b, nh, npt, lq, ch)
            out += (v * torch.where(inside, w, 0.0)[..., None]).sum(dim=2)
    return out.to(value.dtype).permute(0, 2, 1, 3).contiguous()


def _launch(value, shapes, gx, gy, attn_weight):
    """Check the arguments and launch the kernel; returns (B, LQ, H, 32)."""
    name = "box_sample_reduce"
    if value.dim() != 4 or value.shape[3] != CH:
        raise ValueError(f"{name}: value must be (B, S, H, {CH}), got "
                         f"{tuple(value.shape)}")
    b, s, nh, _ = value.shape
    if gx.dim() != 5 or tuple(gx.shape[:2]) != (b, nh):
        raise ValueError(f"{name}: gx must be ({b}, {nh}, L, P, LQ), got "
                         f"{tuple(gx.shape)}")
    nl, npt, lq = gx.shape[2:]
    if not 1 <= nl <= MAX_LEVELS or len(shapes) != nl:
        raise ValueError(f"{name}: {len(shapes)} shapes and {nl} levels (1 "
                         f"to {MAX_LEVELS})")
    if sum(h * w for h, w in shapes) != s:
        raise ValueError(f"{name}: levels {shapes} do not tile {s} tokens")
    if s * nh * CH >= 2 ** 31:
        raise ValueError(f"{name}: an image's value exceeds int32 offsets")
    if npt < 1:
        raise ValueError(f"{name}: no taps")
    if value.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: value dtype {value.dtype}")
    grids = (gx, gy, attn_weight)
    for t in grids:
        if t.dtype != torch.float32 or t.shape != gx.shape:
            raise ValueError(f"{name}: gx, gy, attn_weight must be f32 "
                             f"{tuple(gx.shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for t in (value, *grids):
        if t.device != value.device:
            raise ValueError(f"{name}: tensors on different devices")
    if not value.is_cuda:
        raise ValueError(f"{name}: unsupported device {value.device}")
    if not value.is_contiguous():
        raise ValueError(f"{name}: value must be contiguous")
    if value.data_ptr() % 16:
        # each lane reads 16 bytes of a pixel's head
        raise ValueError(f"{name}: value must be 16-byte aligned")
    out = torch.empty((b, lq, nh, CH), dtype=value.dtype, device=value.device)
    hw = (ctypes.c_int * (2 * nl))(*(int(v) for hw in shapes for v in hw))
    strides = [(ctypes.c_longlong * 5)(*t.stride()) for t in grids]
    lib = _build.library()
    with torch.cuda.device(value.device):
        err = lib.box_sample_reduce(
            value.device.index, int(value.dtype == torch.bfloat16),
            value.data_ptr(), hw, nl,
            *(a for t, st in zip(grids, strides) for a in (t.data_ptr(), st)),
            out.data_ptr(), b, nh, s, npt, lq,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, name)
    return out


def box_sample_reduce(value, shapes, gx, gy, attn_weight):
    """K9. value: (B, S, H, 32) bf16 or f32, contiguous, 16-byte aligned;
    shapes: ((Hl, Wl), ...), at most 8 levels tiling S; gx, gy,
    attn_weight: (B, H, L, P, LQ) f32, any strides. Returns (B, LQ, H, 32)
    in the value's dtype, summed in f32, with no `grad_fn`."""
    if value.device.type == "cpu":
        return box_sample_reduce_plain(value, shapes, gx, gy, attn_weight)
    out = _launch(value, tuple(map(tuple, shapes)), gx, gy, attn_weight)
    box_sample_reduce.launches += 1
    return out


box_sample_reduce.launches = 0
