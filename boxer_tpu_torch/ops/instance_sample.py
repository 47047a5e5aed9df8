"""Instance attention's dual-output sampling (K4).

One sampling pass over the k x k taps of the last decoder layer gives the
two sums of `instance_attention_qminor`'s inference branch:

    out[b, h, q]                  = sum_{l,p} spatial_w * sample(l, p)
    mask[b, q, ky, kx, h*32:+32]  = sum_l     level_w   * sample(l, p)

for the quad tables of `box_attention._build_quad_tables` and gx, gy,
spatial_w, level_w of shape (B, H, L, P = k*k, LQ), the sample following
`combine_reduce.tap_rows`. The JAX package computes this in XLA
(`boxer_tpu/ops/box_attention.py:639`) with no Pallas kernel; the port's
kernel is `csrc/instance_sample.cu`.

`instance_sample_reduce` launches it on a CUDA tensor and runs its plain
version, `instance_sample_reduce_plain`, on a CPU tensor; there is no other
fallback. The kernel's output has no `grad_fn`: a caller that needs a
gradient takes the differentiable path (`box_attention.QuadSample`).

The kernel's design (the source's note has it whole): a block of 4 warps
takes a tile of 8 consecutive queries of one (b, h), reads the tap inputs
along q and forms each tap's quad row and corner weights once into shared
memory; its warps take the tile's (q, p) items, a few threads an item, each
reading 16 bytes of every corner of the item's quad row; the mask leaves in
its final layout. A thread-block cluster of blocks shares a tile's taps, as
many as fill the card at the launch's shape (`launch_tile`), and `out` is
summed over the item groups, then over the cluster's blocks, in a fixed
order, so two launches give bitwise-equal outputs.
"""

import ctypes

import torch

from boxer_tpu_torch.ops import _build
from boxer_tpu_torch.ops.combine_reduce import (CH, corner_weights,
                                                pmajor_taps, tap_rows)

# the kernel takes each level's table by its own pointer
MAX_LEVELS = 4
# the grid's head and batch axes
MAX_GRID = 65535


def launch_tile(device, dtype, b: int, nh: int, lq: int):
    """The tile the kernel launches on CUDA `device` for tables of `dtype`
    at B, H, LQ: (queries, warps, blocks a cluster), from the built
    library; the cluster size depends on the card."""
    index = torch.device(device).index
    tile = (ctypes.c_int * 3)()
    _build.check(_build.library().instance_sample_tile(
        torch.cuda.current_device() if index is None else index,
        int(dtype == torch.bfloat16), b, nh, lq, tile),
        "instance_sample_tile")
    return tuple(tile)


def gather_taps(table, idx, bw4):
    """The plain per-tap samples of one level: `table[idx]` combined with
    the corner weights bw4 (P, 4, M) in f32 -> (P, M, ch) f32."""
    npt, m = idx.shape
    g = table[idx.reshape(-1).long()].float().reshape(npt, m, 4, -1)
    return (g * bw4.transpose(1, 2)[..., None]).sum(dim=2)


def instance_sample_reduce_plain(tables, shapes, gx, gy, spatial_w, level_w,
                                 k: int, sample=gather_taps):
    """Plain version of K4: level by level, the per-tap samples
    `sample(table, idx (P, M), bw4 (P, 4, M)) -> (P, M, ch)` summed in f32.
    Returns (out (B, H, LQ, ch), mask (B, LQ, k, k, H*ch)) in the tables'
    dtype. `box_attention.instance_attention_qminor` passes `QuadSample` as
    `sample` for its differentiable path."""
    b, nh, nl, npt, lq = gx.shape
    ch = tables[0].shape[1] // 4
    bh = b * nh
    m = bh * lq
    gx, gy, sw, lw = (pmajor_taps(t, bh, nl, npt, lq)
                      for t in (gx, gy, spatial_w, level_w))

    out = torch.zeros((m, ch), dtype=torch.float32, device=gx.device)
    mask = torch.zeros((npt, m, ch), dtype=torch.float32, device=gx.device)
    for li, (hl, wl) in enumerate(shapes):
        idx, lx, ly, valid = tap_rows(gx[li], gy[li], hl, wl)
        bw4 = corner_weights(lx, ly, valid.float()).reshape(npt, 4, m)
        taps = sample(tables[li], idx.reshape(npt, m), bw4)   # (P, M, ch)
        out = out + (taps * sw[li].reshape(npt, m, 1)).sum(dim=0)
        mask = mask + taps * lw[li].reshape(npt, m, 1)

    dtype = tables[0].dtype
    out = out.to(dtype).reshape(b, nh, lq, ch)
    # mask rows are (p=(ky,kx), b, h, lq) -> (B, LQ, k, k, H*Ch)
    mask_out = (mask.reshape(k, k, b, nh, lq, ch).permute(2, 4, 0, 1, 3, 5)
                .reshape(b, lq, k, k, nh * ch).to(dtype))
    return out, mask_out


def _launch(tables, shapes, inputs, k: int):
    """Check the arguments and launch the kernel; returns (out, mask)."""
    name = "instance_sample_reduce"
    table, gx = tables[0], inputs[0]
    if gx.dim() != 5:
        raise ValueError(f"{name}: gx must be (B, H, L, P, LQ), got "
                         f"{tuple(gx.shape)}")
    b, nh, nl, npt, lq = gx.shape
    if not 1 <= nl <= MAX_LEVELS or len(tables) != nl or len(shapes) != nl:
        raise ValueError(f"{name}: {len(tables)} tables, {len(shapes)} "
                         f"shapes and {nl} levels (1 to {MAX_LEVELS})")
    if npt != k * k:
        raise ValueError(f"{name}: {npt} taps for k={k}")
    if not 1 <= nh <= MAX_GRID or b > MAX_GRID:
        raise ValueError(f"{name}: {b} images and {nh} heads (each at most "
                         f"{MAX_GRID})")
    if table.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: table dtype {table.dtype}")
    for t, (hl, wl) in zip(tables, shapes):
        rows = b * nh * (hl + 1) * (wl + 1)
        if t.dim() != 2 or tuple(t.shape) != (rows, 4 * CH):
            raise ValueError(f"{name}: a level {hl}x{wl} table must be "
                             f"({rows}, {4 * CH}), got {tuple(t.shape)}")
        if rows >= 2 ** 31:
            raise ValueError(f"{name}: table rows exceed int32 indices")
        if t.dtype != table.dtype:
            raise TypeError(f"{name}: tables of different dtypes")
    for t in inputs:
        if t.dtype != torch.float32 or t.shape != gx.shape:
            raise ValueError(f"{name}: gx, gy, spatial_w, level_w must be f32 "
                             f"{tuple(gx.shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for t in (*tables, *inputs):
        if t.device != table.device:
            raise ValueError(f"{name}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if not table.is_cuda:
        raise ValueError(f"{name}: unsupported device {table.device}")
    # each thread reads 16 bytes of a quad row's corner
    if any(t.data_ptr() % 16 for t in tables):
        raise ValueError(f"{name}: tables must be 16-byte aligned")
    out = torch.empty((b, nh, lq, CH), dtype=table.dtype, device=table.device)
    mask = torch.empty((b, lq, k, k, nh * CH), dtype=table.dtype,
                       device=table.device)
    ptrs = [t.data_ptr() for t in tables] + [None] * (MAX_LEVELS - nl)
    hw = (ctypes.c_int * (2 * nl))(*(int(v) for s in shapes for v in s))
    lib = _build.library()
    with torch.cuda.device(table.device):
        err = lib.instance_sample_reduce(
            table.device.index, int(table.dtype == torch.bfloat16), *ptrs, hw,
            nl, *(t.data_ptr() for t in inputs), out.data_ptr(),
            mask.data_ptr(), b, nh, npt, lq,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, name)
    return out, mask


def instance_sample_reduce(tables, shapes, gx, gy, spatial_w, level_w,
                           k: int):
    """K4. tables: one quad table a level, (B*H*(Hl+1)*(Wl+1), 4*32) bf16 or
    f32 (`_build_quad_tables`), at most 4, 16-byte aligned; shapes: ((Hl,
    Wl), ...); gx, gy, spatial_w, level_w: (B, H, L, P=k*k, LQ) f32,
    contiguous. Returns (out (B, H, LQ, 32), mask (B, LQ, k, k, H*32)) in
    the tables' dtype, summed in f32, with no `grad_fn`."""
    if tables[0].device.type == "cpu":
        return instance_sample_reduce_plain(tables, shapes, gx, gy, spatial_w,
                                            level_w, k)
    out = _launch(tables, tuple(map(tuple, shapes)),
                  (gx, gy, spatial_w, level_w), k)
    instance_sample_reduce.launches += 1
    return out


instance_sample_reduce.launches = 0
