"""Weighted quad-row cotangent scatter (K5 + K6), the backward of sampling.

PyTorch port of `boxer_tpu/ops/pallas/scatter_accum.py`'s weighted kernels:

    d_table[idx[p, m], c*ch:(c+1)*ch] += w4[p, c, m] * g[grow(p, m)]

accumulated in f32 into a zeroed (rows, 4*ch) table. Two wrappers over one
CUDA kernel (`boxer_tpu_torch/csrc/scatter_accum.cu`), one per TPU kernel
replaced:

- `scatter_add_rows_weighted` (K5): g (M, ch) shared by the P taps of each
  output row, grow = m (the box-attention backward, g = d_out);
- `scatter_add_rows_pmajor_weighted` (K6): g (P*M, ch), one row per tap,
  grow = p*M + m (the instance-attention backward).

Indices are global rows of the flat per-level table. Each wrapper launches
the kernel on a CUDA tensor and runs `scatter_accum_plain` on a CPU tensor;
there is no other fallback. The kernel's float atomics add in no fixed
order, so its result matches the plain version within f32 rounding, not bit
for bit.
"""

import torch

from boxer_tpu_torch.ops import _build

CH = 32     # the only head width any shipped config uses


def _g_rows(g, p: int, m: int, per_tap: bool):
    """g as (P, M, ch) or (1, M, ch), a view."""
    return g.reshape(p, m, -1) if per_tap else g.reshape(1, m, -1)


def scatter_accum_plain(idx, g, w4, rows: int, per_tap: bool):
    """Plain version of both modes: the (P*M, 4*ch) quad-row cotangent,
    then `index_add_` into a zeroed f32 (rows, 4*ch) table."""
    p, m = idx.shape
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= rows):
        raise IndexError("scatter_accum: index outside the table")
    gp = _g_rows(g.float(), p, m, per_tap)                    # (·, M, ch)
    payload = w4.float().transpose(1, 2)[..., None] * gp[:, :, None, :]
    ch = gp.shape[-1]
    out = torch.zeros((rows, 4 * ch), dtype=torch.float32, device=idx.device)
    return out.index_add_(0, idx.reshape(-1).long(),
                          payload.reshape(p * m, 4 * ch))


def _launch(name, idx, g, w4, rows: int, per_tap: bool):
    """Check the arguments and launch the kernel; returns (rows, 128) f32."""
    if not idx.is_cuda:
        raise ValueError(f"{name}: unsupported device {idx.device}")
    if idx.dim() != 2 or idx.dtype != torch.int32:
        raise TypeError(f"{name}: idx must be (P, M) int32")
    p, m = idx.shape
    if not 0 < rows < 2 ** 31:
        raise ValueError(f"{name}: {rows} table rows do not fit int32 indices")
    g_rows = p * m if per_tap else m
    if tuple(g.shape) != (g_rows, CH) or g.dtype not in (torch.bfloat16,
                                                         torch.float32):
        raise ValueError(f"{name}: g must be ({g_rows}, {CH}) bf16 or f32, "
                         f"got {g.dtype} {tuple(g.shape)}")
    if tuple(w4.shape) != (p, 4, m) or w4.dtype != torch.float32:
        raise ValueError(f"{name}: w4 must be f32 {(p, 4, m)}, "
                         f"got {w4.dtype} {tuple(w4.shape)}")
    for t in (idx, g, w4):
        if t.device != idx.device:
            raise ValueError(f"{name}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    out = torch.zeros((rows, 4 * CH), dtype=torch.float32, device=idx.device)
    lib = _build.library()
    with torch.cuda.device(idx.device):
        err = lib.scatter_accum(
            idx.device.index, idx.data_ptr(), g.data_ptr(),
            int(g.dtype == torch.bfloat16), int(per_tap), w4.data_ptr(),
            out.data_ptr(), rows, p, m,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, name)
    return out


def scatter_add_rows_weighted(idx, g, w4, rows: int):
    """K5. idx: (P, M) int32 global rows of a (rows, 4*32) table; g: (M, 32)
    bf16 or f32, shared by the P taps of output row m; w4: (P, 4, M) f32
    corner weights. Returns the (rows, 4*32) f32 table cotangent."""
    if idx.device.type == "cpu":
        return scatter_accum_plain(idx, g, w4, rows, per_tap=False)
    out = _launch("scatter_add_rows_weighted", idx, g, w4, rows,
                  per_tap=False)
    scatter_add_rows_weighted.launches += 1
    return out


def scatter_add_rows_pmajor_weighted(idx, g, w4, rows: int):
    """K6. As `scatter_add_rows_weighted` with g: (P*M, 32), one row per
    tap in p-major order."""
    if idx.device.type == "cpu":
        return scatter_accum_plain(idx, g, w4, rows, per_tap=True)
    out = _launch("scatter_add_rows_pmajor_weighted", idx, g, w4, rows,
                  per_tap=True)
    scatter_add_rows_pmajor_weighted.launches += 1
    return out


scatter_add_rows_weighted.launches = 0
scatter_add_rows_pmajor_weighted.launches = 0
