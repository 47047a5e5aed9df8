"""Quad-row cotangent scatters (K5, K6, K7a, K7b), the backward of sampling.

PyTorch port of `boxer_tpu/ops/pallas/scatter_accum.py`. The weighted
kernels expand a 32-channel cotangent into the quad row:

    d_table[idx[p, m], c*ch:(c+1)*ch] += w4[p, c, m] * g[grow(p, m)]

and the row kernels add a whole 128-wide payload row per tap:

    d_table[idx[t], :] += payload[t, :]

both accumulated in f32 into a zeroed (rows, 128) table. The weighted
kernel also returns the corner weights' cotangent of the same taps,

    d_w4[p, c, m] = <table[idx[p, m], c*ch:(c+1)*ch], g[grow(p, m)]>

from the table the forward sampled. Behind these wrappers, the kernels of
`boxer_tpu_torch/csrc/scatter_accum.cu`: the weighted kernel, which
accumulates into a zeroed table, and the rows mode's four, which group the
taps by row and write each row once:

- `scatter_add_rows_weighted_dw4` (K5 with per_tap=False, K6 with
  per_tap=True): (d_table, d_w4) from one launch, either skipped on
  request; the backward of `QuadSample`. Its launches count on the K5 or
  the K6 wrapper, by mode;
- `scatter_add_rows_weighted` (K5): d_table only, g (M, 32) shared by the P
  taps of each output row, grow = m (the box-attention backward, g =
  d_out);
- `scatter_add_rows_pmajor_weighted` (K6): d_table only, g (P*M, 32), one
  row per tap, grow = p*M + m (the instance-attention backward);
- `scatter_add_rows` (K7a): idx (N,), payload (N, 128) (an op contract with
  no caller in the package);
- `scatter_add_rows_pmajor` (K7b): idx (P, M), payload (P*M, 128) in the
  same p-major order (the backward of `TakeRows`, the folded path).

Indices are global rows of the flat per-level table. Each wrapper launches
its kernel on a CUDA tensor and runs its plain version
(`scatter_accum_dw4_plain`, `scatter_accum_plain`, `scatter_rows_plain`) on
a CPU tensor; there is no other fallback. The weighted kernel's float
atomics add in no fixed order; the rows kernels group the taps by row and
sum each row once, in an order the grouping's integer atomics set. So both
match the plain version within f32 rounding, not bit for bit.
"""

import torch

from boxer_tpu_torch.ops import _build

# channels per head, the only head width any shipped config uses; a quad
# row is 4*CH wide in every mode
CH = 32


def _g_rows(g, p: int, m: int, per_tap: bool):
    """g as (P, M, ch) or (1, M, ch), a view."""
    return g.reshape(p, m, -1) if per_tap else g.reshape(1, m, -1)


def scatter_rows_plain(idx, payload, rows: int):
    """Plain version of K7a and K7b: `index_add_` of the payload rows, in
    f32, into a zeroed f32 (rows, width) table. idx: any shape with N
    entries; payload: (N, width)."""
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= rows):
        raise IndexError("scatter_accum: index outside the table")
    out = torch.zeros((rows, payload.shape[-1]), dtype=torch.float32,
                      device=idx.device)
    return out.index_add_(0, idx.reshape(-1).long(), payload.float())


def scatter_accum_plain(idx, g, w4, rows: int, per_tap: bool):
    """Plain version of K5 and K6: the (P*M, 4*ch) quad-row cotangent,
    then `scatter_rows_plain`."""
    p, m = idx.shape
    gp = _g_rows(g.float(), p, m, per_tap)                    # (·, M, ch)
    payload = w4.float().transpose(1, 2)[..., None] * gp[:, :, None, :]
    return scatter_rows_plain(idx, payload.reshape(p * m, -1), rows)


def scatter_accum_dw4_plain(idx, g, w4, table, per_tap: bool,
                            want_table: bool = True, want_dw4: bool = True):
    """Plain version of `scatter_add_rows_weighted_dw4`: d_table by
    `scatter_accum_plain` and d_w4 from every tap's gathered quad row,
    (P, 4, M) f32."""
    p, m = idx.shape
    d_table = (scatter_accum_plain(idx, g, w4, table.shape[0], per_tap)
               if want_table else None)
    d_w4 = None
    if want_dw4:
        vals = table[idx.reshape(-1).long()].float().reshape(p, m, 4, -1)
        g_row = _g_rows(g.float(), p, m, per_tap)[:, :, None, :]
        d_w4 = (vals * g_row).sum(-1).transpose(1, 2)
    return d_table, d_w4


def _check(name, idx, idx_dim: int, rows: int, tensors):
    """The checks every kernel shares."""
    if not idx.is_cuda:
        raise ValueError(f"{name}: unsupported device {idx.device}")
    if idx.dim() != idx_dim or idx.dtype != torch.int32:
        raise TypeError(f"{name}: idx must be {idx_dim}-D int32, got "
                        f"{idx.dtype} {tuple(idx.shape)}")
    if not 0 < rows < 2 ** 31 or idx.numel() >= 2 ** 31:
        raise ValueError(f"{name}: {rows} table rows or {idx.numel()} taps "
                         "do not fit int32")
    for t in (idx, *tensors):
        if t.device != idx.device:
            raise ValueError(f"{name}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _launch(name, idx, g, w4, rows: int, per_tap: bool, table=None,
            want_table: bool = True):
    """Check the arguments and launch the weighted kernel: d_table unless
    want_table is False, d_w4 when the sampled table is given. Returns
    (d_table (rows, 128) f32 or None, d_w4 (P, 4, M) f32 or None)."""
    tensors = (g, w4) if table is None else (g, w4, table)
    _check(name, idx, 2, rows, tensors)
    p, m = idx.shape
    g_rows = p * m if per_tap else m
    if tuple(g.shape) != (g_rows, CH) or g.dtype not in (torch.bfloat16,
                                                         torch.float32):
        raise ValueError(f"{name}: g must be ({g_rows}, {CH}) bf16 or f32, "
                         f"got {g.dtype} {tuple(g.shape)}")
    if tuple(w4.shape) != (p, 4, m) or w4.dtype != torch.float32:
        raise ValueError(f"{name}: w4 must be f32 {(p, 4, m)}, "
                         f"got {w4.dtype} {tuple(w4.shape)}")
    if table is not None and (
            tuple(table.shape) != (rows, 4 * CH)
            or table.dtype not in (torch.bfloat16, torch.float32)):
        raise ValueError(f"{name}: table must be ({rows}, {4 * CH}) bf16 or "
                         f"f32, got {table.dtype} {tuple(table.shape)}")
    # the kernel reads g and the table in vectors of 4 values
    if any(t.data_ptr() % 16 for t in (g, table) if t is not None):
        raise ValueError(f"{name}: g and table must be 16-byte aligned")
    d_table = (torch.zeros((rows, 4 * CH), dtype=torch.float32,
                           device=idx.device) if want_table else None)
    d_w4 = (None if table is None else
            torch.empty((p, 4, m), dtype=torch.float32, device=idx.device))
    lib = _build.library()
    with torch.cuda.device(idx.device):
        err = lib.scatter_accum(
            idx.device.index, idx.data_ptr(), g.data_ptr(),
            int(g.dtype == torch.bfloat16), int(per_tap), w4.data_ptr(),
            None if d_table is None else d_table.data_ptr(), rows,
            None if table is None else table.data_ptr(),
            int(table is not None and table.dtype == torch.bfloat16),
            None if d_w4 is None else d_w4.data_ptr(), p, m,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, name)
    return d_table, d_w4


def _launch_rows(name, idx, payload, rows: int, idx_dim: int):
    """Check the arguments and launch the rows mode (count, scan, place,
    reduce over one int32 scratch); returns (rows, 128) f32, every row
    written by the kernel."""
    _check(name, idx, idx_dim, rows, (payload,))
    n = idx.numel()
    if tuple(payload.shape) != (n, 4 * CH) or payload.dtype not in (
            torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: payload must be ({n}, {4 * CH}) bf16 or "
                         f"f32, got {payload.dtype} {tuple(payload.shape)}")
    # the kernel reads payload rows in 16-byte vectors
    if payload.data_ptr() % 16:
        raise ValueError(f"{name}: payload must be 16-byte aligned")
    lib = _build.library()
    scratch = torch.empty(lib.scatter_rows_scratch_words(rows, n),
                          dtype=torch.int32, device=idx.device)
    out = torch.empty((rows, 4 * CH), dtype=torch.float32, device=idx.device)
    with torch.cuda.device(idx.device):
        err = lib.scatter_rows_segmented(
            idx.device.index, idx.data_ptr(), payload.data_ptr(),
            int(payload.dtype == torch.bfloat16), out.data_ptr(), rows, n,
            scratch.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(err, name)
    return out


def scatter_add_rows_weighted_dw4(idx, g, w4, table, per_tap: bool,
                                  want_table: bool = True,
                                  want_dw4: bool = True):
    """K5 (per_tap=False: g (M, 32) shared by the P taps of output row m)
    or K6 (per_tap=True: g (P*M, 32), one row per tap in p-major order)
    with the corner weights' cotangent from the same launch. idx: (P, M)
    int32 global rows of table; w4: (P, 4, M) f32 corner weights; table:
    (rows, 4*32) bf16 or f32, the table the forward sampled. Returns
    (d_table (rows, 4*32) f32, d_w4 (P, 4, M) f32); an output not wanted is
    None and not computed."""
    if not (want_table or want_dw4):
        return None, None
    if idx.device.type == "cpu":
        return scatter_accum_dw4_plain(idx, g, w4, table, per_tap,
                                       want_table, want_dw4)
    counter = (scatter_add_rows_pmajor_weighted if per_tap
               else scatter_add_rows_weighted)
    out = _launch(counter.__name__ + " (with d_w4)", idx, g, w4,
                  table.shape[0], per_tap, table if want_dw4 else None,
                  want_table)
    counter.launches += 1
    return out


def scatter_add_rows_weighted(idx, g, w4, rows: int):
    """K5, d_table only. idx: (P, M) int32 global rows of a (rows, 4*32)
    table; g: (M, 32) bf16 or f32, shared by the P taps of output row m; w4:
    (P, 4, M) f32 corner weights. Returns the (rows, 4*32) f32 table
    cotangent."""
    if idx.device.type == "cpu":
        return scatter_accum_plain(idx, g, w4, rows, per_tap=False)
    out, _ = _launch("scatter_add_rows_weighted", idx, g, w4, rows,
                     per_tap=False)
    scatter_add_rows_weighted.launches += 1
    return out


def scatter_add_rows_pmajor_weighted(idx, g, w4, rows: int):
    """K6, d_table only. As `scatter_add_rows_weighted` with g: (P*M, 32),
    one row per tap in p-major order."""
    if idx.device.type == "cpu":
        return scatter_accum_plain(idx, g, w4, rows, per_tap=True)
    out, _ = _launch("scatter_add_rows_pmajor_weighted", idx, g, w4, rows,
                     per_tap=True)
    scatter_add_rows_pmajor_weighted.launches += 1
    return out


def scatter_add_rows(idx, payload, rows: int):
    """K7a. idx: (N,) int32 global rows of a (rows, 4*32) table; payload:
    (N, 4*32) bf16 or f32. Returns the (rows, 4*32) f32 sum of the payload
    rows at their indices."""
    if idx.device.type == "cpu":
        return scatter_rows_plain(idx, payload, rows)
    out = _launch_rows("scatter_add_rows", idx, payload, rows, idx_dim=1)
    scatter_add_rows.launches += 1
    return out


def scatter_add_rows_pmajor(idx, payload, rows: int):
    """K7b. As `scatter_add_rows` with idx: (P, M) and payload: (P*M, 4*32)
    in the same p-major order."""
    if idx.device.type == "cpu":
        return scatter_rows_plain(idx, payload, rows)
    out = _launch_rows("scatter_add_rows_pmajor", idx, payload, rows,
                       idx_dim=2)
    scatter_add_rows_pmajor.launches += 1
    return out


scatter_add_rows_weighted.launches = 0
scatter_add_rows_pmajor_weighted.launches = 0
scatter_add_rows.launches = 0
scatter_add_rows_pmajor.launches = 0
