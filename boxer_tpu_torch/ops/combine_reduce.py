"""Fused quad-table gather + bilinear combine + P-tap reduce (K1, K2, K8).

PyTorch port of `boxer_tpu/ops/pallas/combine_reduce.py` with the
`jnp.take` that feeds it fused in:

    out[m, :] = sum_p sum_c w[p, c, m] * table[idx[p, m], c*ch:(c+1)*ch]

Three wrappers over one CUDA source (`boxer_tpu_torch/csrc/
quad_sample_reduce.cu`), one per weight mode or tap order and per TPU kernel
replaced:

- `quad_sample_reduce_raw` (K1, `fused_combine_reduce_raw`): raw bilinear
  fractions and tap weight, corners formed in the kernel (P <= 8 callers);
  the direct kernel that K2 runs up to 8 taps, in its raw mode;
- `quad_sample_reduce_w4` (K2, `fused_combine_reduce`): precomputed corner
  weights (P > 8 callers, and the training forward);
- `quad_sample_reduce_mmajor` (K8, `fused_combine_reduce_mmajor`): raw
  weights with the P taps of an output contiguous, idx and weights (M, P)
  (every P, under the m-major combine); K1's direct kernel up to 8 taps and
  K2's staged kernel above, both in the m-major order.

Each launches the kernel on a CUDA tensor and runs its plain version
(`quad_sample_reduce_plain`, `quad_sample_reduce_mmajor_plain`) on a CPU
tensor; there is no other fallback.
"""

import torch

from boxer_tpu_torch.ops import _build

# channels per head, the only head width any shipped config uses; a quad
# row is 4*CH wide in every mode
CH = 32


def corner_weights(lx, ly, wt):
    """(P, ...) bilinear fractions and tap weight -> (P, 4, ...) corner
    weights in the quad-row order [(y,x), (y,x+1), (y+1,x), (y+1,x+1)]."""
    return torch.stack([(1.0 - lx) * (1.0 - ly) * wt,
                        lx * (1.0 - ly) * wt,
                        (1.0 - lx) * ly * wt,
                        lx * ly * wt], dim=1)


def _gather_rows(table, idx):
    """`table[idx]` as f32, (idx.numel(), 4*ch); raises on an index outside
    the table."""
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= table.shape[0]):
        raise IndexError("quad_sample_reduce: index outside the table")
    return table[idx.reshape(-1).long()].float()


def quad_sample_reduce_plain(table, idx, w4=None, lx=None, ly=None, wt=None):
    """Plain version of K1 and K2: `table[idx]`, then the corner combine
    and the P-sum, all in f32. Returns (M, ch) f32."""
    p, m = idx.shape
    if w4 is None:
        w4 = corner_weights(lx, ly, wt)
    g = _gather_rows(table, idx).reshape(p, m, 4, -1)
    return (g * w4.float().transpose(1, 2)[..., None]).sum(dim=(0, 2))


def quad_sample_reduce_mmajor_plain(table, idx, lx, ly, wt):
    """Plain version of K8: idx, lx, ly, wt (M, P), the taps of output m in
    row m. Returns (M, ch) f32."""
    m, p = idx.shape
    g = _gather_rows(table, idx).reshape(m, p, 4, -1)
    w4 = corner_weights(lx, ly, wt)                            # (M, 4, P)
    return (g * w4.transpose(1, 2)[..., None]).sum(dim=(1, 2))


def _launch(name, table, idx, weights, raw: bool, mmajor: bool = False):
    """Check the arguments and launch the kernel; returns (M, 32) f32."""
    if not table.is_cuda:
        raise ValueError(f"{name}: unsupported device {table.device}")
    if idx.dim() != 2:
        raise ValueError(f"{name}: idx must be 2-D, got {tuple(idx.shape)}")
    m, p = idx.shape if mmajor else idx.shape[::-1]
    if table.dim() != 2 or table.shape[1] != 4 * CH:
        raise ValueError(f"{name}: table must be (R, {4 * CH}), "
                         f"got {tuple(table.shape)}")
    if table.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: table dtype {table.dtype}")
    if table.shape[0] >= 2 ** 31:
        raise ValueError(f"{name}: table rows exceed int32 indices")
    if idx.dtype != torch.int32:
        raise TypeError(f"{name}: idx must be int32")
    want = (tuple(idx.shape),) * 3 if raw else ((p, 4, m),)
    for t, shp in zip(weights, want):
        if t.dtype != torch.float32 or tuple(t.shape) != shp:
            raise ValueError(f"{name}: weights must be f32 {shp}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    for t in (table, idx, *weights):
        if t.device != table.device:
            raise ValueError(f"{name}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if table.data_ptr() % 16:
        # every kernel reads the table's rows in 16-byte vectors
        raise ValueError(f"{name}: table must be 16-byte aligned")
    out = torch.empty((m, CH), dtype=torch.float32, device=table.device)
    a, b, c = weights if raw else weights * 3
    lib = _build.library()
    with torch.cuda.device(table.device):
        err = lib.quad_sample_reduce(
            table.device.index, table.data_ptr(),
            int(table.dtype == torch.bfloat16),
            table.shape[0], idx.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), int(raw), int(mmajor), out.data_ptr(), p, m,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, name)
    return out


def quad_sample_reduce_raw(table, idx, lx, ly, wt):
    """K1. table: (R, 4*32) bf16 or f32 quad-table rows; idx: (P, M) int32
    rows, already clamped by the caller; lx, ly, wt: (P, M) f32 bilinear
    fractions and tap weight. Returns (M, 32) f32."""
    if table.device.type == "cpu":
        return quad_sample_reduce_plain(table, idx, lx=lx, ly=ly, wt=wt)
    out = _launch("quad_sample_reduce_raw", table, idx, (lx, ly, wt), raw=True)
    quad_sample_reduce_raw.launches += 1
    return out


def quad_sample_reduce_w4(table, idx, w4):
    """K2. As `quad_sample_reduce_raw` with precomputed corner weights
    w4: (P, 4, M) f32."""
    if table.device.type == "cpu":
        return quad_sample_reduce_plain(table, idx, w4=w4)
    out = _launch("quad_sample_reduce_w4", table, idx, (w4,), raw=False)
    quad_sample_reduce_w4.launches += 1
    return out


def quad_sample_reduce_mmajor(table, idx, lx, ly, wt):
    """K8. As `quad_sample_reduce_raw` with the taps in (m, p) order: idx
    (M, P) int32 rows and lx, ly, wt (M, P) f32. Returns (M, 32) f32."""
    if table.device.type == "cpu":
        return quad_sample_reduce_mmajor_plain(table, idx, lx, ly, wt)
    out = _launch("quad_sample_reduce_mmajor", table, idx, (lx, ly, wt),
                  raw=True, mmajor=True)
    quad_sample_reduce_mmajor.launches += 1
    return out


quad_sample_reduce_raw.launches = 0
quad_sample_reduce_w4.launches = 0
quad_sample_reduce_mmajor.launches = 0
