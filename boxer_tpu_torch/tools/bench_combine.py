"""The sampling-combine shootout on the card: the port of the JAX package's
`tools/bench_combine.py`, `bench_combine2.py` and `bench_combine3.py`.

Those tools timed Pallas variants of the combine

    out[m, :] = sum_p sum_c w[p, c, m] * g[row(p, m), c*32:(c+1)*32]

over rows gathered beforehand, variants that differ only in VMEM block
shapes:

- T1 `_build_mmajor` (`tools/bench_combine.py:25`): K8's function, rows in
  (m, p) order, corner weights formed from raw lx, ly, wt, f32 or bf16
  output;
- T2 `_build_onepass`, `_build_early` (`tools/bench_combine2.py:39,69`) and
  T3 `_build_onepass_big` (`tools/bench_combine3.py:32`): K2's function,
  rows in (p, m) order, precomputed (P, 4, M) corner weights;
- the gather-fed comparison (`tools/bench_combine3.py:158`): K2's function
  fed by a gather from a real per-head table.

Block shapes mean nothing on the card, so each variant runs through the
port's kernel for its function: T1 through K8 (`quad_sample_reduce_mmajor`),
T2 and T3 through K2 (`quad_sample_reduce_w4`). Rows gathered beforehand
are a table of P*M rows indexed by the identity (m*P + p for T1, p*M + m
for T2/T3); the gather-fed variant indexes a real table with random rows of
each head's slice. Every variant reports the kernel's time (CUDA events,
mean of 20 launches after a warm-up), its plain version's, the library
call's (one `embedding_bag` over the table viewed as (4*rows, 32), in f32
because `per_sample_weights` must have the table's dtype; the f32 copy is
made outside the timed region), the least time the card could take (bytes
at 3.35 TB/s against operations at 67 TFLOP/s f32), the kernel's error
against its plain version, and its launches in the timed run.

Run on a CUDA card:  python -m boxer_tpu_torch.tools.bench_combine
"""

import subprocess
import sys

import torch
import torch.nn.functional as F

from boxer_tpu_torch.ops import combine_reduce as cr

# NVIDIA H100 SXM data sheet: device memory rate and peaks, dense
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}

# (label, TPU kernel replaced, kind, P, M) at the JAX tools' shapes
# (bench_combine.py:116-117, bench_combine2.py:190-195,
# bench_combine3.py:196-198)
VARIANTS = (
    ("T1 f32 out", "tools/bench_combine.py:25", "mmajor", 4, 8 * 20197),
    ("T1 bf16 out", "tools/bench_combine.py:25", "mmajor_bf16", 4, 8 * 20197),
    ("T1 f32 out", "tools/bench_combine.py:25", "mmajor", 196, 8 * 300),
    ("T1 bf16 out", "tools/bench_combine.py:25", "mmajor_bf16", 196, 8 * 300),
    ("T2 onepass/early", "tools/bench_combine2.py:39,69", "pmajor", 4,
     8 * 15200),
    ("T2 onepass/early", "tools/bench_combine2.py:39,69", "pmajor", 4,
     8 * 3800),
    ("T2 onepass/early", "tools/bench_combine2.py:39,69", "pmajor", 4,
     8 * 950),
    ("T2 onepass/early", "tools/bench_combine2.py:39,69", "pmajor", 4,
     8 * 247),
    ("T2 onepass/early", "tools/bench_combine2.py:39,69", "pmajor", 196,
     8 * 300),
    ("T3 onepass_big", "tools/bench_combine3.py:32", "pmajor", 4, 8 * 20197),
    ("gather-fed", "tools/bench_combine3.py:158", "gather", 4, 8 * 20197),
)
# rel err against the plain version: f32 sums in another order, or one
# bf16 rounding of the output
TOL = {"mmajor": 1e-5, "mmajor_bf16": 1e-2, "pmajor": 1e-5, "gather": 1e-5}


def cuda_ms(fn, iters=20):
    """Mean device time of fn() over `iters` launches after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, flops, dtype="f32"):
    """The least time the card could take: (ms, "bytes" or "operations"),
    the larger of bytes over the memory rate and operations over the peak
    rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gather_bytes(table, idx, weights, out_bytes):
    """Bytes a gather-combine must move: each table row it reads once (the
    distinct rows of this index), the index, the weights and the output."""
    rows = torch.unique(idx).numel()
    return (rows * table.shape[1] * table.element_size()
            + idx.numel() * idx.element_size()
            + sum(w.numel() * w.element_size() for w in weights) + out_bytes)


def bag_inputs(idx, w4):
    """idx (M, P) quad rows and w4 (M, 4, P) corner weights -> the (M, 4P)
    indices into the table viewed as (4*rows, 32) and their weights, for
    `embedding_bag(mode="sum")`."""
    m = idx.shape[0]
    corner = torch.arange(4, device=idx.device).view(1, 4, 1)
    return (4 * idx.long()[:, None, :] + corner).reshape(m, -1), \
        w4.reshape(m, -1).float()


def library_call(table, idx4, w):
    """The one PyTorch call computing the combine: `embedding_bag` over an
    f32 copy of the table (made here, outside whatever times the call)."""
    flat = table.float().reshape(-1, table.shape[1] // 4)
    return lambda: F.embedding_bag(idx4, flat, per_sample_weights=w,
                                   mode="sum")


def _flops(idx):
    """4 corners x 32 channels x one multiply-add per tap."""
    return idx.numel() * 4 * cr.CH * 2


def mmajor_case(table, idx, lx, ly, wt, out_bf16=False):
    """K8 over (M, P) taps. Returns the callables and the counts."""
    cast = ((lambda x: x.to(torch.bfloat16)) if out_bf16 else (lambda x: x))
    idx4, w = bag_inputs(idx, cr.corner_weights(lx, ly, wt))
    lib = library_call(table, idx4, w)
    out_bytes = idx.shape[0] * cr.CH * (2 if out_bf16 else 4)
    return dict(
        wrapper=cr.quad_sample_reduce_mmajor,
        kernel=lambda: cast(cr.quad_sample_reduce_mmajor(table, idx, lx, ly,
                                                         wt)),
        plain=lambda: cast(cr.quad_sample_reduce_mmajor_plain(table, idx, lx,
                                                              ly, wt)),
        library=lambda: cast(lib()),
        nbytes=gather_bytes(table, idx, (lx, ly, wt), out_bytes),
        flops=_flops(idx))


def pmajor_case(table, idx, w4):
    """K2 over (P, M) taps with (P, 4, M) corner weights."""
    idx4, w = bag_inputs(idx.t(), w4.permute(2, 1, 0))
    return dict(
        wrapper=cr.quad_sample_reduce_w4,
        kernel=lambda: cr.quad_sample_reduce_w4(table, idx, w4),
        plain=lambda: cr.quad_sample_reduce_plain(table, idx, w4=w4),
        library=library_call(table, idx4, w),
        nbytes=gather_bytes(table, idx, (w4,), idx.shape[1] * cr.CH * 4),
        flops=_flops(idx))


def identity_rows(p, m, mmajor, device):
    """The index of rows gathered beforehand: (M, P) with idx[m, p] =
    m*P + p, or (P, M) with idx[p, m] = p*M + m."""
    rows = torch.arange(p * m, dtype=torch.int32, device=device)
    return rows.reshape(m, p) if mmajor else rows.reshape(p, m)


def make_case(kind, p, m, device, seed=0):
    """A variant's inputs, made on `device` from `seed` (bf16 rows, f32
    weights), and its case. The gather-fed table is encoder level 0 at
    800x1216: 8 heads' quad-table slices of 101 x 153 rows; M = 8 * queries."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=device)

    if kind == "gather":
        heads, stride = 8, 101 * 153
        table = torch.randn(heads * stride, 4 * cr.CH, generator=gen,
                            device=device).to(torch.bfloat16)
        head = torch.arange(heads, device=device).view(1, heads, 1) * stride
        idx = (torch.randint(0, stride, (p, heads, m // heads), generator=gen,
                             device=device) + head).to(torch.int32)
        return pmajor_case(table, idx.reshape(p, m), rand(p, 4, m))
    table = torch.randn(p * m, 4 * cr.CH, generator=gen,
                        device=device).to(torch.bfloat16)
    if kind == "pmajor":
        return pmajor_case(table, identity_rows(p, m, False, device),
                           rand(p, 4, m))
    return mmajor_case(table, identity_rows(p, m, True, device),
                       rand(m, p), rand(m, p), rand(m, p),
                       out_bf16=kind == "mmajor_bf16")


def run_case(case):
    """Check the kernel against its plain version, then time the kernel,
    the plain version and the library call. Returns the numbers."""
    got, want = case["kernel"](), case["plain"]()
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs().max()
    res = dict(max_abs_err=float(diff),
               rel_err=float(diff / want.float().abs().max().clamp(min=1e-6)))
    before = case["wrapper"].launches
    res["ms"] = cuda_ms(case["kernel"])
    res["launches"] = case["wrapper"].launches - before
    res["plain_ms"] = cuda_ms(case["plain"])
    res["library_ms"] = cuda_ms(case["library"])
    res["bound_ms"], res["bound_by"] = bound_ms(case["nbytes"], case["flops"])
    return res


def run(device, log=print):
    """Every variant at the JAX tools' shapes; one line each. Raises if a
    kernel disagrees with its plain version. Returns the results."""
    results = []
    for label, replaces, kind, p, m in VARIANTS:
        res = dict(label=label, replaces=replaces, p=p, m=m,
                   **run_case(make_case(kind, p, m, device)))
        log(f"{label} [{replaces}] P={p} M={m}: kernel {res['ms']:.4f} ms, "
            f"plain {res['plain_ms']:.4f} ms, library {res['library_ms']:.4f}"
            f" ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}), "
            f"rel err {res['rel_err']:.2e} (tol {TOL[kind]:g}), max abs err "
            f"{res['max_abs_err']:.2e}, {res['launches']} launches")
        if not res["rel_err"] <= TOL[kind]:
            raise AssertionError(f"{label} P={p} M={m}: the kernel disagrees "
                                 "with its plain version")
        results.append(res)
        torch.cuda.empty_cache()
    return results


def main():
    if not torch.cuda.is_available():
        sys.exit("bench_combine: no CUDA card; the shootout times kernels")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    run(torch.device("cuda", 0), log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
