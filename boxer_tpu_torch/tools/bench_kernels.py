"""K1, K2, K3, K5/K6, K7a/K7b and K8 (or, with --h1, H1; with --k4, K4;
with --k9, K9; with --k10, K10; with --k11, K11) at their main-path shapes,
this tree's kernels against another tree's, in one process on one card.

    python -m boxer_tpu_torch.tools.bench_kernels [--h1 | --k4] --parent DIR
    python -m boxer_tpu_torch.tools.bench_kernels --k9 | --k10 | --k11

DIR is an unpacked copy of another commit of the repo (`git archive`);
its `boxer_tpu_torch/csrc` is built beside this tree's and loaded as a
second library, and each kernel is called through a thin launcher that does
what the tree's own wrapper does (outputs and scratch allocated as the
wrapper allocates them, then the C entry point), so the host cost of a call
is the same on both sides. The other tree's C entry points must have this
tree's signatures, as every commit since cd09a71 has: `quad_sample_reduce`,
`flash_attention_fwd`, and `scatter_accum` with the table and d_w4
arguments. The row scatter goes through `scatter_rows_segmented` with its
scratch where a tree has it, and otherwise through the older `scatter_rows`
with the zero fill of its output that the wrapper then did.

Each row is timed in turns, other tree, this tree, this tree, other tree,
two ways, and each side's mean is printed: with CUDA events around 20
calls after a warm-up (which, for a kernel of a few microseconds, measures
the host's time to issue a call), and as device time, the summed time of
every kernel (and memset) a call launches under torch.profiler over 20
calls (the output's zeroing included where the wrapper zeroes it). A row
with a library call also times it, both ways. Rows:

- K1 (`quad_sample_reduce_raw`) at P=4, M=161,576 (encoder level 0 of
  every inference forward) and P=4, M=2,400 (the detection decoder);
- K2 (`quad_sample_reduce_w4`) at P=196, M=2,400 (the inference decoder)
  and P=4, M=161,576; P=4, M=2,400; P=1, M=470,400 (`QuadSample`'s
  forward in training);
- K3 (`flash_attention`) at BH=8, L=300, D=32 in bf16 (the decoder's
  self-attention) and in f32 (the card-vs-CPU checks);
- K5 (shared g, P=4, M=161,576 and M=2,400) and K6 (per-tap g, P=196,
  M=2,400): d_table alone, and d_table with d_w4 from the fused kernel;
- K7b (`scatter_add_rows_pmajor`, bf16 payload) at P=4, M=161,576 (the
  folded encoder level 0), P=16, LQ=600 over 2 heads (19,200 taps, 19,602
  rows) and P=196, M=2,400, K7a (flat idx) at the first; library call: a
  zeroed f32 table allocated in the call, then `index_add_` of the payload
  converted to f32 beforehand;
- K7b on the model's own indices: the 4 encoder levels of one full-width
  folded detection train step (captured by `chip_smoke.k7b_model_inputs`);
- K8 (`quad_sample_reduce_mmajor`) at P=4, M=161,576 and P=196, M=2,400,
  to be read beside K1 and K2 at the same shapes.

With --h1 only H1 (`solve_assignment`, the matcher's JV solve) is timed,
on the four matching problems of `chip_smoke.py` phase 3d (the shipped
configs' calls, the costs from the matchers' own `cost_matrix`): this
tree's kernel at its rule's cluster size in turns with the other tree's
(whose entry points may be the one-block design's, `hungarian_solve`
without a cluster size), then this tree's at each cluster size the card
can hold, each held bitwise against the plain version first; CUDA events,
mean of 5, and device time as above.

With --k4 only K4 (`instance_sample_reduce`, the segm decoder's dual-output
instance attention) is timed, at `chip_smoke.py` phase 3's segm shape and
inputs (`chip_smoke.segm_instance_case`: B 1, H 8, LQ 300, k 14, the 4
levels of 800x1216, box-shaped taps) with bf16 and with f32 tables: each
tree's kernel through its C entry point `instance_sample_reduce` (which
every commit since 5f345b5 has with this signature), first held against the
plain version (rel err 1e-2 in bf16, 1e-5 in f32) and this tree's two
launches bitwise against each other, then timed in turns; then variants
of this tree's kernel source, each built with a few changes of its text
into a library of its own, all at once: the other block shapes of
K4_TILES (queries, warps a block) at the source's cluster-size rule, and
the source's block shape at each cluster size of K4_SPLITS, each held
against the plain version first; and two probes (K4_PROBES: every row read
an L1 hit; no row reads), to show what bounds the kernel (their outputs are
not compared); CUDA events, mean of 20, and device time as above, beside
`chip_smoke.k4_bound`.

With --k9 only K9 (`box_sample_reduce`, box attention's one-launch
inference sampling) is timed, at the segm cell's two calls (`K9_CALLS`:
batch 16 of 800x1216 in bf16, the encoder's P 4 over its 20,197 tokens and
the decoder's P 196 over 300 queries, the taps laid out as the model's,
`k9_case`): held against its plain version (rel err 1e-2) and two launches
bitwise, then its time (CUDA events and device time), the plain version's,
that of the route it replaced (quad tables, taps, K1 or K2 a level and the
f32 sums, `quad_table_route`) and its bound. The other tree has no K9, so
--parent is not read.

With --k10 only K10 (`pillar_features`, the pillar net's one-launch
inference forward) is timed, at the pp3d.infer_b4 cell's shape (`k10_case`:
4 frames of 60,000 pillars of 20 points, filters 64 and 128, bf16
weights): held against its plain version (a pillar's relative error 1e-2)
and two launches bitwise, then its time (CUDA events and device time), the
plain version's, the memory each takes above its inputs, and its bound
(`k10_bound`). --parent is not read.

With --k11 only K11 (`group_norm_relu`, the BEV neck's GroupNorm + ReLU at
inference) is timed, at the pp3d.infer_b4 cell's eight calls (`K11_CALLS`:
batch 4, 2 of 256 x 469 x 469, 4 of 512 x 235 x 235, 2 of 1024 x 118 x
118, NHWC bf16, `k11_case`): at each shape held against its plain version
(rel err 1e-2) and two launches bitwise, then its time (CUDA events and
device time), the plain version's, torch's `GroupNorm` + `ReLU` on the
NCHW tensor (a yardstick the port never calls) and its bound (`k11_bound`);
then the eight calls' sums. --parent is not read.

Inputs are made on the card from a seed: a bf16 quad table of encoder
level 0 at 800x1216 (8 heads x 101 x 153 rows), random rows, f32 weights
and cotangents, q, k, v from a normal distribution. Every kernel output is
held against its plain version (rel err 1e-5; 1e-2 for K3 in bf16) before
it is timed. Without --parent only this tree's kernels are timed.
"""

import argparse
import ctypes
import functools
import importlib
import math
import re
import subprocess
import sys
from pathlib import Path

import torch

from boxer_tpu_torch.ops import _build
from boxer_tpu_torch.ops import combine_reduce as cr
from boxer_tpu_torch.ops import flash_attention as fa
from boxer_tpu_torch.ops import scatter_accum as sa
from boxer_tpu_torch.tools.bench_combine import bound_ms, cuda_ms, gather_bytes
from boxer_tpu_torch.utils.timer import device_events

ROWS = 8 * 101 * 153
# (P, M) on the main path
K1_SHAPES = ((4, 8 * 20197), (4, 8 * 300))
K2_SHAPES = ((196, 8 * 300), (4, 8 * 20197), (4, 8 * 300), (1, 8 * 58800))
# (P, M, g per tap)
K56_SHAPES = ((4, 8 * 20197, False), (4, 8 * 300, False), (196, 8 * 300, True))
# (BH, L, D) of the decoder's self-attention
K3_SHAPE = (8, 300, 32)
# (P, M, table rows) of the row scatter, K7b; K7a at the first
K7_SHAPES = ((4, 8 * 20197, ROWS), (16, 2 * 600, 2 * 81 * 121),
             (196, 8 * 300, ROWS))
# (P, M) of the m-major combine
K8_SHAPES = ((4, 8 * 20197), (196, 8 * 300))
# K4's sweep: block shapes (queries, warps) other than the source's 8 x 4,
# at its cluster-size rule (32 x 4 is left out: f32 tables cannot take it),
# and cluster sizes at 8 x 4
K4_TILES = ((8, 8), (16, 4), (16, 8), (32, 8))
K4_SPLITS = (1, 2, 3, 4, 6, 8)
TOL = 1e-5


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def distinct_row_bytes(table, idx):
    return torch.unique(idx).numel() * table.shape[1] * table.element_size()


def k1_bound(table, idx, lx, ly, wt):
    """Bytes: the distinct table rows, idx, lx, ly, wt and the (M, 32) f32
    output; operations: one multiply-add per tap, corner and channel."""
    return bound_ms(gather_bytes(table, idx, (lx, ly, wt),
                                 idx.shape[1] * cr.CH * 4), idx.numel() * 256)


def k2_bound(table, idx, w4):
    """As `k1_bound`, with w4 in place of lx, ly, wt."""
    return bound_ms(distinct_row_bytes(table, idx) + nbytes(idx, w4)
                    + idx.shape[1] * cr.CH * 4, idx.numel() * 256)


def k3_bound(q):
    """Bytes: q, k, v read and the output written, all q's shape and dtype;
    operations: q k^T and p v, 2 x 2 x BH x L x L x D in q's type."""
    bh, seq, d = q.shape
    return bound_ms(4 * nbytes(q), 4 * bh * seq * seq * d,
                    "bf16" if q.dtype == torch.bfloat16 else "f32")


def k56_bound(table, idx, g, w4, with_dw4):
    """Bytes: idx, g, w4, the (rows, 128) f32 d_table written, and with d_w4
    the distinct table rows read and d_w4 written; operations: the
    multiplies of the corner expansion (and the d_w4 dot products)."""
    n = nbytes(idx, g, w4) + table.shape[0] * 4 * cr.CH * 4
    if with_dw4:
        n += distinct_row_bytes(table, idx) + nbytes(w4)
    return bound_ms(n, idx.numel() * (256 if with_dw4 else 128))


def k7_bound(idx, payload, rows):
    """Bytes: idx and the payload read, the (rows, 128) f32 table written;
    operations: one add a tap and channel."""
    return bound_ms(nbytes(idx, payload) + rows * 4 * cr.CH * 4,
                    idx.numel() * 4 * cr.CH)


def load(csrc):
    """Build `csrc` and load it as a library of its own; the caller sets the
    entry points' argtypes."""
    return ctypes.CDLL(str(_build.build(Path(csrc))))


def _stream():
    return torch.cuda.current_stream().cuda_stream


def k12_launcher(lib, mmajor=False):
    """K1 (raw=True: weights lx, ly, wt) or K2 (w4) through the C entry
    point; with mmajor, K8 (idx and lx, ly, wt (M, P))."""
    def run(table, idx, *weights):
        m, p = idx.shape if mmajor else idx.shape[::-1]
        raw = len(weights) == 3
        a, b, c = weights if raw else weights * 3
        out = torch.empty((m, cr.CH), dtype=torch.float32, device=idx.device)
        _build.check(lib.quad_sample_reduce(
            idx.device.index, table.data_ptr(),
            int(table.dtype == torch.bfloat16), table.shape[0],
            idx.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            int(raw), int(mmajor), out.data_ptr(), p, m, _stream()),
            "quad_sample_reduce")
        return out
    return run


def k3_launcher(lib):
    def run(q, k, v):
        bh, lq, d = q.shape
        out = torch.empty_like(q)
        _build.check(lib.flash_attention_fwd(
            q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
            out.data_ptr(), int(q.dtype == torch.bfloat16), bh, lq,
            k.shape[1], d, 1.0 / d ** 0.5, _stream()), "flash_attention")
        return out
    return run


def scatter_launcher(lib):
    """d_table, and d_w4 when `table` is given, through the C entry
    point."""
    def run(idx, g, w4, rows, per_tap, table=None):
        p, m = idx.shape
        dev = idx.device
        d_table = torch.zeros((rows, 4 * cr.CH), dtype=torch.float32,
                              device=dev)
        d_w4 = (None if table is None else
                torch.empty((p, 4, m), dtype=torch.float32, device=dev))
        _build.check(lib.scatter_accum(
            dev.index, idx.data_ptr(), g.data_ptr(),
            int(g.dtype == torch.bfloat16), int(per_tap), w4.data_ptr(),
            d_table.data_ptr(), rows,
            None if table is None else table.data_ptr(),
            int(table is not None and table.dtype == torch.bfloat16),
            None if d_w4 is None else d_w4.data_ptr(), p, m, _stream()),
            "scatter_accum")
        return d_table if table is None else (d_table, d_w4)
    return run


def rows_launcher(lib):
    """K7a/K7b as the tree's wrapper runs them: `scatter_rows_segmented`
    over its scratch, or the older `scatter_rows` into a zeroed table."""
    segmented = hasattr(lib, "scatter_rows_segmented")

    def run(idx, payload, rows):
        dev, n = idx.device, idx.numel()
        bf16 = int(payload.dtype == torch.bfloat16)
        if segmented:
            scratch = torch.empty(lib.scatter_rows_scratch_words(rows, n),
                                  dtype=torch.int32, device=dev)
            out = torch.empty((rows, 4 * cr.CH), dtype=torch.float32,
                              device=dev)
            err = lib.scatter_rows_segmented(
                dev.index, idx.data_ptr(), payload.data_ptr(), bf16,
                out.data_ptr(), rows, n, scratch.data_ptr(), _stream())
        else:
            out = torch.zeros((rows, 4 * cr.CH), dtype=torch.float32,
                              device=dev)
            err = lib.scatter_rows(dev.index, idx.data_ptr(),
                                   payload.data_ptr(), bf16, out.data_ptr(),
                                   rows, n, _stream())
        _build.check(err, "scatter_rows")
        return out
    return run


def index_add_call(idx, payload, rows):
    """The library call of K7a/K7b: a zeroed f32 table allocated in the
    call, then `index_add_` of the payload (converted to f32 here, outside
    the call)."""
    ix, pay = idx.reshape(-1).long(), payload.float()
    return lambda: torch.zeros((rows, pay.shape[1]), dtype=torch.float32,
                               device=pay.device).index_add_(0, ix, pay)


def taps_per_row(idx, rows):
    """(mean over the rows hit, max) taps a row."""
    counts = torch.bincount(idx.reshape(-1).long(), minlength=rows)
    return float(counts[counts > 0].float().mean()), int(counts.max())


def rel_err(got, want):
    if isinstance(want, tuple):
        return max(rel_err(a, b) for a, b in zip(got, want))
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-6))


def device_ms(fn, iters=20):
    """The device's summed kernel time per call of fn(), over `iters` calls
    under torch.profiler after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in device_events(prof)) \
        / 1e3 / iters


def device_split(fn, iters=20):
    """{kernel name: device ms per call of fn()} under torch.profiler, for a
    call that launches several kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / iters
            for e in device_events(prof)}


def short_name(kernel):
    """A profiler kernel name without its namespace, templates and
    arguments."""
    found = re.search(r"(rows_\w+|scatter_\w+|Memset|\w*elementwise\w*)",
                      kernel)
    return found.group(1) if found else kernel[:40]


def in_turns(other, this, timer):
    """Times `other` and `this` with `timer` as other, this, this, other;
    returns (other ms, this ms), each the mean of its two runs (other None:
    this alone)."""
    if other is None:
        return None, timer(this)
    a = timer(other)
    b = timer(this) + timer(this)
    return (a + timer(other)) / 2, b / 2


def run(device, parent=None, log=print, model_inputs=None):
    """Every row; raises if a kernel disagrees with its plain version.
    model_inputs: [(idx, payload, rows)] of K7b on the model's indices, or
    None. Returns a list of dicts (ms of both sides, bound)."""
    gen = torch.Generator(device=device).manual_seed(0)
    table = torch.randn(ROWS, 4 * cr.CH, generator=gen, device=device).to(
        torch.bfloat16)
    libs = {"this": _build.library()}
    if parent is not None:
        plib = load(Path(parent) / "boxer_tpu_torch" / "csrc")
        for fn in ("quad_sample_reduce", "flash_attention_fwd",
                   "scatter_accum", "scatter_rows_segmented",
                   "scatter_rows_scratch_words"):
            if hasattr(plib, fn):
                getattr(plib, fn).argtypes = getattr(libs["this"], fn).argtypes
                getattr(plib, fn).restype = getattr(libs["this"], fn).restype
        if not hasattr(plib, "scatter_rows_segmented"):
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            plib.scatter_rows.argtypes = [i32, vp, vp, i32, vp,
                                          ctypes.c_longlong, i32, vp]
            plib.scatter_rows.restype = i32
        libs["other"] = plib
    k12 = {k: k12_launcher(v) for k, v in libs.items()}
    k8 = {k: k12_launcher(v, mmajor=True) for k, v in libs.items()}
    k7 = {k: rows_launcher(v) for k, v in libs.items()}
    k3 = {k: k3_launcher(v) for k, v in libs.items()}
    scatter = {k: scatter_launcher(v) for k, v in libs.items()}
    results = []

    def row(name, shape, launcher, args, plain, bound, tol=TOL,
            library=None, split=False):
        mine = functools.partial(launcher["this"], *args)
        other = (functools.partial(launcher["other"], *args)
                 if "other" in launcher else None)
        want = plain()
        errs = {"this": rel_err(mine(), want)}
        if other is not None:
            errs["other"] = rel_err(other(), want)
        torch.cuda.synchronize()
        o_ms, t_ms = in_turns(other, mine, cuda_ms)
        o_dev, t_dev = in_turns(other, mine, device_ms)
        b_ms, b_by = bound
        l_ms, l_dev = ((None, None) if library is None else
                       (cuda_ms(library), device_ms(library)))
        res = dict(name=name, shape=shape, this_ms=t_ms, other_ms=o_ms,
                   this_device_ms=t_dev, other_device_ms=o_dev,
                   library_ms=l_ms, library_device_ms=l_dev,
                   bound_ms=b_ms, bound_by=b_by, rel_err=errs)
        results.append(res)
        other_s = ("" if o_ms is None else
                   f"other tree {o_ms:.4f} ms (device {o_dev:.4f}), ")
        lib_s = ("" if l_ms is None else
                 f"library {l_ms:.4f} ms (device {l_dev:.4f}), ")
        log(f"{name} [{shape}]: {other_s}this tree {t_ms:.4f} ms (device "
            f"{t_dev:.4f}), {lib_s}bound {b_ms:.4f} ms ({b_by}), rel err "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        if split:
            for side, fn in (("other", other), ("this", mine)):
                if fn is not None:
                    log(f"  {side} tree by kernel: " + ", ".join(
                        f"{short_name(k)} {v:.4f}"
                        for k, v in device_split(fn).items()))
        if max(errs.values()) > tol:
            raise AssertionError(f"{name} [{shape}] disagrees with its plain "
                                 "version")

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=device)

    def rows_idx(p, m):
        return torch.randint(0, ROWS, (p, m), generator=gen, device=device,
                             dtype=torch.int32)

    for p, m in K1_SHAPES:
        idx, lx, ly, wt = rows_idx(p, m), rand(p, m), rand(p, m), rand(p, m)
        row("K1", f"P={p} M={m}", k12, (table, idx, lx, ly, wt),
            lambda: cr.quad_sample_reduce_plain(table, idx, lx=lx, ly=ly,
                                                wt=wt),
            k1_bound(table, idx, lx, ly, wt))
        torch.cuda.empty_cache()
    for p, m in K2_SHAPES:
        idx, w4 = rows_idx(p, m), rand(p, 4, m)
        row("K2", f"P={p} M={m}", k12, (table, idx, w4),
            lambda: cr.quad_sample_reduce_plain(table, idx, w4=w4),
            k2_bound(table, idx, w4))
        torch.cuda.empty_cache()
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, TOL)):
        qkv = [torch.randn(*K3_SHAPE, generator=gen, device=device).to(dtype)
               for _ in range(3)]
        row("K3", "BH={} L={} D={} ".format(*K3_SHAPE) + str(dtype)[6:],
            k3, qkv, lambda: fa.flash_attention_plain(*qkv),
            k3_bound(qkv[0]), tol)
    for p, m, per_tap in K56_SHAPES:
        idx, w4 = rows_idx(p, m), rand(p, 4, m)
        g = torch.randn(p * m if per_tap else m, cr.CH, generator=gen,
                        device=device)
        name = "K6" if per_tap else "K5"
        shape = f"P={p} M={m} {'per-tap' if per_tap else 'shared'} g"
        row(name + " d_table", shape, scatter, (idx, g, w4, ROWS, per_tap),
            lambda: sa.scatter_accum_plain(idx, g, w4, ROWS, per_tap),
            k56_bound(table, idx, g, w4, with_dw4=False))
        row(name + " d_table + d_w4", shape, scatter,
            (idx, g, w4, ROWS, per_tap, table),
            lambda: sa.scatter_accum_dw4_plain(idx, g, w4, table, per_tap),
            k56_bound(table, idx, g, w4, with_dw4=True))
        torch.cuda.empty_cache()
    for i, (p, m, rows) in enumerate(K7_SHAPES):
        idx = torch.randint(0, rows, (p, m), generator=gen, device=device,
                            dtype=torch.int32)
        pay = torch.randn(p * m, 4 * cr.CH, generator=gen,
                          device=device).to(torch.bfloat16)
        for name, ix in (("K7b", idx), ("K7a", idx.reshape(-1)))[:2 - min(i, 1)]:
            row(name, f"P={p} M={m} rows {rows} bf16 payload", k7,
                (ix, pay, rows),
                lambda: sa.scatter_rows_plain(ix, pay, rows),
                k7_bound(ix, pay, rows), library=index_add_call(ix, pay, rows),
                split=True)
        del idx, pay
        torch.cuda.empty_cache()
    if model_inputs is not None:
        for level, (idx, pay, rows) in enumerate(model_inputs):
            mean, most = taps_per_row(idx, rows)
            row("K7b model", f"encoder level {level}, P={idx.shape[0]} "
                f"M={idx.shape[1]} rows {rows}, {mean:.1f} taps a row hit, "
                f"at most {most}", k7, (idx, pay, rows),
                lambda: sa.scatter_rows_plain(idx, pay, rows),
                k7_bound(idx, pay, rows), library=index_add_call(idx, pay, rows),
                split=True)
    for p, m in K8_SHAPES:
        idx = torch.randint(0, ROWS, (m, p), generator=gen, device=device,
                            dtype=torch.int32)
        lx, ly, wt = rand(m, p), rand(m, p), rand(m, p)
        row("K8", f"P={p} M={m}", k8, (table, idx, lx, ly, wt),
            lambda: cr.quad_sample_reduce_mmajor_plain(table, idx, lx, ly, wt),
            k1_bound(table, idx, lx, ly, wt))
        torch.cuda.empty_cache()
    return results


# the parts of csrc/hungarian.cu's probe, in its order (then the steps and
# the whole kernel's cycles)
H1_PROBES = ("sweep", "block argmin + push", "cluster wait",
             "decision + dual update", "walk")


def h1_launcher(lib, clusters=None):
    """H1 through the C entry point as the tree's wrapper calls it: with a
    cluster size where the tree's `hungarian_solve` takes one (its library
    has `hungarian_max_active_clusters`), else the one-block design's."""
    from boxer_tpu_torch.ops.hungarian import cluster_size

    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    clustered = hasattr(lib, "hungarian_max_active_clusters")
    lib.hungarian_scratch_bytes.restype = i64
    lib.hungarian_solve.restype = i32
    if clustered:
        lib.hungarian_scratch_bytes.argtypes = [i64, i32, i32, i32]
        lib.hungarian_solve.argtypes = [i32, vp, vp, vp, i64, i32, i32, i32,
                                        vp, vp, vp]
    else:
        lib.hungarian_scratch_bytes.argtypes = [i64, i32]
        lib.hungarian_solve.argtypes = [i32, vp, vp, vp, i64, i32, i32, vp,
                                        vp]

    def run(cost, n_rows, probe=None):
        nb, n, m = cost.shape
        c = clusters or cluster_size(m)
        size = (lib.hungarian_scratch_bytes(nb, n, m, c) if clustered
                else lib.hungarian_scratch_bytes(nb, m))
        scratch = torch.empty(size, dtype=torch.uint8, device=cost.device)
        out = torch.empty(nb, n, dtype=torch.long, device=cost.device)
        head = (cost.device.index, cost.data_ptr(), n_rows.data_ptr(),
                out.data_ptr(), nb, n, m)
        args = ((*head, c, scratch.data_ptr(),
                 None if probe is None else probe.data_ptr(), _stream())
                if clustered else (*head, scratch.data_ptr(), _stream()))
        _build.check(lib.hungarian_solve(*args), "hungarian_solve")
        return out
    return run


def run_h1(device, parent=None, log=print):
    """H1 at phase 3d's four problems; raises if a kernel disagrees with
    the plain version. Returns a list of dicts."""
    import chip_smoke
    from boxer_tpu_torch.ops import hungarian as hg

    libs = {"this": _build.library()}
    if parent is not None:
        libs["other"] = load(Path(parent) / "boxer_tpu_torch" / "csrc")
    results = []
    for (label, _, _, _, _, outputs, targets,
         matcher) in chip_smoke.assignment_calls(device):
        _, sub, n_rows, _, _ = chip_smoke.assignment_of(matcher, outputs,
                                                        targets)
        nb, n, m = sub.shape
        want, steps = hg.solve_assignment_plain(sub, n_rows,
                                                count_steps=True)
        calls = {k: functools.partial(h1_launcher(v), sub, n_rows)
                 for k, v in libs.items()}
        for k, fn in calls.items():
            if not torch.equal(fn(), want):
                raise AssertionError(f"H1 ({k}) at {label} disagrees")
        timer = functools.partial(cuda_ms, iters=5)
        other, this = in_turns(calls.get("other"), calls["this"], timer)
        other_dev, this_dev = in_turns(calls.get("other"), calls["this"],
                                       functools.partial(device_ms, iters=5))
        r = dict(label=label, shape=tuple(sub.shape),
                 clusters=hg.cluster_size(m), steps=int(steps.max()),
                 ms=this, device_ms=this_dev, other_ms=other,
                 other_device_ms=other_dev, by_c={})
        for c in (1, 2, 4, 8, 16):
            if not hg.max_active_clusters(device, n, m, c):
                continue
            fn = functools.partial(h1_launcher(libs["this"], c), sub, n_rows)
            if not torch.equal(fn(), want):
                raise AssertionError(f"H1 at {label}, C {c} disagrees")
            r["by_c"][c] = (timer(fn), device_ms(fn, 5))
        # where a step's time goes: thread 0 of block 0 of problem 0,
        # clock64 cycles by part (csrc/hungarian.cu: Probe), a step's mean
        # in us at the SM clock nvidia-smi reads after the run
        probe = torch.zeros(len(H1_PROBES) + 2, dtype=torch.long,
                            device=device)
        h1_launcher(libs["this"])(sub, n_rows, probe)
        cycles = probe.tolist()
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
             "nounits"], capture_output=True, text=True,
            check=True).stdout.split()[0])
        steps0 = max(cycles[-2], 1)
        r["split_us"] = {part: cycles[i] / mhz / steps0
                         for i, part in enumerate(H1_PROBES)}
        r["probe_steps"], r["probe_us"] = cycles[-2], cycles[-1] / mhz
        log(f"H1 {label} {r['shape']} steps {r['steps']} C {r['clusters']}: "
            f"this {this:.4f} ms (device {this_dev:.4f}; "
            f"{1e3 * this / max(r['steps'], 1):.2f} us a step)"
            + ("" if other is None else
               f", other {other:.4f} ms (device {other_dev:.4f})")
            + "; by C " + ", ".join(f"{c}: {t:.4f} ({d:.4f})"
                                    for c, (t, d) in r["by_c"].items())
            + f"; problem 0: {r['probe_steps']} steps, {r['probe_us']:.1f} us "
            f"at {mhz:.0f} MHz, us a step by part: "
            + ", ".join(f"{k} {v:.3f}" for k, v in r["split_us"].items()))
        results.append(r)
        del sub, want
        torch.cuda.empty_cache()
    return results


def k4_launcher(lib):
    """K4 through the C entry point as the tree's wrapper calls it: the
    outputs allocated, then `instance_sample_reduce`."""
    from boxer_tpu_torch.ops.instance_sample import MAX_LEVELS

    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.instance_sample_reduce.argtypes = [
        i32, i32, vp, vp, vp, vp, ctypes.POINTER(i32), i32, vp, vp, vp, vp,
        vp, vp, i32, i32, i32, i32, vp]
    lib.instance_sample_reduce.restype = i32

    def run(tables, shapes, gx, gy, sw, lw, k):
        b, nh, nl, npt, lq = gx.shape
        table = tables[0]
        out = torch.empty((b, nh, lq, cr.CH), dtype=table.dtype,
                          device=table.device)
        mask = torch.empty((b, lq, k, k, nh * cr.CH), dtype=table.dtype,
                           device=table.device)
        ptrs = [t.data_ptr() for t in tables] + [None] * (MAX_LEVELS - nl)
        hw = (i32 * (2 * nl))(*(v for s in shapes for v in s))
        _build.check(lib.instance_sample_reduce(
            table.device.index, int(table.dtype == torch.bfloat16), *ptrs,
            hw, nl, *(t.data_ptr() for t in (gx, gy, sw, lw)),
            out.data_ptr(), mask.data_ptr(), b, nh, npt, lq, _stream()),
            "instance_sample_reduce")
        return out, mask
    return run


def k4_tile(lib, device, dtype, b, nh, lq):
    """The tile (queries, warps, blocks a cluster) a K4 library launches at
    B, H, LQ, by its `instance_sample_tile`."""
    i32 = ctypes.c_int
    lib.instance_sample_tile.argtypes = [i32] * 5 + [ctypes.POINTER(i32)]
    lib.instance_sample_tile.restype = i32
    tile = (i32 * 3)()
    _build.check(lib.instance_sample_tile(
        device.index, int(dtype == torch.bfloat16), b, nh, lq, tile),
        "instance_sample_tile")
    return tuple(tile)


# K4's probes: this tree's kernel source with one change each, by text
# (old, new); each old text must be in the source
K4_PROBES = {
    # every row read of a tap and level hits one of its head's first 16
    # quad rows of the level: the reads stay, all L1 hits
    "rows in L1": ("static_cast<long long>(s.row[l][it]) * 4 * kCh",
                   "(bh * (lv.h[l] + 1) * (lv.w[l] + 1) + (s.row[l][it] & 15))"
                   " * 4 * kCh"),
    # no row reads: each corner's 16 bytes made from its address
    "no row reads": ("v[l][c] = __ldg(reinterpret_cast<const uint4*>(src + c"
                     " * kCh));",
                     "v[l][c] = make_uint4(static_cast<unsigned>("
                     "reinterpret_cast<size_t>(src)) + c, 7u, 9u, 11u);"),
}


K4_RULE = ("int cluster_size(int device, int is_bf16, int batch, int heads, "
           "int lq) {\n")


def k4_tile_edits(tq, warps, splits=None):
    """The source edits that build K4 at `tq` queries and `warps` warps a
    block, and at `splits` blocks a cluster (None: the source's rule)."""
    edits = [("constexpr int kTileQ = 8;", f"constexpr int kTileQ = {tq};"),
             ("constexpr int kWarps = 4;", f"constexpr int kWarps = {warps};")]
    if splits is not None:
        edits.append((K4_RULE, K4_RULE + f"  return {splits};\n"))
    return edits


def k4_variant_libs(variants):
    """This tree's K4 source built once a variant ({name: [(old, new),
    ...]}), each into its own library under build/k4_variant/, the nvcc
    runs all started together; raises if an old text is not in the
    source."""
    from concurrent.futures import ThreadPoolExecutor

    src = (_build.CSRC / "instance_sample.cu").read_text()
    dirs = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"K4 variant {name!r}: {old!r} is not in "
                                   "csrc/instance_sample.cu any more")
            text = text.replace(old, new)
        csrc = (_build.BUILD_ROOT.parent / "k4_variant"
                / re.sub(r"\W+", "_", name).strip("_"))
        csrc.mkdir(parents=True, exist_ok=True)
        (csrc / "instance_sample.cu").write_text(text)
        dirs[name] = csrc
    with ThreadPoolExecutor(len(dirs)) as pool:
        paths = dict(zip(dirs, pool.map(_build.build, dirs.values())))
    return {name: ctypes.CDLL(str(path)) for name, path in paths.items()}


def run_k4(device, parent=None, log=print):
    """K4 at phase 3's segm shape, bf16 and f32 tables; raises if a kernel
    disagrees with the plain version or two of this tree's launches
    differ. Returns a list of dicts."""
    import numpy as np

    import chip_smoke
    from boxer_tpu_torch.ops import instance_sample as isr

    ba = importlib.import_module("boxer_tpu_torch.ops.box_attention")
    libs = {"this": _build.library()}
    if parent is not None:
        libs["other"] = load(Path(parent) / "boxer_tpu_torch" / "csrc")
    sweep = {(*t, None): k4_tile_edits(*t) for t in K4_TILES}
    sweep.update({(8, 4, sp): k4_tile_edits(8, 4, sp) for sp in K4_SPLITS})
    built = k4_variant_libs({**{str(t): e for t, e in sweep.items()},
                             **{n: [e] for n, e in K4_PROBES.items()}})
    value, taps, rows = chip_smoke.segm_instance_case(
        device, np.random.RandomState(0))
    shapes, k = chip_smoke.SEGM_LEVELS, chip_smoke.ROI_K
    results = []
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, TOL)):
        tables = ba._build_quad_tables(value.to(device, dtype), shapes)
        args = (tables, shapes, *taps, k)
        want = isr.instance_sample_reduce_plain(*args)
        calls = {side: functools.partial(k4_launcher(lib), *args)
                 for side, lib in libs.items()}
        errs = {side: rel_err(fn(), want) for side, fn in calls.items()}
        if max(errs.values()) > tol:
            raise AssertionError(f"K4 {dtype}: rel err {errs} > {tol}")
        first, again = calls["this"](), calls["this"]()
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError(f"K4 {dtype}: two launches differ")
        other, this = in_turns(calls.get("other"), calls["this"], cuda_ms)
        other_dev, this_dev = in_turns(calls.get("other"), calls["this"],
                                       device_ms)
        bound, _ = chip_smoke.k4_bound(rows, taps[0], dtype)
        shape = (*taps[0].shape[:2], taps[0].shape[-1])
        r = dict(dtype=str(dtype)[6:],
                 tile=isr.launch_tile(device, dtype, *shape),
                 ms=this, device_ms=this_dev, other_ms=other,
                 other_device_ms=other_dev, bound_ms=bound, rel_err=errs,
                 by_tile={})
        for variant in sweep:
            lib = built[str(variant)]
            tile = k4_tile(lib, device, dtype, *shape)
            fn = functools.partial(k4_launcher(lib), *args)
            err = rel_err(fn(), want)
            if err > tol:
                raise AssertionError(f"K4 {dtype} tile {tile}: rel err "
                                     f"{err} > {tol}")
            r["by_tile"][tile] = (cuda_ms(fn), device_ms(fn))
        # the probes (their outputs are not the op's)
        r["probes"] = {
            name: (cuda_ms(fn), device_ms(fn)) for name in K4_PROBES
            for fn in [functools.partial(k4_launcher(built[name]), *args)]}
        log(f"K4 [B=1 H=8 LQ=300 k=14, {rows} quad rows read, {r['dtype']} "
            f"tables, tile {r['tile']}]: this {this:.4f} ms (device "
            f"{this_dev:.4f})" + ("" if other is None else
                                  f", other {other:.4f} ms (device "
                                  f"{other_dev:.4f})")
            + f", bound {bound:.4f} ms, rel err "
            + ", ".join(f"{s} {e:.2e}" for s, e in errs.items())
            + "; probes: " + ", ".join(
                f"{name} {a:.4f} ({d:.4f})"
                for name, (a, d) in r["probes"].items())
            + "; by tile (queries, warps, splits): " + ", ".join(
                f"{t}: {a:.4f} ({d:.4f})"
                for t, (a, d) in r["by_tile"].items()))
        results.append(r)
        del tables, want
        torch.cuda.empty_cache()
    return results


# K9's rows: the segm cell's two box-attention calls at batch 16 of
# 800x1216 in bf16, (name, P, LQ); an LQ of None is the encoder's, every
# token a query
SEGM_LEVELS = ((100, 152), (50, 76), (25, 38), (13, 19))
K9_CALLS = (("encoder", 4, None), ("decoder", 196, 300))
K9_BATCH, K9_HEADS = 16, 8
# the pp3d.infer_b4 cell's two calls: 4 frames, the 469x469 grid's two
# levels, P 4 (L x P = 8: another warp split than segm's 16), rotated grids
PP3D_LEVELS = ((235, 235), (118, 118))
K9_3D_CALLS = (("encoder", 4, None), ("decoder", 4, 300))
K9_3D_BATCH = 4


def k9_case(device, seed, npt, lq, b=K9_BATCH, nh=K9_HEADS,
            shapes=SEGM_LEVELS, dtype=torch.bfloat16, turn=False):
    """K9's inputs on the card from a seed, laid out as the model lays
    them: value (B, S, H, 32) normal, in `dtype`; gx, gy (B, H, L, P, LQ) a
    k x k grid (P = k*k, x fastest, `make_kernel_indices`' offsets) over a
    box a (b, h, level, query), and the attention weights, a softmax over
    (L, P), f32. The encoder's queries (lq None) are the S tokens, each box
    its token's 4-pixel reference window at its level moved and scaled by
    up to 1/8 of its size; the decoder's are boxes with centres in [0.05,
    0.95] and sides in [0.02, 0.5], moved by 0.01 at each level, so some
    taps lie past a border. With `turn` each box's grid is turned about its
    centre by an angle in [0, 2 pi), as `Box3dAttention` turns it."""
    gen = torch.Generator(device=device).manual_seed(seed)
    nl, k = len(shapes), int(round(npt ** 0.5))
    s = sum(h * w for h, w in shapes)

    def unif(lo, hi, *shape):
        return torch.rand(*shape, generator=gen, device=device) * (hi - lo) + lo

    value = torch.randn(b, s, nh, cr.CH, generator=gen, device=device).to(
        dtype)
    if lq is None:
        lq = s
        ref = []
        for hl, wl in shapes:
            ys, xs = torch.meshgrid(torch.arange(hl, device=device),
                                    torch.arange(wl, device=device),
                                    indexing="ij")
            ref.append(torch.stack([(xs.reshape(-1) + 0.5) / wl,
                                    (ys.reshape(-1) + 0.5) / hl,
                                    torch.full((hl * wl,), 4.0 / wl,
                                               device=device),
                                    torch.full((hl * wl,), 4.0 / hl,
                                               device=device)]))
        cx, cy, rw, rh = torch.cat(ref, dim=1)             # (S,) each
        dx, dy, dw, dh = (unif(-1.0, 1.0, b, nh, nl, 1, lq) / 8
                          for _ in range(4))
        cx, cy = cx + dx * rw, cy + dy * rh
        rw, rh = rw * (1 + dw), rh * (1 + dh)
    else:
        def centre():
            return unif(0.05, 0.95, b, nh, 1, 1, lq) + 0.01 * torch.randn(
                b, nh, nl, 1, lq, generator=gen, device=device)

        cx, cy = centre(), centre()
        rw, rh = unif(0.02, 0.5, b, nh, 1, 1, lq), unif(0.02, 0.5, b, nh, 1,
                                                          1, lq)
    grid = (torch.arange(k, device=device) + 0.5) / k - 0.5
    kx, ky = grid.repeat(k)[:, None], grid.repeat_interleave(k)[:, None]
    ox, oy = kx * rw, ky * rh
    if turn:
        angle = unif(0.0, 2 * math.pi, b, nh, nl, 1, lq)
        cos, sin = torch.cos(angle), torch.sin(angle)
        ox, oy = ox * cos - oy * sin, ox * sin + oy * cos
    gx, gy = cx + ox, cy + oy
    aw = torch.softmax(torch.randn(b, nh, nl * npt, lq, generator=gen,
                                   device=device), dim=2)
    return value, gx.contiguous(), gy.contiguous(), aw.reshape(
        b, nh, nl, npt, lq)


def k9_bound(value, gx):
    """K9's bound: the value read once, gx, gy and the weights (f32) read
    once, the output written once (`benchmark/counts:box_attention_bytes`);
    operations, 4 corners of 32 channels a tap, at the f32 peak."""
    b, _, nh, ch = value.shape
    return bound_ms(nbytes(value) + 3 * gx.numel() * 4
                    + b * nh * gx.shape[-1] * ch * value.element_size(),
                    gx.numel() * 4 * ch * 2)


def quad_table_route(value, shapes, gx, gy, aw):
    """The inference route K9 replaced, from this tree's pieces: the quad
    tables, each level's taps, K1 (P <= 8) or K2 a level, summed in f32,
    cast. Returns (B, H, LQ, 32)."""
    ba = importlib.import_module("boxer_tpu_torch.ops.box_attention")
    b, _, nh, ch = value.shape
    lq = gx.shape[-1]
    out = torch.zeros((b * nh * lq, ch), dtype=torch.float32,
                      device=value.device)
    for table, (idx, lx, ly, _, w_tap) in zip(
            ba._build_quad_tables(value, shapes),
            ba._level_taps(shapes, gx, gy, aw, b * nh)):
        out = out + (cr.quad_sample_reduce_raw(table, idx, lx, ly, w_tap)
                     if idx.shape[0] <= 8 else cr.quad_sample_reduce_w4(
                         table, idx, cr.corner_weights(lx, ly, w_tap)))
    return out.to(value.dtype).reshape(b, nh, lq, ch)


def run_k9(device, log=print):
    """K9 at the segm cell's two calls (`K9_CALLS`): held against its plain
    version (rel err 1e-2 in bf16) and two launches bitwise, then its time
    (CUDA events and device time, each the mean of 20 calls), the plain
    version's, the route it replaced (this tree's pieces, `quad_table_route`)
    and the bound. Returns a list of dicts."""
    from boxer_tpu_torch.ops import box_sample as bs

    results = []
    for i, (name, npt, lq) in enumerate(K9_CALLS):
        value, gx, gy, aw = k9_case(device, 90 + i, npt, lq)
        args = (value, SEGM_LEVELS, gx, gy, aw)
        kernel = functools.partial(bs.box_sample_reduce, *args)
        plain = functools.partial(bs.box_sample_reduce_plain, *args)
        route = functools.partial(quad_table_route, *args)
        first, again, want = kernel(), kernel(), plain()
        err = rel_err(first, want)
        route_err = rel_err(route().permute(0, 2, 1, 3), want)
        if err > 1e-2 or route_err > 1e-2 or not torch.equal(first, again):
            raise AssertionError(f"K9 {name}: rel err {err}, the route's "
                                 f"{route_err}, bitwise "
                                 f"{torch.equal(first, again)}")
        del first, again, want
        bound, by = k9_bound(value, gx)
        r = dict(name=name, shape=f"B={K9_BATCH} H={K9_HEADS} L=4 P={npt} "
                 f"LQ={gx.shape[-1]} bf16", ms=cuda_ms(kernel), device_ms=device_ms(kernel),
                 plain_ms=cuda_ms(plain), route_ms=cuda_ms(route),
                 route_device_ms=device_ms(route), bound_ms=bound,
                 bound_by=by, rel_err=err)
        log(f"K9 {name} [{r['shape']}]: "
            f"{r['ms']:.4f} ms (device {r['device_ms']:.4f}), plain "
            f"{r['plain_ms']:.4f} ms, the quad-table route {r['route_ms']:.4f}"
            f" ms (device {r['route_device_ms']:.4f}), bound {bound:.4f} ms "
            f"({by}), rel err {err:.2e} (the route's {route_err:.2e})")
        results.append(r)
        del value, gx, gy, aw, args, kernel, plain, route
        torch.cuda.empty_cache()
    return results


# K10's row: the pp3d.infer_b4 cell's pillar net, 4 frames of 60,000
# pillars of 20 points on the 469x469 grid of 0.32 m pillars over +-75 m,
# filters (64, 128), bf16 weights
K10_FRAMES, K10_PILLARS, K10_POINTS = 4, 60000, 20
PP3D_VOXEL = (0.32, 0.32, 12.0)
PP3D_RANGE = (-75.0, -75.0, -3.0, 75.0, 75.0, 5.0)


def k10_case(device, seed, frames=K10_FRAMES, pillars=K10_PILLARS,
             points=K10_POINTS, dtype=torch.bfloat16):
    """K10's inputs on the card from a seed: each frame's pillars on
    distinct cells of the 469x469 grid, 1-20 points a pillar (one in 16
    empty), points inside their cell, z about the ground, intensity and
    elongation in [0, 1), padding rows zero; and a `PillarFeatureNet` of
    the cell's widths with seeded weights in `dtype`. Returns (features
    (V, P, 5) f32, num_voxels (V,) int32, coors (V, 4) int32, the net)."""
    from boxer_tpu_torch.nn.point_pillar import PillarFeatureNet

    gen = torch.Generator(device=device).manual_seed(seed)
    nx = int(round((PP3D_RANGE[3] - PP3D_RANGE[0]) / PP3D_VOXEL[0]))
    cells = torch.cat([torch.randperm(nx * nx, generator=gen,
                                      device=device)[:pillars]
                       for _ in range(frames)])
    v = frames * pillars
    ix, iy = cells % nx, cells // nx
    n = torch.randint(1, points + 1, (v,), generator=gen, device=device)
    n = torch.where(torch.rand(v, generator=gen, device=device) < 1 / 16,
                    0, n).int()

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=device)

    x = (ix[:, None] + rand(v, points)) * PP3D_VOXEL[0] + PP3D_RANGE[0]
    y = (iy[:, None] + rand(v, points)) * PP3D_VOXEL[1] + PP3D_RANGE[1]
    z = torch.randn(v, points, generator=gen, device=device)
    feats = torch.stack([x, y, z, rand(v, points), rand(v, points)], -1)
    feats = torch.where((torch.arange(points, device=device)[None, :]
                         < n[:, None])[..., None], feats, 0.0).float()
    b = torch.arange(frames, device=device).repeat_interleave(pillars)
    coors = torch.stack([b, torch.zeros_like(b), iy, ix], 1).int()
    net = PillarFeatureNet(5, (64, 128), PP3D_VOXEL, PP3D_RANGE)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for prm in net.parameters():
            z = torch.randn(prm.shape, generator=g)
            prm.copy_(z / math.sqrt(prm.shape[1]) if prm.dim() == 2
                      else 1 + 0.1 * z)
    return (feats.contiguous(), n.contiguous(), coors.contiguous(),
            net.to(device, dtype).eval())


def k10_bound(feats, out):
    """K10's bound: the points, counts and coordinates read once and the
    output written once; operations, both layers' products (2 x V x P x
    (10 x 32 + 64 x 128)), at the bf16 peak (layer 1's share, in f32, is
    4%)."""
    v, p, _ = feats.shape
    return bound_ms(nbytes(feats, out) + v * (1 + 4) * 4,
                    2 * v * p * (10 * 32 + 64 * 128), "bf16")


def pillar_err(got, want):
    """The largest relative norm of a pillar's difference."""
    got, want = got.double(), want.double()
    return float(((got - want).norm(dim=-1)
                  / want.norm(dim=-1).clamp(min=1e-12)).max())


def run_k10(device, log=print):
    """K10 at the pp3d.infer_b4 cell's shape (`k10_case`): held against
    its plain version (a pillar's relative error 1e-2 in bf16) and two
    launches bitwise, then its time (CUDA events and device time, each the
    mean of 20 calls), the plain version's, and the bound. Returns a
    dict."""
    from boxer_tpu_torch.ops import pillar_net as pn

    feats, n, coors, net = k10_case(device, 100)
    args = (feats, n, coors, PP3D_VOXEL, PP3D_RANGE, net.pfn_layers)
    kernel = functools.partial(pn.pillar_features, *args)
    plain = functools.partial(pn.pillar_features_plain, *args)
    with torch.no_grad():
        first, again, want = kernel(), kernel(), plain()
        err = pillar_err(first, want)
        if err > 1e-2 or not torch.equal(first, again):
            raise AssertionError(f"K10: pillar err {err}, bitwise "
                                 f"{torch.equal(first, again)}")
        bound, by = k10_bound(feats, first)
        del first, again, want
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        ms, dev_ms = cuda_ms(kernel), device_ms(kernel)
        peak = (torch.cuda.max_memory_allocated(device) - base) / 2 ** 30
        torch.cuda.reset_peak_memory_stats(device)
        plain_ms = cuda_ms(plain)
        plain_peak = (torch.cuda.max_memory_allocated(device) - base) / 2 ** 30
    r = dict(shape=f"V={feats.shape[0]} P={feats.shape[1]} filters (64, "
             f"128) bf16", ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
             bound_ms=bound, bound_by=by, pillar_err=err, peak_gib=peak,
             plain_peak_gib=plain_peak)
    log(f"K10 [{r['shape']}]: {ms:.4f} ms (device {dev_ms:.4f}), plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}), pillar err "
        f"{err:.2e}; memory above the inputs {peak:.3f} GiB (plain "
        f"{plain_peak:.3f})")
    return r


# K11's rows: the pp3d.infer_b4 cell's neck, batch 4: ((C, H, W), calls)
K11_CALLS = (((256, 469, 469), 2), ((512, 235, 235), 4),
             ((1024, 118, 118), 2))
K11_BATCH = 4


def k11_case(device, seed, c, h, w, batch=K11_BATCH, dtype=torch.bfloat16):
    """K11's inputs on the card from a seed: x (batch, h, w, c) NHWC in
    `dtype`, a convolution's output with an offset a channel (normal, 0.3)
    on a unit normal; weight 1 + 0.1 normal and bias 0.1 normal in
    `dtype`. Returns (x, weight, bias)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    x = (randn(batch, h, w, c) + 0.3 * randn(c)).to(dtype)
    return x, (1 + 0.1 * randn(c)).to(dtype), (0.1 * randn(c)).to(dtype)


def k11_bound(x, out):
    """K11's bound: x read twice (statistics, then apply) and the output
    written once; its few operations a value are far below the bytes."""
    return bound_ms(2 * nbytes(x) + nbytes(out), 0)


def library_group_norm_relu(x, weight, bias, eps):
    """The yardstick: torch's `GroupNorm(32, C)` and `ReLU` on the NCHW
    copy of x (made here, outside the call)."""
    nchw = x.permute(0, 3, 1, 2).contiguous()
    return lambda: torch.relu(torch.nn.functional.group_norm(
        nchw, 32, weight, bias, eps))


def run_k11(device, log=print):
    """K11 at the pp3d.infer_b4 cell's eight calls (`K11_CALLS`): at each
    shape held against its plain version (rel err 1e-2 in bf16) and two
    launches bitwise, then its time (CUDA events and device time, each the
    mean of 20 calls), the plain version's, torch's GroupNorm + ReLU on the
    NCHW tensor and the bound; then the eight calls' sums. Returns a list
    of dicts, the sums last."""
    from boxer_tpu_torch.nn.point_pillar import GN_EPS
    from boxer_tpu_torch.ops import group_norm as gn

    rows, keys = [], ("ms", "device_ms", "plain_ms", "library_ms",
                      "bound_ms")
    for (c, h, w), calls in K11_CALLS:
        x, weight, bias = k11_case(device, c, c, h, w)
        args = (x, weight, bias, GN_EPS)
        kernel = functools.partial(gn.group_norm_relu, *args)
        plain = functools.partial(gn.group_norm_relu_plain, *args)
        library = library_group_norm_relu(*args)
        first, again, want = kernel(), kernel(), plain()
        err = rel_err(first, want)
        lib_err = rel_err(library().permute(0, 2, 3, 1), want)
        if err > 1e-2 or not torch.equal(first, again):
            raise AssertionError(f"K11 {c}x{h}x{w}: rel err {err}, bitwise "
                                 f"{torch.equal(first, again)}")
        bound, _ = k11_bound(x, first)
        del first, again, want
        r = dict(shape=f"B={K11_BATCH} {c}x{h}x{w} bf16", calls=calls,
                 ms=cuda_ms(kernel), device_ms=device_ms(kernel),
                 plain_ms=cuda_ms(plain), library_ms=cuda_ms(library),
                 bound_ms=bound, rel_err=err, library_rel_err=lib_err)
        log(f"K11 [{r['shape']}] x{calls}: {r['ms']:.4f} ms (device "
            f"{r['device_ms']:.4f}), plain {r['plain_ms']:.4f} ms, torch "
            f"GroupNorm + ReLU (NCHW) {r['library_ms']:.4f} ms, bound "
            f"{bound:.4f} ms (bytes, {100 * bound / r['device_ms']:.1f}% of "
            f"it), rel err {err:.2e} (torch's {lib_err:.2e})")
        rows.append(r)
        del x, args, kernel, plain, library
        torch.cuda.empty_cache()
    total = {k: sum(r[k] * r["calls"] for r in rows) for k in keys}
    share = 100 * total["bound_ms"] / total["device_ms"]
    log(f"K11, the cell's 8 calls: {total['ms']:.4f} ms (device "
        f"{total['device_ms']:.4f}), plain {total['plain_ms']:.4f} ms, torch "
        f"GroupNorm + ReLU {total['library_ms']:.4f} ms, bound "
        f"{total['bound_ms']:.4f} ms ({share:.1f}% of it), largest rel err "
        f"{max(r['rel_err'] for r in rows):.2e}")
    return rows + [dict(shape="the cell's 8 calls", **total)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="unpacked copy of the tree to compare "
                    "against (this tree's C signatures)")
    ap.add_argument("--h1", action="store_true",
                    help="time H1 alone, at phase 3d's problems")
    ap.add_argument("--k4", action="store_true",
                    help="time K4 alone, at phase 3's segm shape, and "
                    "variants of this tree's K4 by tile")
    ap.add_argument("--k9", action="store_true",
                    help="time K9 alone, at the segm cell's two calls, "
                    "beside its plain version and the route it replaced")
    ap.add_argument("--k10", action="store_true",
                    help="time K10 alone, at the 3D cell's pillar net, "
                    "beside its plain version")
    ap.add_argument("--k11", action="store_true",
                    help="time K11 alone, at the 3D cell's eight neck "
                    "norms, beside its plain version and torch's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_kernels: no CUDA card; this tool times kernels")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    import chip_smoke

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.h1:
        run_h1(dev, args.parent, log=lambda s: print(s, flush=True))
        return
    if args.k4:
        run_k4(dev, args.parent, log=lambda s: print(s, flush=True))
        return
    if args.k9:
        run_k9(dev, log=lambda s: print(s, flush=True))
        return
    if args.k10:
        run_k10(dev, log=lambda s: print(s, flush=True))
        return
    if args.k11:
        with torch.no_grad():
            run_k11(dev, log=lambda s: print(s, flush=True))
        return
    run(dev, args.parent, log=lambda s: print(s, flush=True),
        model_inputs=chip_smoke.k7b_model_inputs(dev))


if __name__ == "__main__":
    main()
