"""The port's kernels (boxer_tpu_torch/ops) against the JAX package's Pallas
kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
its Pallas kernel in the TPU interpret mode (as tests/test_flash_attention.py
and tests/test_scatter_interpret.py do), with the gathered rows
`g = table[idx]` taken in numpy. Both accumulate in f32 and differ only in
summation order: rel err <= 1e-5. The scatters (K5, K6, K7a, K7b) take
global table rows where the JAX kernels take rows relative to each
(batch*head) slice. The combine shootout's variants (T1-T3, through the
port's `tools/bench_combine.py`) are held against the production Pallas
kernels whose functions they compute (the JAX tools themselves are not
imported: they set jax's compilation cache on import).

The cases that compare a CUDA kernel with its plain version need a card
(marker `gpu`) and skip without one. jax is imported only inside the JAX
cases, so on a card without jax they run with
`python -m pytest --noconftest -p no:cacheprovider -m gpu
tests/test_torch_kernels.py`.
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget)
import importlib

import numpy as np
import pytest
import torch

from boxer_tpu_torch.ops import instance_sample
from boxer_tpu_torch.ops.combine_reduce import (
    quad_sample_reduce_mmajor, quad_sample_reduce_mmajor_plain,
    quad_sample_reduce_plain, quad_sample_reduce_raw, quad_sample_reduce_w4)
from boxer_tpu_torch.ops.flash_attention import (NEG_INF, flash_attention,
                                                 flash_attention_plain)
from boxer_tpu_torch.ops.instance_sample import (instance_sample_reduce,
                                                 instance_sample_reduce_plain)
from boxer_tpu_torch.ops.scatter_accum import (
    scatter_accum_dw4_plain, scatter_accum_plain, scatter_add_rows,
    scatter_add_rows_pmajor, scatter_add_rows_pmajor_weighted,
    scatter_add_rows_weighted, scatter_add_rows_weighted_dw4,
    scatter_rows_plain)
from boxer_tpu_torch.tools import bench_combine

RTOL = 1e-5


def _rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(1e-6, np.abs(b).max())


@pytest.fixture()
def interp():
    """Pallas interpret mode, with the combine kernels' build caches
    cleared so no interpret-mode callable outlives the test."""
    from jax.experimental.pallas import tpu as pltpu

    import boxer_tpu.ops.pallas.combine_reduce as cr

    caches = (cr._build_call, cr._build_call_onepass,
              cr._build_call_onepass_raw, cr._build_mmajor_call)
    for f in caches:
        f.cache_clear()
    with pltpu.force_tpu_interpret_mode():
        yield cr
    for f in caches:
        f.cache_clear()


@pytest.fixture()
def interp_scatter():
    """As `interp`, for the scatter kernels."""
    from jax.experimental.pallas import tpu as pltpu

    import boxer_tpu.ops.pallas.scatter_accum as sa

    caches = (sa._build_call, sa._build_call_pmajor, sa._build_call_weighted,
              sa._build_call_pmajor_weighted)
    for f in caches:
        f.cache_clear()
    with pltpu.force_tpu_interpret_mode():
        yield sa
    for f in caches:
        f.cache_clear()


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _quad_case(p, m, rows, seed):
    rs = np.random.RandomState(seed)
    table = rs.randn(rows, 128).astype(np.float32)
    idx = rs.randint(0, rows, size=(p, m)).astype(np.int32)
    lx, ly, wt = rs.rand(3, p, m).astype(np.float32)
    w4 = rs.rand(p, 4, m).astype(np.float32)
    return table, idx, lx, ly, wt, w4


# K4's levels: four small ones, and the segm forward's at 800x1216
INSTANCE_SHAPES = ((9, 13), (5, 7), (3, 4), (2, 2))
SEGM_SHAPES = ((100, 152), (50, 76), (25, 38), (13, 19))


def instance_case(b, nh, k, shapes, lq, seed):
    """K4's inputs from a seed, numpy f32: value (B, S, H, 32) and gx, gy,
    spatial_w, level_w (B, H, L, k*k, LQ). A third of the locations lie on,
    just inside or past the level borders, a third on the level's cell
    edges ((i + 0.5) / W, where x = gx*W - 0.5 lands on an integer and a
    fused multiply-add would move floor), the rest uniform over [-0.2,
    1.2]."""
    rs = np.random.RandomState(seed)
    size = (b, nh, len(shapes), k * k, lq)
    value = rs.randn(b, sum(h * w for h, w in shapes), nh, 32).astype(
        np.float32)
    borders = np.array([-0.3, -0.05, 0.0, 1e-3, 0.37, 0.5, 0.999, 1.0, 1.05,
                        1.3], np.float32)

    def coords(axis):
        pick = rs.randint(0, 3, size)
        out = np.where(pick == 0, rs.choice(borders, size),
                       rs.uniform(-0.2, 1.2, size)).astype(np.float32)
        for li, hw in enumerate(shapes):
            n = hw[axis]
            cells = ((np.arange(-1, n + 1) + 0.5) / n).astype(np.float32)
            on = pick[:, :, li] == 1
            out[:, :, li][on] = rs.choice(cells, int(on.sum()))
        return out

    gx, gy = coords(1), coords(0)
    sw, lw = rs.rand(2, *size).astype(np.float32)
    return value, gx, gy, sw, lw


def instance_inputs(case, shapes, device, dtype=torch.float32):
    """An `instance_case` as K4's arguments on `device`: the value's quad
    tables in `dtype` and gx, gy, spatial_w, level_w f32."""
    ba = importlib.import_module("boxer_tpu_torch.ops.box_attention")
    value, *taps = case
    tables = ba._build_quad_tables(torch.from_numpy(value).to(device, dtype),
                                   shapes)
    return tables, [torch.from_numpy(a).to(device) for a in taps]


def _flash_case(bh, lq, lkv, d, masked, seed):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(bh, n, d).astype(np.float32) * 0.5
               for n in (lq, lkv, lkv))
    mask = (np.where(rs.rand(bh, lkv) < 0.2, NEG_INF, 0.0).astype(np.float32)
            if masked else None)
    return q, k, v, mask


@pytest.mark.parametrize("p", [1, 3, 4, 8])
def test_k1_raw_matches_pallas(interp, p):
    """K1: raw weights at P up to the one-pass limit of 8, M=3000 (not a
    multiple of the 2048 block)."""
    import jax.numpy as jnp

    m = 3000
    table, idx, lx, ly, wt, _ = _quad_case(p, m, rows=700, seed=p)
    g = table[idx.reshape(-1)]
    want = interp.fused_combine_reduce_raw(
        jnp.asarray(g), jnp.asarray(lx), jnp.asarray(ly), jnp.asarray(wt), p, m)
    got = quad_sample_reduce_raw(torch.from_numpy(table), torch.from_numpy(idx),
                                 torch.from_numpy(lx), torch.from_numpy(ly),
                                 torch.from_numpy(wt))
    assert got.shape == (m, 32) and got.dtype == torch.float32
    assert _rel_err(got.numpy(), want) <= RTOL


@pytest.mark.parametrize("p", [196, 16])
def test_k2_w4_matches_pallas(interp, p):
    """K2: precomputed corner weights; P > 8 takes the accumulator-carry
    Pallas kernel."""
    import jax.numpy as jnp

    m = 600
    table, idx, _, _, _, w4 = _quad_case(p, m, rows=900, seed=p)
    g = table[idx.reshape(-1)]
    want = interp.fused_combine_reduce(jnp.asarray(g), jnp.asarray(w4), p, m)
    got = quad_sample_reduce_w4(torch.from_numpy(table), torch.from_numpy(idx),
                                torch.from_numpy(w4))
    assert _rel_err(got.numpy(), want) <= RTOL


@pytest.mark.parametrize("bh,lq,lkv", [(8, 300, 300), (2, 65, 130)])
@pytest.mark.parametrize("masked", [False, True])
def test_k3_matches_pallas(masked, bh, lq, lkv):
    """K3 at the decoder's shape (BH=8, L=300, D=32) and at a ragged
    Lq != Lkv, neither a multiple of the Pallas kernel's 128 block."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from boxer_tpu.ops.pallas import flash_attention as fa

    q, k, v, mask = _flash_case(bh, lq, lkv, 32, masked, seed=int(masked))
    with pltpu.force_tpu_interpret_mode():
        want = fa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v),
                                  None if mask is None else jnp.asarray(mask))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v),
                          None if mask is None else torch.from_numpy(mask))
    assert _rel_err(got.numpy(), np.asarray(want)) <= RTOL


def _scatter_case(p, bh, n, rb, seed):
    """Slice-relative rows with the slice's first and last row and many
    repeats (rb is small), g and corner weights."""
    rs = np.random.RandomState(seed)
    idx = rs.randint(0, rb, (p, bh, n)).astype(np.int32)
    idx[:, :, :2] = [0, rb - 1]
    g = rs.randn(p, bh, n, 32).astype(np.float32)
    w4 = rs.rand(p, bh, 4, n).astype(np.float32)
    return idx, g, w4


def _global_rows(idx, rb):
    """(P, BH, N) slice-relative rows -> (P, BH*N) global rows."""
    p, bh, n = idx.shape
    return (idx + (np.arange(bh, dtype=np.int32) * rb)[None, :, None]
            ).reshape(p, bh * n)


def test_k5_matches_pallas(interp_scatter):
    """K5: two tap sets sharing g. The JAX per-tap path calls its kernel
    once per tap with the same d_out; here both tap sets go into one call,
    side by side along its tap axis."""
    import jax.numpy as jnp

    p, bh, n, rb = 2, 2, 300, 40
    idx, g, w4 = _scatter_case(p, bh, n, rb, seed=0)
    g = np.broadcast_to(g[:1], g.shape)

    def taps_side_by_side(x):             # (P, BH, ..., N) -> (BH, ..., P*N)
        return jnp.asarray(np.concatenate(list(x), axis=-1))

    want = np.asarray(interp_scatter.scatter_add_rows_weighted(
        taps_side_by_side(idx), jnp.asarray(np.concatenate(list(g), axis=1)),
        taps_side_by_side(w4), rb))
    got = scatter_add_rows_weighted(
        torch.from_numpy(_global_rows(idx, rb)),
        torch.from_numpy(g[0].reshape(bh * n, 32).copy()),
        torch.from_numpy(w4.transpose(0, 2, 1, 3).reshape(p, 4, bh * n)
                         .copy()), bh * rb)
    assert got.shape == (bh * rb, 128) and got.dtype == torch.float32
    assert _rel_err(got.numpy(), want.reshape(bh * rb, 128)) <= RTOL


def test_k6_matches_pallas(interp_scatter):
    """K6: per-tap g in p-major order."""
    import jax.numpy as jnp

    p, bh, lq, rb = 4, 2, 30, 40
    idx, g, w4 = _scatter_case(p, bh, lq, rb, seed=1)
    want = interp_scatter.scatter_add_rows_pmajor_weighted(
        jnp.asarray(idx), jnp.asarray(g), jnp.asarray(w4), rb)
    got = scatter_add_rows_pmajor_weighted(
        torch.from_numpy(_global_rows(idx, rb)),
        torch.from_numpy(g.reshape(p * bh * lq, 32)),
        torch.from_numpy(w4.transpose(0, 2, 1, 3).reshape(p, 4, bh * lq)
                         .copy()), bh * rb)
    assert _rel_err(got.numpy(), np.asarray(want).reshape(bh * rb, 128)) \
        <= RTOL


@pytest.mark.parametrize("layout,p", [("flat", 4), ("pmajor", 4),
                                      ("pmajor", 16)])
def test_k56_dw4_matches_jax_vjp(interp_scatter, monkeypatch, layout, p):
    """The fused backward's plain version, (d_table, d_w4), against
    `jax.vjp` of the JAX package's `_sample_taps_vjp`, whose d_table
    scatter runs as a Pallas kernel in interpret mode. flat: the per-tap
    layout, the P taps of each output side by side on its tap axis with the
    same cotangent row (K5's shared g); p-major: one cotangent row per tap
    (K6). P=16 stands for the segm decoder's P=196: the interpreted
    kernel's time grows with P."""
    import importlib

    import jax
    import jax.numpy as jnp

    # the package re-exports a function under the module's name
    jba = importlib.import_module("boxer_tpu.ops.box_attention")
    per_tap = layout == "pmajor"
    bh, lq, rb = 2, (12 if p > 8 else 30), 40
    idx, _, w4 = _scatter_case(p, bh, lq, rb, seed=p + per_tap)
    rs = np.random.RandomState(p)
    table = rs.randn(bh * rb, 128).astype(np.float32)
    g = rs.randn(p * bh * lq if per_tap else bh * lq, 32).astype(np.float32)
    gidx = _global_rows(idx, rb).reshape(p, bh, lq)
    if per_tap:
        j_idx, j_w4, j_g = gidx, w4, g
    else:                                  # tap axis in (p, lq) order
        j_idx = np.concatenate(list(gidx), axis=-1)           # (BH, P*LQ)
        j_w4 = np.concatenate(list(w4), axis=-1)              # (BH, 4, P*LQ)
        j_g = np.broadcast_to(g.reshape(bh, 1, lq, 32),
                              (bh, p, lq, 32)).reshape(-1, 32)
    monkeypatch.setenv("BOXER_FORCE_PALLAS_SCATTER", "1")
    jba._sample_taps_vjp.cache_clear()
    try:
        sample = jba._sample_taps_vjp(rb, bh)
        _, vjp = jax.vjp(lambda t, w: sample(t, jnp.asarray(j_idx), w),
                         jnp.asarray(table), jnp.asarray(j_w4))
        want_table, want_w4 = (np.asarray(x) for x in vjp(jnp.asarray(j_g)))
    finally:
        jba._sample_taps_vjp.cache_clear()
    if per_tap:
        want_w4 = want_w4.transpose(0, 2, 1, 3)               # (P, 4, BH, LQ)
    else:
        want_w4 = want_w4.reshape(bh, 4, p, lq).transpose(2, 1, 0, 3)
    got_table, got_w4 = scatter_accum_dw4_plain(
        torch.from_numpy(_global_rows(idx, rb)), torch.from_numpy(g),
        torch.from_numpy(w4.transpose(0, 2, 1, 3).reshape(p, 4, bh * lq)
                         .copy()), torch.from_numpy(table), per_tap)
    assert got_table.shape == (bh * rb, 128) and got_w4.shape == (p, 4,
                                                                  bh * lq)
    assert _rel_err(got_table.numpy(), want_table) <= RTOL
    assert _rel_err(got_w4.numpy(), want_w4.reshape(p, 4, bh * lq)) <= RTOL


def test_k7a_matches_pallas(interp_scatter):
    """K7a: 300 taps per slice, not a multiple of the kernel's 4096-tap
    chunk, so the JAX side pads into its dump rows."""
    import jax.numpy as jnp

    bh, n, rb = 2, 300, 40
    rs = np.random.RandomState(2)
    idx = rs.randint(0, rb, (bh, n)).astype(np.int32)
    idx[:, :2] = [0, rb - 1]
    payload = rs.randn(bh, n, 128).astype(np.float32)
    want = np.asarray(interp_scatter.scatter_add_rows(
        jnp.asarray(idx), jnp.asarray(payload), rb))
    got = scatter_add_rows(torch.from_numpy(_global_rows(idx[None], rb)[0]),
                           torch.from_numpy(payload.reshape(bh * n, 128)),
                           bh * rb)
    assert got.shape == (bh * rb, 128) and got.dtype == torch.float32
    assert _rel_err(got.numpy(), want.reshape(bh * rb, 128)) <= RTOL


def test_k7b_matches_pallas(interp_scatter):
    """K7b: p-major taps, LQ=30 per slice, padded to the kernel's 128-tap
    block on the JAX side."""
    import jax.numpy as jnp

    p, bh, lq, rb = 3, 2, 30, 40
    rs = np.random.RandomState(3)
    idx = rs.randint(0, rb, (p, bh, lq)).astype(np.int32)
    idx[:, :, :2] = [0, rb - 1]
    payload = rs.randn(p, bh, lq, 128).astype(np.float32)
    want = np.asarray(interp_scatter.scatter_add_rows_pmajor(
        jnp.asarray(idx), jnp.asarray(payload), rb))
    got = scatter_add_rows_pmajor(
        torch.from_numpy(_global_rows(idx, rb)),
        torch.from_numpy(payload.reshape(p * bh * lq, 128)), bh * rb)
    assert got.shape == (bh * rb, 128) and got.dtype == torch.float32
    assert _rel_err(got.numpy(), want.reshape(bh * rb, 128)) <= RTOL


def test_k7b_skewed_matches_pallas(interp_scatter):
    """K7b on skewed rows, as the folded encoder's coarse levels send them:
    most taps on a few rows (hundreds a row, more than a segment piece of
    the kernel takes), some rows never hit, rows 0 and rb-1 hit."""
    import jax.numpy as jnp

    p, bh, lq, rb = 4, 2, 150, 40
    rs = np.random.RandomState(4)
    hot = np.array([0, 3, 7, rb - 1], np.int32)
    idx = np.where(rs.rand(p, bh, lq) < 0.9,
                   hot[rs.randint(0, 4, (p, bh, lq))],
                   rs.randint(0, rb // 2, (p, bh, lq))).astype(np.int32)
    payload = rs.randn(p, bh, lq, 128).astype(np.float32)
    want = np.asarray(interp_scatter.scatter_add_rows_pmajor(
        jnp.asarray(idx), jnp.asarray(payload), rb)).reshape(bh * rb, 128)
    got = scatter_add_rows_pmajor(
        torch.from_numpy(_global_rows(idx, rb)),
        torch.from_numpy(payload.reshape(p * bh * lq, 128)), bh * rb)
    hits = np.bincount(_global_rows(idx, rb).reshape(-1), minlength=bh * rb)
    assert hits.max() > 64 and (hits == 0).any()
    assert _rel_err(got.numpy(), want) <= RTOL
    assert not got.numpy()[hits == 0].any()


def _mmajor_case(p, m, rows, seed):
    """The taps of `_quad_case` in (m, p) order."""
    table, idx, lx, ly, wt, _ = _quad_case(p, m, rows, seed)
    return (table,) + tuple(np.ascontiguousarray(a.T)
                            for a in (idx, lx, ly, wt))


@pytest.mark.parametrize("p,m", [(4, 3000), (196, 100), (1, 3000),
                                 (8, 1000), (9, 600)])
def test_k8_mmajor_matches_pallas(interp, p, m):
    """K8: M not a multiple of the kernel's outputs per block (1024 at P=4,
    16 at P=196); P on both sides of the card's boundary between its direct
    (P <= 8) and staged kernels."""
    import jax.numpy as jnp

    table, idx, lx, ly, wt = _mmajor_case(p, m, rows=700, seed=p + 1)
    g = table[idx.reshape(-1)]
    want = interp.fused_combine_reduce_mmajor(
        jnp.asarray(g), *(jnp.asarray(a.reshape(1, -1)) for a in (lx, ly, wt)),
        p, m)
    got = quad_sample_reduce_mmajor(*(torch.from_numpy(a) for a in
                                      (table, idx, lx, ly, wt)))
    assert got.shape == (m, 32) and got.dtype == torch.float32
    assert _rel_err(got.numpy(), want) <= RTOL


@pytest.mark.parametrize("variant,p,m", [
    ("T1", 4, 3000), ("T1 bf16 out", 4, 3000), ("T1", 196, 100),
    ("T2", 4, 3000), ("T2", 16, 600), ("T3", 4, 5000), ("gather-fed", 4, 600),
])
def test_shootout_matches_pallas(interp, variant, p, m):
    """The shootout's cases on the CPU (their plain versions) against the
    Pallas kernels of the same function: T1 (m-major rows gathered
    beforehand, identity index) against `fused_combine_reduce_mmajor`, T2
    and T3 (p-major, identity index) and the gather-fed variant against
    `fused_combine_reduce` (its one-pass kernel at P <= 8, the accumulator
    carry above)."""
    import jax.numpy as jnp

    rs = np.random.RandomState(p * 7 + m)
    bc = bench_combine
    if variant.startswith("T1"):
        g = rs.randn(p * m, 128).astype(np.float32)
        lx, ly, wt = rs.rand(3, m, p).astype(np.float32)
        case = bc.mmajor_case(torch.from_numpy(g),
                              bc.identity_rows(p, m, True, "cpu"),
                              *(torch.from_numpy(a) for a in (lx, ly, wt)),
                              out_bf16=variant == "T1 bf16 out")
        want = np.asarray(interp.fused_combine_reduce_mmajor(
            jnp.asarray(g), *(jnp.asarray(a.reshape(1, -1))
                              for a in (lx, ly, wt)), p, m))
    else:
        w4 = rs.rand(p, 4, m).astype(np.float32)
        if variant == "gather-fed":
            table = rs.randn(900, 128).astype(np.float32)
            idx = rs.randint(0, 900, (p, m)).astype(np.int32)
            g = table[idx.reshape(-1)]
        else:
            g = table = rs.randn(p * m, 128).astype(np.float32)
            idx = bc.identity_rows(p, m, False, "cpu").numpy()
        case = bc.pmajor_case(torch.from_numpy(table), torch.from_numpy(idx),
                              torch.from_numpy(w4))
        want = np.asarray(interp.fused_combine_reduce(
            jnp.asarray(g), jnp.asarray(w4), p, m))
    got = case["kernel"]().float().numpy()
    tol = 1e-2 if variant == "T1 bf16 out" else RTOL
    assert got.shape == (m, 32)
    assert _rel_err(got, want) <= tol


def test_cpu_tensors_take_the_plain_version_only():
    """A CPU call launches nothing; a device that is neither CPU nor CUDA
    raises instead of falling back."""
    table, idx, lx, ly, wt, w4 = (torch.from_numpy(a)
                                  for a in _quad_case(2, 10, 50, seed=3))
    g = table[:10, :32].contiguous()
    idx_m, lx_m, ly_m, wt_m = (t.t().contiguous() for t in (idx, lx, ly, wt))
    wrappers = (quad_sample_reduce_raw, quad_sample_reduce_w4,
                quad_sample_reduce_mmajor, flash_attention,
                scatter_add_rows_weighted, scatter_add_rows_pmajor_weighted,
                scatter_add_rows, scatter_add_rows_pmajor,
                instance_sample_reduce)
    launches = [f.launches for f in wrappers]
    quad_sample_reduce_raw(table, idx, lx, ly, wt)
    quad_sample_reduce_w4(table, idx, w4)
    quad_sample_reduce_mmajor(table, idx_m, lx_m, ly_m, wt_m)
    flash_attention(table[None, :8, :32], table[None, :8, :32],
                    table[None, :8, :32])
    scatter_add_rows_weighted(idx, g, w4, 50)
    scatter_add_rows_pmajor_weighted(idx, table[:20, :32], w4, 50)
    for per_tap, gt in ((False, g), (True, table[:20, :32])):
        d_table, d_w4 = scatter_add_rows_weighted_dw4(idx, gt, w4, table,
                                                      per_tap)
        assert d_table.shape == (50, 128) and d_w4.shape == (2, 4, 10)
        assert scatter_add_rows_weighted_dw4(
            idx, gt, w4, table, per_tap, want_table=False)[0] is None
    scatter_add_rows(idx.reshape(-1), table[:20], 50)
    scatter_add_rows_pmajor(idx, table[:20], 50)
    tables, taps = instance_inputs(instance_case(1, 2, 2, INSTANCE_SHAPES, 5,
                                                 seed=4), INSTANCE_SHAPES,
                                   "cpu")
    out, mask = instance_sample_reduce(tables, INSTANCE_SHAPES, *taps, 2)
    assert out.shape == (1, 2, 5, 32) and mask.shape == (1, 5, 2, 2, 64)
    assert [f.launches for f in wrappers] == launches
    meta = [t.to("meta") for t in (table, idx, lx, ly, wt, w4)]
    with pytest.raises(ValueError):
        quad_sample_reduce_raw(*meta[:5])
    with pytest.raises(ValueError):
        quad_sample_reduce_w4(meta[0], meta[1], meta[5])
    with pytest.raises(ValueError):
        flash_attention(*(table[None, :8, :32].to("meta"),) * 3)
    with pytest.raises(ValueError):
        quad_sample_reduce_mmajor(meta[0], *(t.to("meta") for t in
                                             (idx_m, lx_m, ly_m, wt_m)))
    with pytest.raises(ValueError):
        scatter_add_rows_weighted(meta[1], g.to("meta"), meta[5], 50)
    with pytest.raises(ValueError):
        scatter_add_rows_weighted_dw4(meta[1], g.to("meta"), meta[5],
                                      meta[0], False)
    with pytest.raises(ValueError):
        scatter_add_rows_pmajor(meta[1], table[:20].to("meta"), 50)
    with pytest.raises(ValueError):
        instance_sample_reduce([t.to("meta") for t in tables],
                               INSTANCE_SHAPES,
                               *(t.to("meta") for t in taps), 2)
    with pytest.raises(IndexError):
        quad_sample_reduce_w4(table, idx + 50, w4)
    with pytest.raises(IndexError):
        quad_sample_reduce_mmajor(table, idx_m + 50, lx_m, ly_m, wt_m)
    with pytest.raises(IndexError):
        scatter_add_rows_weighted(idx, g, w4, 49)
    with pytest.raises(IndexError):
        scatter_add_rows(idx.reshape(-1) + 50, table[:20], 50)


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
def test_flash_attention_cuda_matches_plain(cuda, masked, dtype, rtol):
    q, k, v, mask = _flash_case(8, 300, 257, 32, masked, seed=5)
    q, k, v = (torch.from_numpy(a).to(cuda, dtype) for a in (q, k, v))
    mask = None if mask is None else torch.from_numpy(mask).to(cuda)
    got = flash_attention(q, k, v, mask)
    want = flash_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert _rel_err(got.float().cpu().numpy(),
                    want.float().cpu().numpy()) <= rtol


@pytest.mark.gpu
@pytest.mark.parametrize("lq", [1, 65, 300])
@pytest.mark.parametrize("lkv", [1, 17, 64, 65, 300])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
def test_flash_attention_cuda_ragged(cuda, lq, lkv, dtype, rtol):
    """K3 at sequence lengths off every tile (bf16: 64-key tiles, 16-row
    warps, 64-row blocks; f32: 32-row blocks), with a mask whose head 1 is
    fully masked: that head averages its real keys only, none of a ragged
    tile's padding."""
    bh = 3
    q, k, v, mask = _flash_case(bh, lq, lkv, 32, True, seed=lq + lkv)
    mask[1] = NEG_INF
    q, k, v = (torch.from_numpy(a).to(cuda, dtype) for a in (q, k, v))
    mask = torch.from_numpy(mask).to(cuda)
    before = flash_attention.launches
    got = flash_attention(q, k, v, mask)
    want = flash_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (bh, lq, 32)
    assert _rel_err(got.float().cpu().numpy(),
                    want.float().cpu().numpy()) <= rtol
    mean_v = v[1].float().mean(dim=0).expand(lq, 32)
    assert _rel_err(got[1].float().cpu().numpy(),
                    mean_v.cpu().numpy()) <= rtol


@pytest.mark.gpu
@pytest.mark.parametrize("per_tap", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_accum_cuda_matches_plain(cuda, per_tap, dtype):
    """K5 (g shared by the P taps) and K6 (g per tap) at P=196 over a small
    table, so rows repeat many times; float atomics add in no fixed order,
    hence a tolerance."""
    p, m, rows = 196, 2400 + 3, 5000
    rs = np.random.RandomState(11)
    idx = torch.from_numpy(rs.randint(0, rows, (p, m)).astype(np.int32))
    idx[0, :2] = torch.tensor([0, rows - 1], dtype=torch.int32)
    g = torch.from_numpy(rs.randn(p * m if per_tap else m, 32).astype(
        np.float32))
    w4 = torch.from_numpy(rs.rand(p, 4, m).astype(np.float32))
    idx, g, w4 = idx.to(cuda), g.to(cuda, dtype), w4.to(cuda)
    wrapper = (scatter_add_rows_pmajor_weighted if per_tap
               else scatter_add_rows_weighted)
    before = wrapper.launches
    got = wrapper(idx, g, w4, rows)
    want = scatter_accum_plain(idx, g, w4, rows, per_tap)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert _rel_err(got.cpu().numpy(), want.cpu().numpy()) <= RTOL


def _rows_case(case, p, m, rows, rs):
    """idx (P, M) for the row scatter's card tests: random rows with the
    table's first and last; every tap on one row; only the even rows of the
    first half hit (the rest must come out exactly 0); a one-row table."""
    if case == "one_table_row":
        return np.zeros((p, m), np.int32), 1
    if case == "one_row":
        return np.full((p, m), rows - 1, np.int32), rows
    if case == "empty_rows":
        return (2 * rs.randint(0, rows // 4, (p, m))).astype(np.int32), rows
    idx = rs.randint(0, rows, (p, m)).astype(np.int32)
    idx[0, :2] = [0, rows - 1]
    return idx, rows


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random", "one_row", "empty_rows",
                                  "one_table_row"])
@pytest.mark.parametrize("p,m", [(4, 2400 + 3), (16, 1200), (196, 2400 + 3),
                                 (3, 37)])
@pytest.mark.parametrize("pmajor", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_rows_cuda_matches_plain(cuda, case, p, m, pmajor, dtype):
    """K7a (idx (N,)) and K7b (idx (P, M)): taps grouped by row and summed
    once a row. Over a 5000-row table rows repeat (P=196: about 94 taps a
    row, so rows are cut into pieces); every tap on one row (pieces whose
    partials the last one adds); rows no tap hits, which must be exactly 0
    with no zero fill; a one-row table; 111 taps, no multiple of any block.
    The sum of a row follows the placement's order: a tolerance, against
    the plain version's `index_add_` in f64 (in f32 its own rounding over
    471K taps on one row reaches 1.7e-5)."""
    rs = np.random.RandomState(12 + p)
    idx, rows = _rows_case(case, p, m, 5000, rs)
    payload = torch.from_numpy(rs.randn(p * m, 128).astype(np.float32))
    idx, payload = torch.from_numpy(idx).to(cuda), payload.to(cuda, dtype)
    wrapper = scatter_add_rows_pmajor if pmajor else scatter_add_rows
    before = wrapper.launches
    got = wrapper(idx if pmajor else idx.reshape(-1), payload, rows)
    want = torch.zeros((rows, 128), dtype=torch.float64, device=cuda
                       ).index_add_(0, idx.reshape(-1).long(),
                                    payload.double())
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert got.shape == (rows, 128) and got.dtype == torch.float32
    assert _rel_err(got.cpu().numpy(), want.cpu().numpy()) <= RTOL
    hit = torch.zeros(rows, dtype=torch.bool, device=cuda)
    hit[idx.reshape(-1).long()] = True
    assert not got[~hit].any()


@pytest.mark.gpu
def test_scatter_rows_cuda_no_taps(cuda):
    """No taps: every row of the output is written, as zeros."""
    idx = torch.zeros((4, 0), dtype=torch.int32, device=cuda)
    payload = torch.zeros((0, 128), dtype=torch.bfloat16, device=cuda)
    got = scatter_add_rows_pmajor(idx, payload, 700)
    torch.cuda.synchronize()
    assert got.shape == (700, 128) and not got.any()


@pytest.mark.gpu
@pytest.mark.parametrize("p,offset", [(1, 0), (3, 0), (4, 0), (4, 1), (8, 0),
                                      (8, 1), (9, 0), (16, 0), (16, 1),
                                      (196, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quad_sample_reduce_mmajor_cuda_matches_plain(cuda, p, offset,
                                                      dtype):
    """K8: the direct kernel up to 8 taps and the staged one above, in the
    m-major order; P % 4 == 0 with 16-byte aligned idx and weights takes
    16-byte loads of 4 taps, and offset=1 (the inputs 4 bytes past a
    16-byte boundary) the 4-byte ones. M not a multiple of any tile, taps
    on the table's first and last rows."""
    m, rows = 2400 + 3, 5000
    table, idx, lx, ly, wt = (torch.from_numpy(a) for a in
                              _mmajor_case(p, m, rows, seed=9 + p))
    idx[0, 0], idx[-1, -1] = 0, rows - 1

    def on_card(t):
        buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=cuda)
        out = buf[offset:].view(t.shape)
        out.copy_(t)
        return out

    table = table.to(cuda, dtype)
    idx, lx, ly, wt = (on_card(t) for t in (idx, lx, ly, wt))
    before = quad_sample_reduce_mmajor.launches
    got = quad_sample_reduce_mmajor(table, idx, lx, ly, wt)
    want = quad_sample_reduce_mmajor_plain(table, idx, lx, ly, wt)
    torch.cuda.synchronize()
    assert quad_sample_reduce_mmajor.launches == before + 1
    assert got.shape == (m, 32)
    assert _rel_err(got.cpu().numpy(), want.cpu().numpy()) <= RTOL


@pytest.mark.gpu
def test_quad_sample_reduce_mmajor_cuda_rejects_misaligned_table(cuda):
    """The table's rows are read in 16-byte vectors: a table 2 bytes past
    a 16-byte boundary raises before any launch."""
    table, idx, lx, ly, wt = (torch.from_numpy(a).to(cuda) for a in
                              _mmajor_case(4, 100, 50, seed=3))
    buf = torch.empty(table.numel() + 1, dtype=torch.bfloat16, device=cuda)
    shifted = buf[1:].view(table.shape)
    before = quad_sample_reduce_mmajor.launches
    with pytest.raises(ValueError, match="16-byte"):
        quad_sample_reduce_mmajor(shifted, idx, lx, ly, wt)
    assert quad_sample_reduce_mmajor.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("p", [1, 3, 4, 9, 196])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quad_sample_reduce_w4_cuda_matches_plain(cuda, p, dtype):
    """K2: one group of lanes per output at P <= 8 and four above, P not a
    multiple of the unroll or the staged chunk, M not a multiple of any
    tile, taps on the table's first and last rows."""
    m, rows = 2400 + 3, 5000
    table, idx, _, _, _, w4 = (torch.from_numpy(a) for a in
                               _quad_case(p, m, rows, seed=20 + p))
    idx[0, :2] = torch.tensor([0, rows - 1], dtype=torch.int32)
    idx[-1, -2:] = torch.tensor([rows - 1, 0], dtype=torch.int32)
    table, idx, w4 = table.to(cuda, dtype), idx.to(cuda), w4.to(cuda)
    before = quad_sample_reduce_w4.launches
    got = quad_sample_reduce_w4(table, idx, w4)
    want = quad_sample_reduce_plain(table, idx, w4=w4)
    torch.cuda.synchronize()
    assert quad_sample_reduce_w4.launches == before + 1
    assert got.shape == (m, 32)
    assert _rel_err(got.cpu().numpy(), want.cpu().numpy()) <= RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("p", [1, 3, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quad_sample_reduce_raw_cuda_matches_plain(cuda, p, dtype):
    """K1: the direct kernel in its raw mode, P not a multiple of the 2 taps
    in flight, M not a multiple of the block's outputs, taps on the table's
    first and last rows."""
    m, rows = 2400 + 3, 5000
    table, idx, lx, ly, wt, _ = (torch.from_numpy(a) for a in
                                 _quad_case(p, m, rows, seed=30 + p))
    idx[0, :2] = torch.tensor([0, rows - 1], dtype=torch.int32)
    idx[-1, -2:] = torch.tensor([rows - 1, 0], dtype=torch.int32)
    table = table.to(cuda, dtype)
    idx, lx, ly, wt = (t.to(cuda) for t in (idx, lx, ly, wt))
    before = quad_sample_reduce_raw.launches
    got = quad_sample_reduce_raw(table, idx, lx, ly, wt)
    want = quad_sample_reduce_plain(table, idx, lx=lx, ly=ly, wt=wt)
    torch.cuda.synchronize()
    assert quad_sample_reduce_raw.launches == before + 1
    assert got.shape == (m, 32)
    assert _rel_err(got.cpu().numpy(), want.cpu().numpy()) <= RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("per_tap,p,m,one_row", [
    (False, 4, 2400 + 3, False), (True, 196, 2400 + 3, False),
    (False, 4, 503, True), (True, 3, 503, True)])
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
def test_scatter_dw4_cuda_matches_plain(cuda, per_tap, p, m, one_row,
                                        g_dtype, table_dtype):
    """The fused K5/K6 (d_table and d_w4 from one launch) against their
    plain version, M not a multiple of the 32-output tile, P not a multiple
    of the 4-tap tile; with one_row every tap lands on one table row (the
    reductions contend there). Each output alone when the other is not
    wanted."""
    rows = 5000
    rs = np.random.RandomState(13 + p)
    idx = torch.from_numpy(rs.randint(0, rows, (p, m)).astype(np.int32))
    idx[0, :2] = torch.tensor([0, rows - 1], dtype=torch.int32)
    if one_row:
        idx[:] = rows - 1
    g = torch.from_numpy(rs.randn(p * m if per_tap else m, 32).astype(
        np.float32))
    w4 = torch.from_numpy(rs.rand(p, 4, m).astype(np.float32))
    table = torch.from_numpy(rs.randn(rows, 128).astype(np.float32))
    idx, g, w4 = idx.to(cuda), g.to(cuda, g_dtype), w4.to(cuda)
    table = table.to(cuda, table_dtype)
    counter = (scatter_add_rows_pmajor_weighted if per_tap
               else scatter_add_rows_weighted)
    before = counter.launches
    got = scatter_add_rows_weighted_dw4(idx, g, w4, table, per_tap)
    only_table = scatter_add_rows_weighted_dw4(idx, g, w4, table, per_tap,
                                               want_dw4=False)
    only_w4 = scatter_add_rows_weighted_dw4(idx, g, w4, table, per_tap,
                                            want_table=False)
    want = scatter_accum_dw4_plain(idx, g, w4, table, per_tap)
    torch.cuda.synchronize()
    assert counter.launches == before + 3
    assert only_table[1] is None and only_w4[0] is None
    for a, b in ((got[0], want[0]), (got[1], want[1]),
                 (only_table[0], want[0]), (only_w4[1], want[1])):
        assert _rel_err(a.cpu().numpy(), b.cpu().numpy()) <= RTOL


# BoxeR-3D's encoder sampling level at 468x468: 8 heads x 68,445 queries,
# P=4 taps, on level 0's 8 x 235 x 235 quad table (encoder level 234x234)
M_3D, ROWS_3D = 8 * 68445, 8 * 235 * 235


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quad_sample_reduce_w4_cuda_boxer3d_shape(cuda, dtype):
    """K2 at P=4, M=547,560 on the 441,800-row table, taps on its first and
    last rows."""
    rs = np.random.RandomState(50)
    idx = torch.from_numpy(rs.randint(0, ROWS_3D, (4, M_3D)).astype(np.int32))
    idx[0, :2] = torch.tensor([0, ROWS_3D - 1], dtype=torch.int32)
    w4 = torch.from_numpy(rs.rand(4, 4, M_3D).astype(np.float32)).to(cuda)
    table = torch.from_numpy(rs.randn(ROWS_3D, 128).astype(np.float32)).to(
        cuda, dtype)
    idx = idx.to(cuda)
    got = quad_sample_reduce_w4(table, idx, w4)
    want = quad_sample_reduce_plain(table, idx, w4=w4)
    torch.cuda.synchronize()
    assert got.shape == (M_3D, 32)
    assert _rel_err(got.cpu().numpy(), want.cpu().numpy()) <= RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
def test_scatter_dw4_cuda_boxer3d_shape(cuda, g_dtype):
    """The fused K5 (d_table and d_w4) at P=4, M=547,560 on the 441,800-row
    bf16 table, taps on its first and last rows."""
    rs = np.random.RandomState(51)
    idx = torch.from_numpy(rs.randint(0, ROWS_3D, (4, M_3D)).astype(np.int32))
    idx[0, :2] = torch.tensor([0, ROWS_3D - 1], dtype=torch.int32)
    g = torch.from_numpy(rs.randn(M_3D, 32).astype(np.float32)).to(
        cuda, g_dtype)
    w4 = torch.from_numpy(rs.rand(4, 4, M_3D).astype(np.float32)).to(cuda)
    table = torch.from_numpy(rs.randn(ROWS_3D, 128).astype(np.float32)).to(
        cuda, torch.bfloat16)
    idx = idx.to(cuda)
    before = scatter_add_rows_weighted.launches
    got = scatter_add_rows_weighted_dw4(idx, g, w4, table, False)
    want = scatter_accum_dw4_plain(idx, g, w4, table, False)
    torch.cuda.synchronize()
    assert scatter_add_rows_weighted.launches == before + 1
    assert got[0].shape == (ROWS_3D, 128) and got[1].shape == (4, 4, M_3D)
    for a, b in zip(got, want):
        assert _rel_err(a.cpu().numpy(), b.cpu().numpy()) <= RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("with_rotation", [False, True],
                         ids=["encoder", "decoder"])
def test_box3d_attention_cuda_grads_match_plain_k5(cuda, monkeypatch,
                                                   with_rotation):
    """`Box3dAttention`'s gradients on the card (forward K2, backward the
    fused K5) against the same module with K5 swapped for its plain
    version: every parameter, and the query, the value and the reference
    windows, whose gradient runs through the grid's rotation by each
    window's angle (rel 1e-4: f32 atomics add in another order)."""
    from boxer_tpu_torch.nn.attention import Box3dAttention
    ba = importlib.import_module("boxer_tpu_torch.ops.box_attention")

    shapes, nh, d, lq = ((40, 48), (20, 24)), 8, 256, 500
    rs = np.random.RandomState(52)
    torch.manual_seed(0)
    attn = Box3dAttention(d, len(shapes), nh, with_rotation).to(cuda)
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(torch.from_numpy(rs.randn(*p.shape).astype(np.float32)
                                     / np.sqrt(p.shape[-1])))
    query = rs.randn(1, lq, d).astype(np.float32)
    value = rs.randn(1, sum(h * w for h, w in shapes), d).astype(np.float32)
    ref_shape = (1, lq) if with_rotation else (1, lq, nh)
    ref = np.concatenate([rs.uniform(0.1, 0.9, ref_shape + (2,)),
                          rs.uniform(0.05, 0.2, ref_shape + (2,)),
                          rs.rand(*ref_shape, 1)], -1).astype(np.float32)
    cot = torch.from_numpy(rs.randn(1, lq, d).astype(np.float32)).to(cuda)

    def grads():
        attn.zero_grad()
        q, v, r = (torch.from_numpy(a).to(cuda).requires_grad_()
                   for a in (query, value, ref))
        out, _ = attn(q, v, shapes, None, None, r)
        (out * cot).sum().backward()
        torch.cuda.synchronize()
        return [q.grad, v.grad, r.grad] + [p.grad.clone()
                                           for p in attn.parameters()]

    before = scatter_add_rows_weighted.launches
    got = grads()
    assert scatter_add_rows_weighted.launches == before + len(shapes)
    monkeypatch.setattr(ba, "scatter_add_rows_weighted_dw4",
                        scatter_accum_dw4_plain)
    want = grads()
    assert scatter_add_rows_weighted.launches == before + len(shapes)
    for g, w in zip(got, want):
        assert float(w.abs().max()) > 0
        assert _rel_err(g.cpu().numpy(), w.cpu().numpy()) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("b,nh,k,nl,lq", [
    (b, nh, k, 4, 37) for b in (1, 2) for nh in (1, 2) for k in (2, 14)] + [
    (2, 4, 14, 4, 37), (2, 4, 14, 3, 37), (1, 2, 14, 1, 37),
    (2, 3, 2, 2, 1), (2, 3, 4, 4, 7), (1, 8, 14, 4, 301),
    (2, 1, 14, 3, 301), (2, 8, 2, 1, 37), (2, 3, 14, 2, 7),
    (1, 1, 4, 4, 301), (2, 8, 4, 4, 1), (8, 8, 2, 4, 600)])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, RTOL),
                                        (torch.bfloat16, 1e-2)])
def test_instance_sample_cuda_matches_plain(cuda, b, nh, k, nl, lq, dtype,
                                            rtol):
    """K4 against its plain version, both outputs: taps on, just inside
    and past the borders and on the cells' edges, 1 to 4 levels, P 4, 16
    and 196, H 1 to 8, LQ 1, 7, 37, 301 and 600 (all but the last not a
    multiple of the 8-query tile: the last tile ragged, or the only one),
    and clusters of 1 to 8 blocks, as the card's rule gives them."""
    shapes = INSTANCE_SHAPES[:nl]
    tables, taps = instance_inputs(
        instance_case(b, nh, k, shapes, lq, seed=30 + 8 * b + nh + k + nl
                      + (lq if lq != 37 else 0)),
        shapes, cuda, dtype)
    splits = instance_sample.launch_tile(cuda, dtype, b, nh, lq)[2]
    assert 1 <= splits <= 8
    before = instance_sample_reduce.launches
    got = instance_sample_reduce(tables, shapes, *taps, k)
    want = instance_sample_reduce_plain(tables, shapes, *taps, k)
    torch.cuda.synchronize()
    assert instance_sample_reduce.launches == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == dtype
        assert _rel_err(g.float().cpu().numpy(),
                        w.float().cpu().numpy()) <= rtol


@pytest.mark.gpu
@pytest.mark.parametrize("shapes,b,nh,lq", [(SEGM_SHAPES, 1, 8, 300),
                                            (INSTANCE_SHAPES, 2, 3, 37)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_instance_sample_cuda_bitwise(cuda, shapes, b, nh, lq, dtype):
    """Two launches of K4 on the same inputs give bitwise-equal outputs:
    `out` is summed over the item groups in a fixed order, no atomics."""
    tables, taps = instance_inputs(
        instance_case(b, nh, 14, shapes, lq, seed=70 + lq), shapes, cuda,
        dtype)
    first = instance_sample_reduce(tables, shapes, *taps, 14)
    again = instance_sample_reduce(tables, shapes, *taps, 14)
    torch.cuda.synchronize()
    assert float(first[0].float().abs().max()) > 0
    assert all(torch.equal(x, y) for x, y in zip(first, again))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, RTOL),
                                        (torch.bfloat16, 1e-2)])
def test_instance_sample_cuda_segm_shape(cuda, dtype, rtol):
    """K4 at the segm forward's shape: B 1, H 8, LQ 300, k 14, the four
    levels of an 800x1216 canvas."""
    tables, taps = instance_inputs(
        instance_case(1, 8, 14, SEGM_SHAPES, 300, seed=40), SEGM_SHAPES, cuda,
        dtype)
    got = instance_sample_reduce(tables, SEGM_SHAPES, *taps, 14)
    want = instance_sample_reduce_plain(tables, SEGM_SHAPES, *taps, 14)
    torch.cuda.synchronize()
    assert got[0].shape == (1, 8, 300, 32)
    assert got[1].shape == (1, 300, 14, 14, 256)
    for g, w in zip(got, want):
        assert _rel_err(g.float().cpu().numpy(),
                        w.float().cpu().numpy()) <= rtol


@pytest.mark.gpu
def test_instance_attention_cuda_gradient_takes_quad_sample(cuda):
    """On the card a call that needs a gradient runs `QuadSample` (K2 a
    level, K6 in the backward) and not K4: its outputs carry a grad_fn and
    its gradients equal the same call's on the CPU (K6 sums in another
    order: 1e-5); the same call without grad mode launches K4 once and
    returns outputs without one."""
    ba = importlib.import_module("boxer_tpu_torch.ops.box_attention")
    case = instance_case(1, 2, 14, INSTANCE_SHAPES, 20, seed=50)
    rs = np.random.RandomState(51)
    cot = [torch.from_numpy(rs.randn(*s).astype(np.float32)).to(cuda)
           for s in ((1, 2, 20, 32), (1, 20, 14, 14, 64))]

    def run(device, grad=True):
        ts = [torch.from_numpy(a).to(device).requires_grad_() for a in case]
        with torch.set_grad_enabled(grad):
            outs = ba.instance_attention_qminor(ts[0], INSTANCE_SHAPES,
                                                *ts[1:], 14, raw=True)
        return ts, outs

    k4, k2 = instance_sample_reduce.launches, quad_sample_reduce_w4.launches
    grads = []
    for device in (cuda, "cpu"):
        ts, outs = run(device)
        assert all(o.grad_fn is not None for o in outs)
        sum((o * c.to(device)).sum() for o, c in zip(outs, cot)).backward()
        torch.cuda.synchronize()
        grads.append([t.grad.cpu() for t in ts])
    assert instance_sample_reduce.launches == k4
    assert quad_sample_reduce_w4.launches == k2 + len(INSTANCE_SHAPES)
    for g, w in zip(*grads):
        assert float(w.abs().max()) > 0
        assert _rel_err(g.numpy(), w.numpy()) <= RTOL
    _, outs = run(cuda, grad=False)
    assert all(o.grad_fn is None for o in outs)
    assert instance_sample_reduce.launches == k4 + 1
