"""The port's assignment solver (H1, `boxer_tpu_torch/ops/hungarian.py`) and
the matcher's `hungarian` built on it, against scipy and the JAX package.

- `solve_assignment_plain` with a row count per problem (none, some and all
  rows) equals scipy's `linear_sum_assignment` on each problem's first
  n_rows rows; a CPU tensor launches no kernel.
- `hungarian`, its columns pruned to the union of every row's NT cheapest
  when NQ > 4*NT (K = NT, the padded target count, as JAX prunes), equals
  JAX's `hungarian` and scipy on the valid rows at a Waymo-like shape (25
  padded targets, 3,000 queries, 5-20 valid: a (25, 625) problem) and a
  2D-encoder-like one; one jitted JAX solve a shape.
- The encoder head's binary-label match, NEG_INF-masked proposals with
  zero boxes (as `test_torch_matcher_losses.py` builds them), equals JAX's
  with more valid targets than live proposals, so some rows take one of
  the masked proposals, which tie.
- The kernel's order of steps (`csrc/hungarian.cu`: the previous step's
  `minv - delta` taken as the next sweep reads a column, the dual update
  over the search's path of used columns, a column joining the path once,
  the first step of a row resetting minv, way and used), modelled in numpy
  in f32, equals the plain version bit for bit, ties and BIG columns
  included, and with more rows than finite columns, where a step's argmin
  lands on a column already used.

The cases marked `gpu` hold the CUDA kernel to its plain version on the
shipped matching shapes and run `hungarian` on CUDA tensors under
`torch.cuda.set_sync_debug_mode("error")`; they skip without a card. jax is
imported only inside the JAX cases, so on a card without jax they run with
`python -m pytest --noconftest -p no:cacheprovider -m gpu
tests/test_torch_hungarian.py`.
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget)
import functools

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from boxer_tpu_torch.nn.matcher import (HungarianMatcher, assignment_problem,
                                        hungarian)
from boxer_tpu_torch.ops.hungarian import (solve_assignment,
                                           solve_assignment_plain)


def _scipy_col4row(cost):
    rows, cols = linear_sum_assignment(cost)
    out = np.empty(cost.shape[0], np.int64)
    out[rows] = cols
    return out


@functools.lru_cache(maxsize=None)
def _jax_hungarian():
    import jax

    from boxer_tpu.nn.matcher import hungarian as j_hungarian

    return jax.jit(j_hungarian)


@pytest.mark.parametrize("n,m", [(1, 1), (6, 6), (12, 40), (30, 90)])
def test_plain_solver_matches_scipy_per_row_count(n, m):
    rs = np.random.RandomState(n * 100 + m)
    counts = np.array([0, 1, n // 2, n, n])
    cost = (rs.randn(len(counts), n, m) * 10).astype(np.float32)
    cost[-1] = np.round(cost[-1])           # integer costs: ties
    launches = solve_assignment.launches
    col = solve_assignment(torch.from_numpy(cost),
                           torch.from_numpy(counts.astype(np.int32)))
    assert solve_assignment.launches == launches
    assert col.dtype == torch.long and tuple(col.shape) == (len(counts), n)
    col = col.numpy()
    for b, k in enumerate(counts):
        np.testing.assert_array_equal(col[b, k:], 0)
        if k == 0:
            continue
        assert len(set(col[b, :k].tolist())) == k
        want = _scipy_col4row(cost[b, :k])
        if b == len(counts) - 1:             # ties: the optimal total
            assert cost[b, np.arange(k), col[b, :k]].sum() == \
                cost[b, np.arange(k), want].sum()
        else:
            np.testing.assert_array_equal(col[b, :k], want)
    _, steps = solve_assignment_plain(
        torch.from_numpy(cost), torch.from_numpy(counts.astype(np.int32)),
        count_steps=True)
    assert steps[0] == 0 and (steps[1:] >= torch.from_numpy(counts[1:])).all()


def _precedes(av, aj, bv, bj):
    """argmin's order: a NaN first, then the smaller value, then the lower
    index among equals."""
    an, bn = np.isnan(av), np.isnan(bv)
    if an or bn:
        return an and (not bn or aj < bj)
    return av < bv or (av == bv and aj < bj)


def _order_key(v):
    """csrc/hungarian.cu:order_key, argmin's order as an unsigned key."""
    if np.isnan(v):
        return 0
    b = int(np.float32(0.0 if v == 0 else v).view(np.uint32))
    return (~b & 0xFFFFFFFF) if b & 0x80000000 else b | 0x80000000


def _warp_reduce(cands):
    """The kernel's warp minimum over 32 lanes, (value, column, p, used,
    way) a lane, the lanes past the candidates empty: the least key, then
    the least column among it (two `redux.sync`)."""
    lanes = list(cands) + [(np.float32(np.inf), INT_MAX, -1, True, 0)] * (
        32 - len(cands))
    kmin = min(_order_key(c[0]) for c in lanes)
    jmin = min(c[1] for c in lanes if _order_key(c[0]) == kmin)
    return next(c for c in lanes if _order_key(c[0]) == kmin
                and c[1] == jmin)


INT_MAX = 2 ** 31 - 1


def _kernel_model(cost, rows, clusters=1):
    """One problem as `hungarian_kernel` orders its steps, in f32, on a
    cluster of `clusters` blocks: block k sweeps its slice of the columns
    alone (1 + k*S .. (k+1)*S, S = ceil(m / C); a slice may be empty) to
    its first minimum, which it hands on with that column's p, used and
    way; the C candidates are reduced as a warp reduces them. u and the
    path (each column with the row it held and its way when it joined)
    are replicated; the v of a path column is updated by its owner, the
    unused columns' minv - delta by the next sweep; the augmenting walk
    follows the path's ways, not the columns' state."""
    big = np.float32(1e9)
    n, m = cost.shape
    s = -(-m // clusters)
    slices = [range(1 + k * s, min(m + 1, 1 + (k + 1) * s))
              for k in range(clusters)]
    v, minv = np.zeros(m + 1, np.float32), np.zeros(m + 1, np.float32)
    p, way = np.full(m + 1, -1), np.zeros(m + 1, np.int64)
    used, u = np.zeros(m + 1, bool), np.zeros(n, np.float32)
    for i in range(rows):
        j0, i0, w0, path, delta = 0, i, 0, [], np.float32(0)
        first = fresh = True
        while True:
            if fresh:
                path.append((j0, i0, w0))
            cands = []
            for cols in slices:
                best, bj = np.float32(np.inf), INT_MAX
                for j in cols:
                    was = not first and used[j]
                    mv = big if first else minv[j]
                    if not first and not was:
                        mv = np.float32(mv - delta)
                    now = was or j == j0
                    cur = big if now else np.float32(
                        np.float32(cost[i0, j - 1] - u[i0]) - v[j])
                    if cur < mv:
                        mv, way[j] = cur, j0
                    elif first:
                        way[j] = 0
                    minv[j] = mv
                    if first or j == j0:
                        used[j] = now
                    masked = big if now else mv
                    if _precedes(masked, j, best, bj):
                        best, bj = masked, j
                cands.append((best, bj, -1, True, 0) if bj == INT_MAX
                             else (best, bj, p[bj], used[bj], way[bj]))
            delta, j1, p1, used1, w1 = _warp_reduce(cands)
            for col, r, _ in path:
                u[r] = np.float32(u[r] + delta)
                for cols in slices:              # the owner's update
                    if col in cols:
                        v[col] = np.float32(v[col] - delta)
            j0, i0, w0, fresh, first = j1, p1, w1, not used1, False
            if p1 == -1:
                break
        entry = {col: (r, w) for col, r, w in path}
        j, w = j0, w0
        while j != 0:
            r, nxt = entry[w]
            p[j], j, w = r, w, nxt
    out = np.zeros(n, np.int64)
    out[p[1:][p[1:] >= 0]] = np.nonzero(p[1:] >= 0)[0]
    return out


# C = 1 (one block a problem) under the cases' first names; 2, 3 (a slice
# boundary off a power of two), 8 and 16 (slices of a column or two, some
# empty) as "<seed>-C<C>"
CLUSTERS = (1, 2, 3, 8, 16)
STEP_CASES = [pytest.param(seed, 1, id=str(seed)) for seed in range(4)] + [
    pytest.param(seed, c, id=f"{seed}-C{c}")
    for c in CLUSTERS[1:] for seed in range(4)]


@pytest.mark.parametrize("seed,clusters", STEP_CASES)
def test_kernel_step_order_matches_plain(seed, clusters):
    rs = np.random.RandomState(seed)
    for _ in range(5):
        n = rs.randint(1, 10)
        m = rs.randint(n, 30)
        cost = (rs.randn(3, n, m) * 10).astype(np.float32)
        if seed % 2:
            cost = np.round(cost)                       # ties
            s = -(-m // clusters)
            for k in range(1, clusters):                # across a boundary
                if k * s < m:
                    cost[:, :, k * s] = cost[:, :, k * s - 1]
        cost[:, :, rs.rand(m) < 0.3] = 1e9              # BIG columns
        counts = rs.randint(0, n + 1, 3)
        counts[seed % 3] = 0
        want = solve_assignment_plain(torch.from_numpy(cost),
                                      torch.from_numpy(counts)).numpy()
        for b in range(3):
            np.testing.assert_array_equal(
                _kernel_model(cost[b], counts[b], clusters), want[b])


def _few_finite_columns(rs, nb, n, m, finite, last=False):
    """Costs whose first finite[b] columns (with last: the last finite[b])
    are finite and the rest above BIG: once the finite columns are taken,
    every unused column's minv sits at BIG, so a step's argmin lands on a
    used column (the lowest index)."""
    cost = (rs.rand(nb, n, m) * 10).astype(np.float32)
    for b, k in enumerate(finite):
        big = rs.uniform(1.5e9, 3.5e9, (n, m - k))
        if last:
            cost[b, :, :m - k] = big
        else:
            cost[b, :, k:] = big
    return cost


def test_kernel_step_order_with_more_rows_than_finite_columns():
    rs = np.random.RandomState(5)
    for trial in range(6):
        n = rs.randint(3, 9)
        m = rs.randint(n, 16)
        finite = rs.randint(1, n, 3)
        cost = _few_finite_columns(rs, 3, n, m, finite, last=trial % 2)
        counts = np.array([n, n, rs.randint(1, n + 1)])
        want = solve_assignment_plain(torch.from_numpy(cost),
                                      torch.from_numpy(counts)).numpy()
        for b in range(3):
            assert len(set(want[b, :counts[b]].tolist())) == counts[b]
            for clusters in CLUSTERS:
                np.testing.assert_array_equal(
                    _kernel_model(cost[b], counts[b], clusters), want[b])


def test_cluster_rule():
    """The wrapper's fixed rule: one block up to 2,048 columns, then the
    smallest C (at most 16) whose slice is at most 640 columns."""
    from boxer_tpu_torch.ops.hungarian import cluster_size

    assert [cluster_size(m) for m in (1, 300, 2048, 2049, 2560, 2561,
                                      10_000, 10_240, 62_500, 10 ** 6)] == \
        [1, 1, 1, 4, 4, 5, 16, 16, 16, 16]
    for clusters in (0, 17):
        with pytest.raises(ValueError):
            solve_assignment(torch.zeros(1, 2, 4),
                             torch.ones(1, dtype=torch.int32), clusters)


def test_solver_refuses_bad_shapes():
    with pytest.raises(ValueError):
        solve_assignment(torch.zeros(1, 5, 4), torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        solve_assignment(torch.zeros(1, 2, 4, device="meta"),
                         torch.ones(1, dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("nt,nq,lo,hi,seed", [
    (25, 3000, 5, 20, 0), (25, 3000, 5, 20, 1),     # Waymo-like
    (10, 2000, 1, 10, 2), (10, 2000, 1, 10, 3)])    # 2D-encoder-like
def test_pruned_hungarian_matches_jax_and_scipy(nt, nq, lo, hi, seed):
    rs = np.random.RandomState(seed)
    b = 3
    cost = (rs.randn(b, nt, nq) * 10).astype(np.float32)
    valid = np.arange(nt)[None, :] < rs.randint(lo, hi + 1, (b, 1))
    valid[-1] = rs.rand(nt) < 0.5           # valid rows among the padding
    sub, n_rows, _, cand = assignment_problem(torch.from_numpy(cost),
                                              torch.from_numpy(valid))
    assert tuple(sub.shape) == (b, nt, nt * nt) and cand is not None
    np.testing.assert_array_equal(n_rows.numpy(), valid.sum(1))
    got = hungarian(torch.from_numpy(cost), torch.from_numpy(valid)).numpy()
    want = np.asarray(_jax_hungarian()(cost, valid))
    assert ((got >= 0) & (got < nq)).all()
    for i in range(b):
        v = valid[i]
        np.testing.assert_array_equal(got[i, v], want[i, v])
        np.testing.assert_array_equal(got[i, v], _scipy_col4row(cost[i, v]))


def test_encoder_binary_match_with_masked_ties_matches_jax():
    from test_torch_matcher_losses import _outputs, _targets, _tree

    import jax.numpy as jnp

    from boxer_tpu.nn.matcher import HungarianMatcher as JMatcher

    rs = np.random.RandomState(4)
    b, ns, nt = 2, 240, 20
    masked = np.ones((b, ns), bool)
    live = np.stack([rs.choice(ns, 6, replace=False) for _ in range(b)])
    masked[np.arange(b)[:, None], live] = False
    out = _outputs(rs, b, ns, 1, masked=masked)
    tgt = _targets(rs, b, nt, 1)
    tgt["valid"][:, :12] = True             # more targets than live queries
    tgt["labels"][:] = 0
    got, _ = HungarianMatcher(2, 5, 2)(_tree(out, torch.from_numpy),
                                       _tree(tgt, torch.from_numpy))
    want, _ = JMatcher(2, 5, 2, focal_label=True)(_tree(out, jnp.asarray),
                                                  _tree(tgt, jnp.asarray))
    v = tgt["valid"]
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(got[v], want[v])
    taken = masked[np.arange(b)[:, None], got] & v
    assert taken.sum() >= 2 * (12 - 6)      # rows on tied masked proposals


# the shipped matching calls: (problems, padded targets, columns, valid
# targets); the 2D decoder's 6 layers of a microbatch of 2, the 2D
# encoder's pruned 100 x 10,000, the Waymo decoder's 2 layers of a batch of
# 2 and its encoder's pruned 250 x 62,500
SHIPPED = {"2D decoder": (12, 100, 300, (1, 60)),
           "2D encoder": (2, 100, 10_000, (1, 60)),
           "Waymo decoder": (4, 250, 300, (20, 70)),
           "Waymo encoder": (2, 250, 62_500, (20, 70))}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


# the cluster sizes the card tests force at every shape (None: the rule's)
CARD_CLUSTERS = (None, 1, 2, 4, 8, 16)


def _equal_at_every_cluster_size(cost, n_rows):
    """The kernel at every C of CARD_CLUSTERS equals the plain version; a
    C the card cannot hold (16 is non-portable) raises. Returns the C
    that ran."""
    from boxer_tpu_torch.ops.hungarian import max_active_clusters

    want = solve_assignment_plain(cost, n_rows)
    ran = []
    for clusters in CARD_CLUSTERS:
        _, n, m = cost.shape
        if clusters and not max_active_clusters(cost.device, n, m, clusters):
            with pytest.raises(RuntimeError):
                solve_assignment(cost, n_rows, clusters)
            continue
        got = solve_assignment(cost, n_rows, clusters)
        torch.cuda.synchronize()
        assert torch.equal(got, want), clusters
        ran.append(clusters)
    assert ran[:5] == [None, 1, 2, 4, 8]
    return want


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(SHIPPED))
def test_kernel_matches_plain_on_shipped_shapes(cuda, shape):
    nb, n, m, (lo, hi) = SHIPPED[shape]
    rs = np.random.RandomState(len(shape))
    cost = torch.from_numpy(rs.rand(nb, n, m).astype(np.float32)).to(cuda)
    counts = rs.randint(lo, hi + 1, nb)
    counts[0] = 0
    n_rows = torch.from_numpy(counts.astype(np.int32)).to(cuda)
    want = _equal_at_every_cluster_size(cost, n_rows)
    got = solve_assignment(cost, n_rows)
    rows = torch.arange(n, device=cuda)
    for b, k in enumerate(counts):
        assert (got[b, k:] == 0).all()
        total = cost[b, rows[:k], got[b, :k]].double().sum()
        assert total == cost[b, rows[:k], want[b, :k]].double().sum()


@pytest.mark.gpu
@pytest.mark.parametrize("m", [300, 10_000])
def test_kernel_matches_plain_with_ties_across_slices(cuda, m):
    """Integer costs, each slice boundary's two columns equal, BIG columns,
    a problem of 0 rows."""
    rs = np.random.RandomState(m)
    cost = np.round(rs.randn(4, 60, m) * 3).astype(np.float32)
    for c in (2, 4, 8, 16):
        s = -(-m // c)
        cost[:, :, s:m:s] = cost[:, :, s - 1:m - 1:s]
    cost[:, :, rs.rand(m) < 0.2] = 1e9
    n_rows = torch.from_numpy(np.array([60, 0, 31, 60], np.int32)).to(cuda)
    _equal_at_every_cluster_size(torch.from_numpy(cost).to(cuda), n_rows)


@pytest.mark.gpu
@pytest.mark.parametrize("last", [False, True])
def test_kernel_matches_plain_with_more_rows_than_finite_columns(cuda, last):
    """With last, the finite columns all lie in the last block's slice."""
    rs = np.random.RandomState(6)
    finite = np.array([1, 5, 20, 49, 10, 30])
    cost = torch.from_numpy(_few_finite_columns(rs, 6, 50, 300, finite,
                                                last))
    n_rows = torch.from_numpy(np.array([50, 50, 50, 50, 25, 40], np.int32))
    _equal_at_every_cluster_size(cost.to(cuda), n_rows.to(cuda))


@pytest.mark.gpu
def test_hungarian_on_cuda_makes_no_host_sync(cuda):
    rs = np.random.RandomState(3)
    cost = (rs.randn(2, 50, 3000) * 10).astype(np.float32)
    valid = rs.rand(2, 50) < 0.4
    want = hungarian(torch.from_numpy(cost), torch.from_numpy(valid))
    c, v = torch.from_numpy(cost).to(cuda), torch.from_numpy(valid).to(cuda)
    torch.cuda.synchronize()
    launches = solve_assignment.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = hungarian(c, v)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert solve_assignment.launches == launches + 1
    assert torch.equal(got.cpu()[torch.from_numpy(valid)],
                       want[torch.from_numpy(valid)])
