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


def _kernel_model(cost, rows):
    """One problem as `hungarian_kernel` orders its steps, in f32."""
    big = np.float32(1e9)
    n, m = cost.shape
    v, minv = np.zeros(m + 1, np.float32), np.zeros(m + 1, np.float32)
    p, way = np.full(m + 1, -1), np.zeros(m + 1, np.int64)
    used, u = np.zeros(m + 1, bool), np.zeros(n, np.float32)
    for i in range(rows):
        p[0], j0, path, delta, first = i, 0, [], np.float32(0), True
        while True:
            if first or not used[j0]:
                path.append(j0)
            i0 = i if first else p[j0]
            best, j1 = np.float32(np.inf), 0
            for j in range(1, m + 1):
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
                if masked < best:
                    best, j1 = masked, j
            delta = best
            for col in path:
                r = i if col == 0 else p[col]
                u[r], v[col] = np.float32(u[r] + delta), np.float32(v[col]
                                                                   - delta)
            j0, first = j1, False
            if p[j1] == -1:
                break
        while j0 != 0:
            p[j0], j0 = p[way[j0]], way[j0]
    out = np.zeros(n, np.int64)
    out[p[1:][p[1:] >= 0]] = np.nonzero(p[1:] >= 0)[0]
    return out


@pytest.mark.parametrize("seed", range(4))
def test_kernel_step_order_matches_plain(seed):
    rs = np.random.RandomState(seed)
    for _ in range(5):
        n = rs.randint(1, 10)
        m = rs.randint(n, 30)
        cost = (rs.randn(3, n, m) * 10).astype(np.float32)
        if seed % 2:
            cost = np.round(cost)                       # ties
        cost[:, :, rs.rand(m) < 0.3] = 1e9              # BIG columns
        counts = rs.randint(0, n + 1, 3)
        want = solve_assignment_plain(torch.from_numpy(cost),
                                      torch.from_numpy(counts)).numpy()
        for b in range(3):
            np.testing.assert_array_equal(_kernel_model(cost[b], counts[b]),
                                          want[b])


def _few_finite_columns(rs, nb, n, m, finite):
    """Costs whose first finite[b] columns are finite and the rest above BIG:
    once the finite columns are taken, every unused column's minv sits at
    BIG, so a step's argmin lands on a used column (the lowest index)."""
    cost = (rs.rand(nb, n, m) * 10).astype(np.float32)
    for b, k in enumerate(finite):
        cost[b, :, k:] = rs.uniform(1.5e9, 3.5e9, (n, m - k))
    return cost


def test_kernel_step_order_with_more_rows_than_finite_columns():
    rs = np.random.RandomState(5)
    for _ in range(6):
        n = rs.randint(3, 9)
        m = rs.randint(n, 16)
        finite = rs.randint(1, n, 3)
        cost = _few_finite_columns(rs, 3, n, m, finite)
        counts = np.array([n, n, rs.randint(1, n + 1)])
        want = solve_assignment_plain(torch.from_numpy(cost),
                                      torch.from_numpy(counts)).numpy()
        for b in range(3):
            assert len(set(want[b, :counts[b]].tolist())) == counts[b]
            np.testing.assert_array_equal(_kernel_model(cost[b], counts[b]),
                                          want[b])


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


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(SHIPPED))
def test_kernel_matches_plain_on_shipped_shapes(cuda, shape):
    nb, n, m, (lo, hi) = SHIPPED[shape]
    rs = np.random.RandomState(len(shape))
    cost = torch.from_numpy(rs.rand(nb, n, m).astype(np.float32)).to(cuda)
    counts = rs.randint(lo, hi + 1, nb)
    counts[0] = 0
    n_rows = torch.from_numpy(counts.astype(np.int32)).to(cuda)
    got = solve_assignment(cost, n_rows)
    want = solve_assignment_plain(cost, n_rows)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    rows = torch.arange(n, device=cuda)
    for b, k in enumerate(counts):
        assert (got[b, k:] == 0).all()
        total = cost[b, rows[:k], got[b, :k]].double().sum()
        assert total == cost[b, rows[:k], want[b, :k]].double().sum()


@pytest.mark.gpu
def test_kernel_matches_plain_with_more_rows_than_finite_columns(cuda):
    rs = np.random.RandomState(6)
    finite = np.array([1, 5, 20, 49, 10, 30])
    cost = torch.from_numpy(_few_finite_columns(rs, 6, 50, 300, finite))
    n_rows = torch.from_numpy(np.array([50, 50, 50, 50, 25, 40], np.int32))
    got = solve_assignment(cost.to(cuda), n_rows.to(cuda))
    want = solve_assignment_plain(cost.to(cuda), n_rows.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


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
