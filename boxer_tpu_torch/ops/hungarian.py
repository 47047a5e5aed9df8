"""Exact min-cost assignment (H1), the solver of the Hungarian matcher.

For each of N problems, cost (N, n, m) with n <= m and a row count
n_rows (N,): the assignment of rows 0..n_rows[b]-1 to distinct columns of
least total cost, as col4row (N, n) int64; a row at or past n_rows[b]
counts as done at once and gets column 0.

The algorithm is the JAX package's `boxer_tpu/nn/matcher.py:
_hungarian_single`, a Jonker-Volgenant shortest augmenting path solver with
dual potentials, there XLA loops vmapped over the problems (no Pallas
kernel). `solve_assignment` launches the hand-written CUDA kernel of
`boxer_tpu_torch/csrc/hungarian.cu` (one thread block a problem, the whole
solve on the card, no host round trip) on a CUDA tensor and runs
`solve_assignment_plain` on a CPU tensor; there is no other fallback. The
plain version runs the problems in lockstep, its loop tests on the host,
with the kernel's float operations in the same order and `argmin`'s
first-minimum rule, so the two agree bit for bit.
"""

import torch

from boxer_tpu_torch.ops import _build

# the masking cost of a used column (and of the matcher's duplicate
# candidate columns); exact in f32
BIG = 1e9
# the kernel keeps the row duals and a search's path in shared memory
MAX_ROWS = 4096


def solve_assignment_plain(cost, n_rows, count_steps=False):
    """Plain version of `solve_assignment` (the CPU path and the oracle):
    col4row (N, n) int64, and with count_steps the Dijkstra steps each
    problem took (N,) int64 as well. The loops are tested on the host."""
    nb, n, m = cost.shape
    dev = cost.device
    cost = cost.float()
    n_rows = n_rows.to(device=dev, dtype=torch.long).clamp(0, n)
    ar = torch.arange(nb, device=dev)
    # 1-indexed over columns; column 0 is the virtual start column.
    # p[:, j] = row assigned to column j (-1 = free); u, v duals.
    u = torch.zeros(nb, n, device=dev)
    v = torch.zeros(nb, m + 1, device=dev)
    p = torch.full((nb, m + 1), -1, dtype=torch.long, device=dev)
    steps = torch.zeros(nb, dtype=torch.long, device=dev)

    for i in range(int(n_rows.max()) if nb else 0):
        # a problem past its rows starts at a free column: done at once
        p[:, 0] = torch.where(i < n_rows, i, -1)
        minv = torch.full((nb, m + 1), BIG, device=dev)
        minv[:, 0] = -BIG
        way = torch.zeros(nb, m + 1, dtype=torch.long, device=dev)
        used = torch.zeros(nb, m + 1, dtype=torch.bool, device=dev)
        j0 = torch.zeros(nb, dtype=torch.long, device=dev)

        while True:
            i0 = p[ar, j0]
            active = i0 != -1
            if not bool(active.any()):
                break
            steps += active
            i0 = i0.clamp(min=0)
            used_n = used.clone()
            used_n[ar, j0] = True
            cur = cost[ar, i0] - u[ar, i0][:, None] - v[:, 1:]
            cur = torch.where(used_n[:, 1:], BIG, cur)
            better = cur < minv[:, 1:]
            minv_n = minv.clone()
            minv_n[:, 1:] = torch.where(better, cur, minv[:, 1:])
            way_n = way.clone()
            way_n[:, 1:] = torch.where(better, j0[:, None], way[:, 1:])

            masked = torch.where(used_n[:, 1:], BIG, minv_n[:, 1:])
            j1 = masked.argmin(dim=1) + 1
            delta = masked[ar, j1 - 1][:, None]
            # dual update: rows of used columns += delta, their v -= delta;
            # unused columns' reduced costs shrink by delta
            rows = torch.where(used_n & (p >= 0), p, n)
            row_mask = torch.zeros(nb, n + 1, dtype=torch.bool, device=dev)
            row_mask = row_mask.scatter_(1, rows, True)[:, :n]
            u_n = torch.where(row_mask, u + delta, u)
            v_n = torch.where(used_n, v - delta, v)
            minv_n = torch.where(used_n, minv_n, minv_n - delta)

            act = active[:, None]
            used = torch.where(act, used_n, used)
            minv = torch.where(act, minv_n, minv)
            way = torch.where(act, way_n, way)
            u = torch.where(act, u_n, u)
            v = torch.where(act, v_n, v)
            j0 = torch.where(active, j1, j0)

        # augment: walk back along `way`, shifting assignments
        while True:
            act = j0 != 0
            if not bool(act.any()):
                break
            j1 = way[ar, j0]
            p_n = p.clone()
            p_n[ar, j0] = p[ar, j1]
            p = torch.where(act[:, None], p_n, p)
            j0 = torch.where(act, j1, j0)

    # invert: col4row[r] = j such that p[j+1] == r (0-indexed real columns)
    rows = torch.where(p[:, 1:] >= 0, p[:, 1:], n)
    cols = torch.arange(m, device=dev).expand(nb, m)
    col4row = torch.zeros(nb, n + 1, dtype=torch.long, device=dev)
    col4row = col4row.scatter_(1, rows, cols)[:, :n]
    return (col4row, steps) if count_steps else col4row


def solve_assignment(cost, n_rows):
    """cost: (N, n, m) f32, n <= m; n_rows: (N,) int32 on cost's device.
    Returns col4row (N, n) int64. On a CUDA tensor the whole solve is one
    kernel launch: no host sync."""
    if cost.dim() != 3 or cost.shape[1] > cost.shape[2]:
        raise ValueError(f"solve_assignment: cost of shape {tuple(cost.shape)}"
                         "; want (N, n, m) with n <= m")
    if cost.device.type == "cpu":
        return solve_assignment_plain(cost, n_rows)
    if not cost.is_cuda:
        raise ValueError(f"solve_assignment: unsupported device {cost.device}")
    nb, n, m = cost.shape
    if cost.dtype != torch.float32 or not cost.is_contiguous():
        raise ValueError("solve_assignment: cost must be contiguous f32")
    if (tuple(n_rows.shape) != (nb,) or n_rows.dtype != torch.int32
            or n_rows.device != cost.device or not n_rows.is_contiguous()):
        raise ValueError("solve_assignment: n_rows must be (N,) int32 on "
                         "cost's device")
    if n > MAX_ROWS or m >= 2 ** 31 - 1:
        raise ValueError(f"solve_assignment: {n} rows, {m} columns (the "
                         f"kernel takes up to {MAX_ROWS} rows)")
    out = torch.empty(nb, n, dtype=torch.long, device=cost.device)
    if nb == 0 or n == 0:
        return out
    lib = _build.library()
    scratch = torch.empty(lib.hungarian_scratch_bytes(nb, m),
                          dtype=torch.uint8, device=cost.device)
    with torch.cuda.device(cost.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.hungarian_solve(cost.device.index, cost.data_ptr(),
                                  n_rows.data_ptr(), out.data_ptr(), nb, n,
                                  m, scratch.data_ptr(), stream)
    _build.check(err, "solve_assignment")
    solve_assignment.launches += 1
    return out


solve_assignment.launches = 0
