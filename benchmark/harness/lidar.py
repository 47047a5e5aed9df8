"""The benchmark's own lidar frames, made from the run's seed, and its own
plain voxelizer, so that the 3D cells' inputs depend on nothing of the
port.

A frame is `points` seeded points over the whole x-y square of the range,
its edges and corners included: ranges log-uniform from 2 m to the corner
(denser near the sensor, as a spinning lidar's returns are), the points
outside the square drawn again; z around the ground, intensity and
elongation in [0, 1). Five features a point, f32.

The voxelizer (PointPillars' rule): a point maps to the pillar
floor((p - range_min) / voxel_size), points out of range are dropped,
pillars are numbered in the order of their first point, a pillar keeps its
first `max_points` points, the first `max_voxels` pillars are kept, and the
block is padded to `max_voxels` rows whose coordinates are all -1.
"""

import numpy as np

from harness.data import substream


def cloud(rng, pc_range, n: int) -> np.ndarray:
    """(n, 5) f32 points of one frame drawn from the numpy Generator."""
    lo, hi = np.asarray(pc_range[:2]), np.asarray(pc_range[3:5])
    corner = float(np.hypot(*np.maximum(np.abs(lo), np.abs(hi))))
    xy = np.zeros((0, 2))
    while len(xy) < n:
        r = np.exp(rng.uniform(np.log(2.0), np.log(corner), 2 * n))
        phi = rng.uniform(-np.pi, np.pi, 2 * n)
        cand = np.stack([r * np.cos(phi), r * np.sin(phi)], 1)
        xy = np.concatenate([xy, cand[((cand >= lo) & (cand < hi)).all(1)]])
    z = np.clip(rng.normal(0.0, 1.0, n), pc_range[2] + 0.01,
                pc_range[5] - 0.01)
    return np.concatenate([xy[:n], z[:, None], rng.random((n, 2))],
                          1).astype(np.float32)


def grid_of(pc_range, voxel_size):
    """(nx, ny, nz), the rounded count of pillars over the range."""
    lo = np.asarray(pc_range[:3], np.float32)
    hi = np.asarray(pc_range[3:], np.float32)
    return tuple(int(v) for v in np.round(
        (hi - lo) / np.asarray(voxel_size, np.float32)))


def voxelize(points, voxel_size, pc_range, max_points: int,
             max_voxels: int, batch_index: int):
    """One frame's fixed block: (voxels (max_voxels, max_points, F) f32,
    coordinates (max_voxels, 4) int32 [b, z, y, x], points a pillar
    (max_voxels,) int32)."""
    lo = np.asarray(pc_range[:3], np.float32)
    grid = np.asarray(grid_of(pc_range, voxel_size))
    cell = np.floor((points[:, :3] - lo)
                    / np.asarray(voxel_size, np.float32)).astype(np.int64)
    inside = ((cell >= 0) & (cell < grid)).all(1)
    points, cell = points[inside], cell[inside]
    lin = (cell[:, 2] * grid[1] + cell[:, 1]) * grid[0] + cell[:, 0]
    _, first, which = np.unique(lin, return_index=True, return_inverse=True)
    # pillars numbered by their first point
    rank = np.empty(len(first), np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(first))
    pillar = rank[which.reshape(-1)]
    # each point's slot among its pillar's points, in arrival order
    order = np.argsort(pillar, kind="stable")
    start = np.searchsorted(pillar[order], np.arange(len(first)))
    slot = np.empty(len(pillar), np.int64)
    slot[order] = np.arange(len(pillar)) - start[pillar[order]]
    keep = (pillar < max_voxels) & (slot < max_points)

    voxels = np.zeros((max_voxels, max_points, points.shape[1]), np.float32)
    voxels[pillar[keep], slot[keep]] = points[keep]
    counts = np.zeros(max_voxels, np.int32)
    np.add.at(counts, pillar[keep], 1)
    coords = np.full((max_voxels, 4), -1, np.int32)
    n = min(len(first), max_voxels)
    by_rank = np.sort(first)[:n]
    coords[:n, 0] = batch_index
    coords[:n, 1:] = cell[by_rank][:, ::-1]
    return voxels, coords, counts


def frames(seed: int, count: int, batch: int, points: int, voxelizer: dict,
           pc_range, voxel_size):
    """`count` voxelized frames drawn from the seed, each numbered by its
    place in a batch of `batch`: numpy (voxels, coordinates, points a
    pillar) of all frames, one frame's block after the other."""
    parts = []
    for i in range(count):
        rng = np.random.default_rng(substream(seed, f"lidar{i}"))
        parts.append(voxelize(cloud(rng, pc_range, points), voxel_size,
                              pc_range, voxelizer["max_points"],
                              voxelizer["max_voxels"], i % batch))
    return tuple(np.concatenate(x) for x in zip(*parts))
