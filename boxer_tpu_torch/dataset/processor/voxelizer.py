"""Point-cloud voxelization on the host, in numpy; the port's own copy of
`boxer_tpu/dataset/processor/voxelizer.py` (`points_to_voxel`,
`pad_voxels`), with the same arrays for the same points.

Semantics (the reference's numba voxelizer): a point maps to the voxel
floor((p - range_min) / voxel_size); points out of range are dropped; voxels
are numbered in the order of their first point; a voxel keeps its first
`max_points` points and only the first `max_voxels` voxels are kept;
`reverse=True` gives coordinates as (z, y, x). No voxel cell repeats.
"""

from typing import Tuple

import numpy as np


def points_to_voxel(points: np.ndarray, voxel_size, pc_range,
                    max_points: int = 35, reverse: bool = True,
                    max_voxels: int = 20000
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """points: (N, F>=3). Returns (voxels (V, max_points, F), coords (V, 3)
    int32, [z, y, x] if reverse, num_points_per_voxel (V,) int32)."""
    voxel_size = np.asarray(voxel_size, np.float32)
    pc_range = np.asarray(pc_range, np.float32)
    grid = np.round((pc_range[3:] - pc_range[:3]) / voxel_size).astype(np.int64)

    coor = np.floor(
        (points[:, :3] - pc_range[:3]) / voxel_size).astype(np.int64)
    in_range = ((coor >= 0) & (coor < grid)).all(axis=1)
    pts = points[in_range]
    coor = coor[in_range]
    f = points.shape[1]
    if len(pts) == 0:
        return (np.zeros((0, max_points, f), points.dtype),
                np.zeros((0, 3), np.int32), np.zeros((0,), np.int32))

    # voxels numbered by first arrival: a stable unique of the linear ids
    lin = (coor[:, 2] * grid[1] + coor[:, 1]) * grid[0] + coor[:, 0]
    _, first_idx, inverse = np.unique(lin, return_index=True,
                                      return_inverse=True)
    order = np.argsort(first_idx, kind="stable")
    rank_of_uniq = np.empty_like(order)
    rank_of_uniq[order] = np.arange(len(order))
    voxel_rank = rank_of_uniq[inverse.reshape(-1)]

    # each point's slot among its voxel's points, in arrival order
    sort_key = np.argsort(voxel_rank, kind="stable")
    sorted_rank = voxel_rank[sort_key]
    group_start = np.searchsorted(sorted_rank, np.arange(sorted_rank.max() + 1))
    slot = np.empty_like(sort_key)
    slot[sort_key] = np.arange(len(sorted_rank)) - group_start[sorted_rank]

    keep = (voxel_rank < max_voxels) & (slot < max_points)
    v = min(int(voxel_rank.max()) + 1, max_voxels)
    voxels = np.zeros((v, max_points, f), points.dtype)
    voxels[voxel_rank[keep], slot[keep]] = pts[keep]
    num_points = np.zeros((v,), np.int32)
    np.add.at(num_points, voxel_rank[keep], 1)

    # a voxel's coordinates are its first point's
    vc = coor[first_idx[order][:v]]
    coords = (vc[:, [2, 1, 0]] if reverse else vc).astype(np.int32)
    return voxels, coords, num_points


def pad_voxels(voxels, coords, num_points, batch_idx: int, max_voxels: int):
    """Pad to a fixed (max_voxels, ...) block with batch-prefixed
    coordinates (b, z, y, x); padding rows get b = -1 (all four -1) and no
    points, and the BEV scatter drops them."""
    v, p, f = voxels.shape
    out_v = np.zeros((max_voxels, p, f), voxels.dtype)
    out_c = np.full((max_voxels, 4), -1, np.int32)
    out_n = np.zeros((max_voxels,), np.int32)
    n = min(v, max_voxels)
    out_v[:n] = voxels[:n]
    out_c[:n, 0] = batch_idx
    out_c[:n, 1:] = coords[:n]
    out_n[:n] = num_points[:n]
    return out_v, out_c, out_n
