"""3D geometry on the host (numpy); port of `boxer_tpu/utils/geometry.py`
(the reference's `e2edet/utils/det3d/geometry.py`, numba there):
point-in-box tests for rotated 3D boxes and convex polygons. The box
corners come from the port's `boxes_to_corners_3d` on a CPU tensor.
"""

import numpy as np
import torch

from boxer_tpu_torch.utils.box3d_ops import boxes_to_corners_3d


def surface_equ_3d(polygon_surfaces: np.ndarray):
    """polygon_surfaces: (N, S, P, 3), the first 3 points of each surface.
    Returns (normals (N, S, 3), d (N, S))."""
    v1 = polygon_surfaces[:, :, 0] - polygon_surfaces[:, :, 1]
    v2 = polygon_surfaces[:, :, 1] - polygon_surfaces[:, :, 2]
    normal = np.cross(v1, v2)
    d = -np.einsum("nsk,nsk->ns", normal, polygon_surfaces[:, :, 0])
    return normal, d


def points_in_convex_polygon_3d(points: np.ndarray,
                                polygon_surfaces: np.ndarray) -> np.ndarray:
    """points (M, 3); polygon_surfaces (N, S, P, 3) in
    `corner_to_surfaces_3d`'s winding, whose normals point inward: a point
    is inside when (point . n + d) >= 0 for every surface. Returns (M, N)
    bool."""
    normals, d = surface_equ_3d(polygon_surfaces)
    proj = np.einsum("mk,nsk->mns", points[:, :3], normals)
    return (proj + d[None] >= -1e-8).all(axis=-1)


def corner_to_surfaces_3d(corners: np.ndarray) -> np.ndarray:
    """corners (N, 8, 3) in `boxes_to_corners_3d`'s order -> (N, 6, 4, 3)
    surfaces."""
    idx = np.array([[0, 1, 2, 3],       # bottom
                    [7, 6, 5, 4],       # top
                    [0, 4, 5, 1],
                    [1, 5, 6, 2],
                    [2, 6, 7, 3],
                    [3, 7, 4, 0]])
    return corners[:, idx]


def points_in_rbbox(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """points (M, 3+); boxes (N, 7) [x, y, z, l, w, h, rad]. Returns (M, N)
    bool."""
    corners = boxes_to_corners_3d(
        torch.as_tensor(np.asarray(boxes, np.float32))).numpy()
    return points_in_convex_polygon_3d(points[:, :3],
                                       corner_to_surfaces_3d(corners))


def points_count_rbbox(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """(N,) the number of points in each box."""
    return points_in_rbbox(points, boxes).sum(axis=0)


def points_in_convex_polygon_2d(points: np.ndarray,
                                polygons: np.ndarray) -> np.ndarray:
    """points (M, 2); polygons (N, K, 2), convex, either winding. Returns
    (M, N) bool."""
    edges = np.roll(polygons, -1, axis=1) - polygons          # (N, K, 2)
    to_pt = points[:, None, None, :2] - polygons[None]        # (M, N, K, 2)
    cross = (edges[None, ..., 0] * to_pt[..., 1]
             - edges[None, ..., 1] * to_pt[..., 0])
    return (cross >= -1e-8).all(axis=-1) | (cross <= 1e-8).all(axis=-1)
