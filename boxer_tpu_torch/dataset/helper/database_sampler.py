"""GT-database augmentation sampler; port of
`boxer_tpu/dataset/helper/database_sampler.py`.

Parity target: reference `e2edet/dataset/helper/database_sampler.py:111-226`
(class-balanced sampling of cropped GT objects + BEV collision rejection)
and the numba `box_collision_test` (`det3d/general.py:586`), as a
vectorized numpy separating-axis test over rotated BEV rectangles.

Two departures from the JAX package:
- A sampled box takes the frame's box columns (`match_columns`). The
  converter writes 9-column frame boxes (x, y, z, l, w, h, vx, vy,
  heading) and the JAX package's `create_gt_database` 7-column db boxes,
  so its sampler raises in `np.concatenate` on the first accepted object
  of a converted frame. The port's `create_gt_database` keeps the frame's
  columns, and a 7-column db box gains zero velocity here.
- The JAX package's `sample_all` is split in two: `draw` takes the db
  entries (the per-class cursors and the rng), `place` the collision
  test and the points (no rng), so a loader takes the draws in batch
  order and the rest on any thread. `place(draw(...))` is `sample_all`.
  `state` / `set_state` read and restore the cursors.
"""

import os
from typing import Dict, List, Optional

import numpy as np


def _bev_corners(boxes: np.ndarray) -> np.ndarray:
    """boxes (N, 7+) [x,y,z,l,w,h,...,rad] -> BEV corners (N, 4, 2)."""
    n = len(boxes)
    if n == 0:
        return np.zeros((0, 4, 2), np.float32)
    l = boxes[:, 3] / 2
    w = boxes[:, 4] / 2
    rad = boxes[:, -1]
    template = np.array([[1, 1], [1, -1], [-1, -1], [-1, 1]], np.float32)
    corners = template[None] * np.stack([l, w], axis=-1)[:, None, :]
    c, s = np.cos(rad), np.sin(rad)
    rot = np.stack([np.stack([c, s], -1), np.stack([-s, c], -1)], axis=-2)
    corners = np.einsum("nij,njk->nik", corners, rot)
    return corners + boxes[:, None, :2]


def box_collision_test(boxes: np.ndarray, qboxes: np.ndarray) -> np.ndarray:
    """(N, M) bool: rotated-BEV-rectangle overlap via SAT over both boxes'
    edge normals. Parity target: `det3d/general.py:586` (numba polygon test)."""
    n, m = len(boxes), len(qboxes)
    if n == 0 or m == 0:
        return np.zeros((n, m), bool)
    c1 = _bev_corners(boxes)   # (N, 4, 2)
    c2 = _bev_corners(qboxes)  # (M, 4, 2)

    def axes(corners):
        edges = np.roll(corners, -1, axis=1) - corners  # (K, 4, 2)
        normals = np.stack([-edges[..., 1], edges[..., 0]], axis=-1)
        norm = np.linalg.norm(normals, axis=-1, keepdims=True)
        return normals / np.maximum(norm, 1e-9)

    def separated(ax):
        # ax: (N, 1, 4, 2) or (1, M, 4, 2); projections (N, M, 4 axes, 4
        # corners) of both corner sets
        ax = ax + np.zeros((n, m, 4, 2))
        p1 = np.einsum("nmax,ncx->nmac", ax, c1)
        p2 = np.einsum("nmax,mcx->nmac", ax, c2)
        sep = (p1.max(-1) < p2.min(-1)) | (p2.max(-1) < p1.min(-1))
        return sep.any(-1)  # separated on any axis

    return ~(separated(axes(c1)[:, None]) | separated(axes(c2)[None, :]))


def match_columns(boxes: np.ndarray, ncols: int) -> np.ndarray:
    """(N, C) db boxes as (N, ncols), the frame's columns: 7-column boxes
    (the JAX package's database) gain zero velocity (vx, vy) before the
    heading for 9-column frames (the converter's)."""
    c = boxes.shape[1]
    if c == ncols:
        return boxes
    if (c, ncols) == (7, 9):
        zeros = np.zeros((len(boxes), 2), boxes.dtype)
        return np.concatenate([boxes[:, :6], zeros, boxes[:, 6:]], axis=1)
    raise ValueError(f"db boxes of {c} columns for frame boxes of {ncols}")


class BatchSampler:
    """Shuffled epoch-cycling sampler over one class's db infos
    (parity: reference `database_sampler.py:14-58`). A reshuffle makes a
    new index array, so a `state()` taken before it keeps its order."""

    def __init__(self, sampled_list: List):
        self._sampled_list = sampled_list
        self._indices = np.arange(len(sampled_list))
        self._idx = 0
        self._len = len(sampled_list)

    def sample(self, num: int, rng: np.random.RandomState) -> List:
        if self._idx == 0 or self._idx + num >= self._len:
            self._indices = self._indices.copy()
            rng.shuffle(self._indices)
            self._idx = 0
        ret = self._indices[self._idx:self._idx + num]
        self._idx += num
        return [self._sampled_list[i] for i in ret]


class DataBaseSampler:
    def __init__(self, db_infos: Dict, groups: List[Dict],
                 min_points: int = 0, difficulty: int = -1, rate: float = 1.0):
        # filter by min points / difficulty (reference :74-99)
        self.db_infos = {
            name: [i for i in infos
                   if i.get("num_points_in_gt", min_points) >= min_points
                   and (difficulty < 0 or i.get("difficulty", 0) >= difficulty)]
            for name, infos in db_infos.items()}
        self.rate = rate
        self.groups = groups  # list of {class_name: max_count}
        self.samplers = {name: BatchSampler(infos)
                         for name, infos in self.db_infos.items()
                         if len(infos) > 0}

    def state(self) -> Dict:
        """{class: (index order, cursor)}; the arrays are never written."""
        return {name: (s._indices, s._idx) for name, s in self.samplers.items()}

    def set_state(self, state: Dict):
        for name, (indices, idx) in state.items():
            self.samplers[name]._indices = np.asarray(indices)
            self.samplers[name]._idx = int(idx)

    def draw(self, gt_names: np.ndarray, rng: np.random.RandomState) -> List:
        """The db entries to try for a frame whose boxes are named
        gt_names: [(class, info)], up to each group's count."""
        drawn = []
        for group in self.groups:
            for name, max_count in dict(group).items():
                if name not in self.samplers:
                    continue
                existing = int((gt_names == name).sum())
                num = int(self.rate * max(0, max_count - existing))
                if num <= 0:
                    continue
                drawn += [(name, info)
                          for info in self.samplers[name].sample(num, rng)]
        return drawn

    def place(self, root_path: str, gt_boxes: np.ndarray, drawn: List,
              num_point_features: int) -> Optional[Dict]:
        """The drawn objects that collide in BEV with no frame box and no
        object accepted before them, with their points: {"gt_boxes" (K, C)
        in the frame's C columns, "gt_names" (K,), "points"}, or None."""
        if not drawn:
            return None
        sampled_boxes = match_columns(np.stack([
            np.asarray(info["box3d_lidar"], np.float32) for _, info in drawn]),
            gt_boxes.shape[1])

        # BEV collision rejection against existing + already-accepted boxes
        keep = []
        # (as the JAX package's, a frame without boxes starts a float64 pool)
        pool = (gt_boxes.astype(np.float32) if len(gt_boxes)
                else np.zeros((0, sampled_boxes.shape[1])))
        for i in range(len(sampled_boxes)):
            cand = sampled_boxes[i:i + 1]
            if pool.shape[0] and box_collision_test(cand, pool).any():
                continue
            keep.append(i)
            pool = np.concatenate([pool, cand], axis=0)
        if not keep:
            return None

        points_list = []
        boxes_out, names_out = [], []
        for i in keep:
            name, info = drawn[i]
            pts_path = info["path"]
            if not os.path.isabs(pts_path):
                pts_path = os.path.join(root_path, pts_path)
            try:
                if pts_path.endswith(".npz"):
                    pts = np.load(pts_path)["points"].astype(np.float32)
                else:
                    pts = np.fromfile(pts_path, np.float32).reshape(
                        -1, num_point_features)
            except (FileNotFoundError, ValueError):
                continue
            # object points stored relative to box center
            box = sampled_boxes[i]
            pts = pts.copy()
            pts[:, :3] += box[:3]
            points_list.append(pts)
            boxes_out.append(box)
            names_out.append(name)
        if not points_list:
            return None
        return {
            "gt_boxes": np.stack(boxes_out),
            "gt_names": np.asarray(names_out),
            "points": np.concatenate(points_list, axis=0),
        }
