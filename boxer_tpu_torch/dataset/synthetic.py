"""Synthetic training batches; numpy copy of `boxer_tpu/dataset/synthetic.py`
(same seed, same arrays), with the `iter_per_update` split in numpy; and
seeded Waymo frame directories in the converter's layout (`write_waymo`).

Layout: image (B, H, W, 3) float32, mask (B, H, W) bool (True = padding),
targets {labels (B, NT) int32, boxes (B, NT, 4) normalized cxcywh, valid
(B, NT) bool [, instance_masks (B, NT, 28, 28)]}; with iter_per_update,
every array gets a leading (iter_per_update, B / iter_per_update) split.
"""

from typing import Optional

import numpy as np


def synthetic_batch(
    batch_size: int = 2,
    height: int = 128,
    width: int = 128,
    num_targets: int = 10,
    num_classes: int = 80,
    with_masks: bool = False,
    mask_size: int = 28,
    seed: int = 0,
    iter_per_update: Optional[int] = None,
):
    rng = np.random.RandomState(seed)
    image = rng.randn(batch_size, height, width, 3).astype(np.float32)
    mask = np.zeros((batch_size, height, width), bool)
    # simulate padded right/bottom regions for some samples
    for b in range(batch_size):
        if b % 2 == 1:
            mask[b, :, int(width * 0.75):] = True
            mask[b, int(height * 0.8):, :] = True

    n_valid = rng.randint(1, num_targets + 1, size=batch_size)
    labels = rng.randint(0, num_classes, size=(batch_size, num_targets))
    cxcy = rng.uniform(0.2, 0.8, size=(batch_size, num_targets, 2))
    wh = rng.uniform(0.05, 0.3, size=(batch_size, num_targets, 2))
    boxes = np.concatenate([cxcy, wh], axis=-1).astype(np.float32)
    valid = np.arange(num_targets)[None, :] < n_valid[:, None]

    targets = {"labels": labels.astype(np.int32), "boxes": boxes,
               "valid": valid}
    if with_masks:
        targets["instance_masks"] = (
            rng.rand(batch_size, num_targets, mask_size, mask_size) > 0.5
        ).astype(np.float32)

    batch = {"image": image, "mask": mask, "targets": targets}
    if iter_per_update is not None:
        assert batch_size % iter_per_update == 0
        mb = batch_size // iter_per_update

        def split(x):
            return x.reshape((iter_per_update, mb) + x.shape[1:])

        batch = {"image": split(image), "mask": split(mask),
                 "targets": {k: split(v) for k, v in targets.items()}}
    return batch


# per class: (probability, length, width, height ranges in metres)
_WAYMO_OBJECTS = {
    "VEHICLE": (0.55, (3.5, 5.5), (1.7, 2.2), (1.4, 2.0)),
    "PEDESTRIAN": (0.35, (0.5, 1.0), (0.5, 1.0), (1.5, 1.9)),
    "CYCLIST": (0.05, (1.5, 2.0), (0.5, 0.8), (1.5, 1.9)),
    "SIGN": (0.05, (0.3, 0.7), (0.1, 0.3), (0.5, 1.0)),
}


def _in_box(points, box):
    """Mask of the points inside box (x, y, z, l, w, h, ..., heading)."""
    c, s = np.cos(-box[-1]), np.sin(-box[-1])
    local = points[:, :3] - box[:3]
    x = local[:, 0] * c - local[:, 1] * s
    y = local[:, 0] * s + local[:, 1] * c
    return ((np.abs(x) <= box[3] / 2) & (np.abs(y) <= box[4] / 2)
            & (np.abs(local[:, 2]) <= box[5] / 2))


def waymo_frame(rs, pc_range, n_points, n_objects, size_scale=1.0):
    """One seeded frame in the converter's layout: (lidar record, gt_boxes
    (M, 9) x, y, z, l, w, h, vx, vy, heading, gt_names, num_points_in_gt).
    About n_points points over the whole of pc_range's x-y square, ranges
    log-uniform (denser near the sensor, as a spinning lidar's returns are);
    each object gets points inside its box, 5 at least, about 8 a cubic
    metre (of the scaled size) besides."""
    lo, hi = np.asarray(pc_range[:3], np.float64), np.asarray(pc_range[3:])
    names = rs.choice(list(_WAYMO_OBJECTS), n_objects,
                      p=[v[0] for v in _WAYMO_OBJECTS.values()])
    size = np.stack([[rs.uniform(*r) for r in _WAYMO_OBJECTS[n][1:]]
                     for n in names]).reshape(-1, 3) * size_scale
    xy = rs.uniform(0.9 * lo[:2], 0.9 * hi[:2], (n_objects, 2))
    z = np.clip(-1.0 + size[:, 2] / 2, lo[2], hi[2])
    vel = rs.normal(0.0, 2.0, (n_objects, 2))
    heading = rs.uniform(-np.pi, np.pi, n_objects)
    boxes = np.concatenate([xy, z[:, None], size, vel, heading[:, None]],
                           1).astype(np.float32)

    inside = []
    for box in boxes:
        k = 5 + int(8 * np.prod(box[3:6]) / size_scale ** 3)
        local = rs.uniform(-0.5, 0.5, (k, 3)) * box[3:6]
        c, s = np.cos(box[-1]), np.sin(box[-1])
        inside.append(np.stack([local[:, 0] * c - local[:, 1] * s,
                                local[:, 0] * s + local[:, 1] * c,
                                local[:, 2]], 1) + box[:3])
    inside = np.concatenate(inside) if inside else np.zeros((0, 3))
    n_bg = max(n_points - len(inside), 0)
    corner = float(np.hypot(*np.maximum(-lo[:2], hi[:2])))
    bg = np.zeros((0, 2))
    while len(bg) < n_bg:
        r = np.exp(rs.uniform(np.log(corner / 40), np.log(corner), 2 * n_bg))
        phi = rs.uniform(-np.pi, np.pi, 2 * n_bg)
        cand = np.stack([r * np.cos(phi), r * np.sin(phi)], 1)
        bg = np.concatenate([bg, cand[((cand >= lo[:2])
                                       & (cand < hi[:2])).all(1)]])
    bg_z = np.clip(rs.normal(-1.0, 1.0, n_bg), lo[2] + 0.01, hi[2] - 0.01)
    xyz = np.concatenate([np.concatenate([bg[:n_bg], bg_z[:, None]], 1),
                          inside]).astype(np.float32)
    # raw intensity (the reader takes its tanh) and elongation
    feature = np.stack([rs.exponential(0.5, len(xyz)), rs.rand(len(xyz))],
                       1).astype(np.float32)
    num_points = np.asarray([_in_box(xyz, b).sum() for b in boxes], np.int64)
    record = {"lidars": {"points_xyz": xyz, "points_feature": feature}}
    return record, boxes, names, num_points


def write_waymo(root, frames, pc_range, n_points, objects, seed=0,
                size_scale=1.0):
    """A Waymo frame directory under root, in the converter's layout:
    `lidars/<token>.pkl` ({"lidars": {"points_xyz", "points_feature"}}) and
    `infos/infos_<split>.pkl` (frames with token, path relative to root,
    9-column gt_boxes, gt_names, num_points_in_gt, difficulty, sweeps) for
    each `frames` entry {split: count}. Frame i of a split holds
    randint(*objects) objects, at most half of the range on even frames
    (so that those frames hold few vehicles). Returns {split: info path}."""
    import os
    import pickle

    rs = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "lidars"), exist_ok=True)
    os.makedirs(os.path.join(root, "infos"), exist_ok=True)
    paths = {}
    for split, count in frames.items():
        infos = []
        for i in range(count):
            lo, hi = objects
            n = rs.randint(lo, (lo + hi) // 2 + 1 if i % 2 == 0 else hi + 1)
            record, boxes, names, num_points = waymo_frame(
                rs, pc_range, n_points, n, size_scale)
            token = f"{split}_seq_frame_{i}"
            rel = f"lidars/{token}.pkl"
            with open(os.path.join(root, rel), "wb") as f:
                pickle.dump(record, f)
            infos.append({"token": token, "path": rel, "gt_boxes": boxes,
                          "gt_names": names, "num_points_in_gt": num_points,
                          "difficulty": np.zeros(n, np.int8), "sweeps": []})
        paths[split] = os.path.join(root, "infos", f"infos_{split}.pkl")
        with open(paths[split], "wb") as f:
            pickle.dump(infos, f)
    return paths
