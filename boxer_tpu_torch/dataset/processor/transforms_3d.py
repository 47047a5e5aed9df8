"""3D point-cloud augmentation primitives (host-side numpy); copy of
`boxer_tpu/dataset/processor/transforms_3d.py`, the same arrays for the same
inputs and draws.

Parity targets: reference `e2edet/dataset/processor/functional.py` 3D section
— random_flip (:330-352), global_rotation (:288-306), global_scaling
(:310-316), global_translate (:320-326), filter_by_pc_range (:399-410),
shuffle_points (:355-358), voxelize (:361-397), normalize3d with
sigmoid-period angle (:413-456), double_flip TTA (:265-285).

Samples: {"points": (N, F)}; targets: {"boxes": (M, 7+) [x,y,z,l,w,h,(vx,vy),rad],
"labels": (M,)} in metric coordinates until normalize3d. The heading is
the last column whatever the width (column 8 of the converter's 9-column
boxes, which carry the velocity in columns 6 and 7).
"""

import math

import numpy as np


def _rotate_z(points: np.ndarray, angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    rot = np.array([[c, s], [-s, c]], points.dtype)
    out = points.copy()
    out[:, :2] = points[:, :2] @ rot
    return out


def random_flip(sample, target, rng, prob: float = 0.5):
    """Independent x/y flips (reference flips along each axis with the
    caller's coin flips; `functional.py:330-352`)."""
    sample = dict(sample)
    target = dict(target)
    points = sample["points"].copy()
    boxes = target.get("boxes")
    boxes = boxes.copy() if boxes is not None else None

    if rng.rand() < prob:  # x_flip: mirror y
        points[:, 1] = -points[:, 1]
        if boxes is not None:
            boxes[:, 1] = -boxes[:, 1]
            boxes[:, -1] = -boxes[:, -1]
            if boxes.shape[1] > 7:
                boxes[:, 7] = -boxes[:, 7]
    if rng.rand() < prob:  # y_flip: mirror x
        points[:, 0] = -points[:, 0]
        if boxes is not None:
            boxes[:, 0] = -boxes[:, 0]
            boxes[:, -1] = -(boxes[:, -1] + np.pi)
            if boxes.shape[1] > 7:
                boxes[:, 6] = -boxes[:, 6]

    sample["points"] = points
    if boxes is not None:
        target["boxes"] = boxes
    return sample, target


def global_rotation(sample, target, rng, rotation: float):
    noise = rng.uniform(-rotation, rotation)
    sample = dict(sample)
    target = dict(target)
    sample["points"] = _rotate_z(sample["points"], noise)
    boxes = target.get("boxes")
    if boxes is not None:
        boxes = boxes.copy()
        boxes[:, :3] = np.concatenate(
            [_rotate_z(boxes[:, :2], noise), boxes[:, 2:3]], axis=1)
        boxes[:, -1] += noise
        if boxes.shape[1] > 7:
            boxes[:, 6:8] = _rotate_z(boxes[:, 6:8], noise)
        target["boxes"] = boxes
    return sample, target


def global_scaling(sample, target, rng, min_scale: float, max_scale: float):
    noise = rng.uniform(min_scale, max_scale)
    sample = dict(sample)
    target = dict(target)
    pts = sample["points"].copy()
    pts[:, :3] *= noise
    sample["points"] = pts
    boxes = target.get("boxes")
    if boxes is not None:
        boxes = boxes.copy()
        boxes[:, :6] *= noise
        target["boxes"] = boxes
    return sample, target


def global_translate(sample, target, rng, noise_std):
    noise = rng.normal(0, noise_std, size=3)
    sample = dict(sample)
    target = dict(target)
    pts = sample["points"].copy()
    pts[:, :3] += noise
    sample["points"] = pts
    boxes = target.get("boxes")
    if boxes is not None:
        boxes = boxes.copy()
        boxes[:, :3] += noise
        target["boxes"] = boxes
    return sample, target


def filter_by_pc_range(sample, target, pc_range):
    pc_range = np.asarray(pc_range, np.float32)
    sample = dict(sample)
    target = dict(target)
    pts = sample["points"]
    keep = ((pts[:, 0] >= pc_range[0]) & (pts[:, 0] <= pc_range[3])
            & (pts[:, 1] >= pc_range[1]) & (pts[:, 1] <= pc_range[4]))
    sample["points"] = pts[keep]

    boxes = target.get("boxes")
    if boxes is not None:
        c = boxes[:, :3]
        keep_b = ((c >= pc_range[:3]) & (c <= pc_range[3:6])).all(axis=1)
        target["boxes"] = boxes[keep_b]
        target["labels"] = target["labels"][keep_b]
    return sample, target


def shuffle_points(sample, target, rng):
    """The points in a random order: that of `rng.shuffle(points)`, from
    the same draws (numpy swaps an index vector's entries as it swaps a
    2-D array's rows), as one gather; numpy's row swaps of a 2-D array run
    one Python-level step a point (about 260 ms for 180,000 points)."""
    sample = dict(sample)
    pts = sample["points"]
    sample["points"] = pts[rng.permutation(len(pts))]
    return sample, target


def limit_period_np(val, offset: float = 0.5, period: float = math.pi):
    return val - np.floor(val / period + offset) * period


def normalize3d(sample, target, pc_range, normalize_angle: str = "sigmoid"):
    """Boxes → [0,1] with normalized angle (reference `functional.py:413-456`).

    sigmoid mode: boxes become 7-dim (x,y,z,l,w,h, (rad+π)/2π);
    sine mode: 8-dim (..., sin rad, cos rad)."""
    pc_range = np.asarray(pc_range, np.float32)
    target = dict(target)
    boxes = target.get("boxes")
    if boxes is None or len(boxes) == 0:
        n_dim = 8 if normalize_angle == "sine" else 7
        target["boxes"] = np.zeros((0, n_dim), np.float32)
        return sample, target
    boxes = boxes.copy()

    pc_size = pc_range[3:] - pc_range[:3]
    boxes[:, :3] = (boxes[:, :3] - pc_range[:3]) / pc_size
    boxes[:, 3:6] = boxes[:, 3:6] / pc_size
    boxes[:, -1] = limit_period_np(boxes[:, -1], 0.5, np.pi * 2)

    if normalize_angle == "sine":
        out = np.concatenate(
            [boxes[:, :6], np.sin(boxes[:, -1:]), np.cos(boxes[:, -1:])],
            axis=-1)
    elif normalize_angle == "sigmoid":
        out = boxes[:, [0, 1, 2, 3, 4, 5, boxes.shape[1] - 1]]
        out[:, -1] = (out[:, -1] + np.pi) / (2 * np.pi)
    else:
        raise ValueError(normalize_angle)
    target["boxes"] = np.clip(out, 0.0, 1.0).astype(np.float32)
    return sample, target


def double_flip(sample, target):
    """TTA point-set variants (reference `functional.py:265-285`)."""
    sample = dict(sample)
    pts = sample["points"]
    y = pts.copy(); y[:, 1] = -y[:, 1]
    x = pts.copy(); x[:, 0] = -x[:, 0]
    xy = pts.copy(); xy[:, 0] = -xy[:, 0]; xy[:, 1] = -xy[:, 1]
    sample["yflip_points"] = y
    sample["xflip_points"] = x
    sample["double_flip_points"] = xy
    return sample, target
