"""Waymo detections from BoxeR-3D outputs; the computation of
`boxer_tpu/dataset/waymo.py:WaymoDataset.format_for_evalai` (without the
local-eval metadata), on the outputs' device; and the BEV grid a served
frame runs at.
"""

import math

import numpy as np
import torch

from boxer_tpu_torch.utils.general import top_k


def grid_shape(pc_range, voxel_size):
    """(nx, ny): the voxelizer's BEV grid over pc_range, the rounded count
    of pillars as `WaymoDataset.grid_shape` takes it (469 x 469 for the
    shipped config's 150 m at 0.32 m). A model run at a smaller grid would
    fold the last column's pillars into the next row."""
    lo, hi = (np.asarray(pc_range[i:i + 3], np.float32) for i in (0, 3))
    size = np.round((hi - lo) / np.asarray(voxel_size, np.float32))
    return int(size[0]), int(size[1])


def format_for_evalai(pred_logits, pred_boxes, pc_range, topk: int = 125):
    """pred_logits (B, NQ, C); pred_boxes (B, NQ, 7) normalized (cx, cy, cz,
    l, w, h, angle); pc_range (x0, y0, z0, x1, y1, z1) in metres.

    Denormalizes the boxes (centre and size by pc_range, angle * 2π - π),
    takes the sigmoid and the top `topk` (query, class) pairs of each frame.
    Returns {"pred_scores" (B, K), "pred_labels" (B, K) int64, the class
    index, "pred_boxes3d" (B, K, 7) metric}, sorted by descending score
    (the JAX package's top-k is unordered)."""
    b, nq, c = pred_logits.shape
    lo = torch.tensor(pc_range[:3], dtype=torch.float32,
                      device=pred_boxes.device)
    size = torch.tensor(pc_range[3:6], dtype=torch.float32,
                        device=pred_boxes.device) - lo
    boxes = pred_boxes.float()
    boxes = torch.cat([boxes[..., :3] * size + lo, boxes[..., 3:6] * size,
                       boxes[..., 6:] * (2 * math.pi) - math.pi], dim=-1)
    prob = torch.sigmoid(pred_logits.float()).reshape(b, nq * c)
    scores, idx = top_k(prob, min(topk, nq * c))
    q = idx // c
    return {"pred_scores": scores, "pred_labels": idx % c,
            "pred_boxes3d": torch.gather(boxes, 1,
                                         q[..., None].expand(-1, -1, 7))}
