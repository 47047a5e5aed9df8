"""BoxeR-3D PointPillars, the inference forward and the top-k that serves
its detections.

The BEV backbone (`backbone3d.py`), per-level input projections (a 1x1
conv and GroupNorm(32)), the rotated box-attention transformer
(`box3d_transformer.py`), the encoder head over 3 references a cell
(`MultiDetector3d`) and the decoder's class and 7-DoF box head
(`Detector3d`); then the top `topk` (query, class) pairs of each frame by
sigmoid score, with their boxes in metres. Parameter names are the port's,
so both take one state dict. The plain reference of the benchmark: f32,
explicit gathers for the bilinear taps, no kernel; it imports nothing of
the port, of JAX or of the JAX package. Its departures from the published
description are the port's own, listed in each file (the GroupNorms in
place of BatchNorm, the pillar norm's two passes).
"""

import math

import torch
from torch import nn

from .backbone3d import Backbone3d
from .box3d_transformer import Box3dTransformer
from .general import inverse_sigmoid, top_k
from .point_pillar import GN_EPS
from .predictor import MLP

NUM_REFERENCES = 3


def _permute_7dof(coord):
    """Raw head outputs (x, y, l, w, rad, z, h) -> (x, y, z, l, w, h, rad)."""
    return torch.cat([coord[..., 0:2], coord[..., 5:6], coord[..., 2:4],
                      coord[..., 6:7], coord[..., 4:5]], dim=-1)


class MultiDetector3d(nn.Module):
    """The encoder head: a class logit and a raw 7-DoF box a reference."""

    def __init__(self, hidden_dim: int, num_classes: int, num_references: int):
        super().__init__()
        self.class_embed = nn.Linear(hidden_dim, num_references * num_classes)
        self.bbox_embed = MLP(hidden_dim, hidden_dim, num_references * 7, 3)


class Detector3d(nn.Module):
    """The decoder head: class logits, and the box refining its window."""

    def __init__(self, hidden_dim: int, num_classes: int):
        super().__init__()
        self.class_embed = nn.Linear(hidden_dim, num_classes)
        self.bbox_embed = MLP(hidden_dim, hidden_dim, 7, 3)

    def forward(self, x, ref_windows):
        """x (B, NQ, C); ref_windows (B, NQ, 7) raw order in [0, 1].
        Returns logits (B, NQ, classes) and boxes (B, NQ, 7) (cx, cy, cz,
        l, w, h, angle) in [0, 1]."""
        coord = self.bbox_embed(x) + inverse_sigmoid(ref_windows)
        return self.class_embed(x), torch.sigmoid(_permute_7dof(coord))


def metric_boxes(boxes, pc_range):
    """Normalized (cx, cy, cz, l, w, h, angle) -> metres and radians."""
    lo = torch.tensor(pc_range[:3], dtype=torch.float32, device=boxes.device)
    size = torch.tensor(pc_range[3:6], dtype=torch.float32,
                        device=boxes.device) - lo
    return torch.cat([boxes[..., :3] * size + lo, boxes[..., 3:6] * size,
                      boxes[..., 6:] * (2 * math.pi) - math.pi], dim=-1)


class BoxeR3D(nn.Module):
    def __init__(self, num_classes: int, hidden_dim: int, nhead: int,
                 num_level: int, enc_layers: int, dec_layers: int,
                 dim_feedforward: int, num_queries: int, ref_size: int,
                 dropout: float = 0.0, aux_loss: bool = True, *,
                 backbone_cfg: dict):
        """The configuration's keys; `dropout` and `aux_loss` act only in
        training. backbone_cfg: {"type": "pointpillar", "params": {...}}
        with the reader, the neck and `return_layers`."""
        super().__init__()
        params = backbone_cfg["params"]
        assert backbone_cfg["type"] == "pointpillar"
        assert params["position_encoding"] == "fixed"
        reader = {k: params["reader"][k] for k in (
            "num_input_features", "num_filters", "voxel_size", "pc_range")}
        neck = {k: params["neck"][k]
                for k in ("num_layers", "ds_strides", "ds_filters")}
        self.pc_range = tuple(reader["pc_range"])
        self.backbone = Backbone3d(hidden_dim, reader, neck,
                                   params["return_layers"])
        assert len(self.backbone.num_channels) == num_level
        self.input_proj = nn.ModuleList(
            nn.Sequential(nn.Conv2d(c, hidden_dim, 1),
                          nn.GroupNorm(32, hidden_dim, eps=GN_EPS))
            for c in self.backbone.num_channels)
        self.transformer = Box3dTransformer(
            hidden_dim, nhead, num_level, enc_layers, dec_layers,
            dim_feedforward, num_queries, NUM_REFERENCES, ref_size)
        self.enc_detector = MultiDetector3d(hidden_dim, 1, NUM_REFERENCES)
        self.detector = Detector3d(hidden_dim, num_classes)

    def forward(self, voxels, coords, num_points, grid, batch_size: int,
                topk: int = 125):
        """voxels (V, P, F) f32; coords (V, 4) [b, z, y, x], b = -1 for
        padding; num_points (V,); grid (nx, ny). Returns the top `topk`
        (query, class) pairs of each frame: {scores (B, K), labels (B, K),
        boxes (B, K, 7) in metres, the heading in radians}. The pairs
        follow `transformer.forced["topk"]` where given (`follow.py`)."""
        outs, pos = self.backbone(voxels, coords, num_points, batch_size,
                                  tuple(grid))
        features = [proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
                    for proj, x in zip(self.input_proj, outs)]
        tgt, dec_ref = self.transformer(features, pos, self.enc_detector)
        logits, boxes = self.detector(tgt, dec_ref)
        b, nq, c = logits.shape
        _, idx = top_k(torch.sigmoid(logits).reshape(b, nq * c),
                       min(topk, nq * c))
        q, labels = self.transformer.follow("topk", (idx // c, idx % c),
                                            logits)
        scores = torch.sigmoid(logits[torch.arange(b, device=q.device)[
            :, None], q, labels])
        boxes = metric_boxes(torch.gather(boxes, 1, q[..., None].expand(
            -1, -1, 7)), self.pc_range)
        return {"scores": scores, "labels": labels, "boxes": boxes}

