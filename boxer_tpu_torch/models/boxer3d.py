"""BoxeR-3D (Waymo BEV detection), inference and training; port of
`boxer_tpu/models/boxer3d.py`.

PointPillars backbone (`nn/backbone3d.py`), per-level input projections
(1x1 conv + GroupNorm), `Box3dTransformer`, the `Detector3d` decoder head
and the `MultiDetector3d` encoder head over 3 references a cell (its
outputs are `enc_outputs` in training). Spans (`utils/timer.py:span`) as
BoxeR-2D's: `boxer.forward` around the call, `boxer.backbone` (with
`boxer.pillars` and `boxer.neck` inside it, `nn/backbone3d.py`), the
transformer's, and a second `boxer.decoder` around the `Detector3d` head.
"""

import torch
from torch import nn

from boxer_tpu_torch.models import register_model
from boxer_tpu_torch.nn.backbone3d import build_backbone3d
from boxer_tpu_torch.nn.box3d_transformer import Box3dTransformer
from boxer_tpu_torch.nn.dropout import name_sites
from boxer_tpu_torch.nn.init import reset_default_, xavier_uniform_
from boxer_tpu_torch.nn.point_pillar import GN_EPS
from boxer_tpu_torch.nn.predictor import Detector3d, MultiDetector3d
from boxer_tpu_torch.utils.timer import span

NUM_REFERENCES = 3


@register_model("boxer3d")
class BoxeR3D(nn.Module):
    def __init__(self, num_classes: int = 3, hidden_dim: int = 256,
                 nhead: int = 8, num_level: int = 2, enc_layers: int = 2,
                 dec_layers: int = 2, dim_feedforward: int = 1024,
                 dropout: float = 0.0, num_queries: int = 300,
                 aux_loss: bool = True, ref_size: int = 4, *,
                 backbone_cfg: dict):
        """backbone_cfg: the config's `backbone` dict ({"type":
        "pointpillar", "params": {...}})."""
        super().__init__()
        self.dropout = dropout
        self.num_level = num_level
        self.backbone = build_backbone3d(backbone_cfg)
        in_channels = self.backbone.num_channels
        assert len(in_channels) == num_level, (in_channels, num_level)
        self.input_proj = nn.ModuleList(
            nn.Sequential(nn.Conv2d(c, hidden_dim, 1),
                          nn.GroupNorm(32, hidden_dim, eps=GN_EPS))
            for c in in_channels)
        self.transformer = Box3dTransformer(
            d_model=hidden_dim, nhead=nhead, nlevel=num_level,
            num_encoder_layers=enc_layers, num_decoder_layers=dec_layers,
            dim_feedforward=dim_feedforward, num_queries=num_queries,
            num_references=NUM_REFERENCES, ref_size=ref_size,
            dropout=dropout)
        self.enc_detector = MultiDetector3d(hidden_dim, 1, NUM_REFERENCES,
                                            aux_loss=False)
        self.detector = Detector3d(hidden_dim, num_classes, aux_loss)
        name_sites(self)

    @classmethod
    def from_config(cls, config, num_classes: int):
        t = config["transformer"]["params"]
        return cls(num_classes=num_classes, hidden_dim=config["hidden_dim"],
                   nhead=t["nhead"], num_level=t["nlevel"],
                   enc_layers=t["enc_layers"], dec_layers=t["dec_layers"],
                   dim_feedforward=t["dim_feedforward"], dropout=t["dropout"],
                   num_queries=t["num_queries"], aux_loss=config["aux_loss"],
                   ref_size=config["ref_size"],
                   backbone_cfg=dict(config["backbone"]))

    def reset_parameters_(self, g: torch.Generator):
        """The input projections' xavier-uniform kernels."""
        for proj in self.input_proj:
            xavier_uniform_(proj[0].weight, g)
            proj[0].bias.data.zero_()

    def init_weights(self, seed: int = 0):
        """Fill every parameter from `torch.Generator().manual_seed(seed)`."""
        reset_default_(self, torch.Generator().manual_seed(seed))
        return self

    def forward(self, voxels, coordinates, num_points_per_voxel, grid_shape,
                batch_size: int, train: bool = False, inference: bool = True,
                dropout_key=None):
        """voxels: (V, P, F); coordinates: (V, 4) [b, z, y, x], -1 rows are
        padding; num_points_per_voxel: (V,); grid_shape: (nx, ny).

        Returns pred_logits (B, NQ, C), pred_boxes (B, NQ, 7) (cx, cy, cz,
        l, w, h, angle, normalized to [0, 1]) and aux_outputs; with
        inference=False every decoder layer's outputs and enc_outputs. In
        training at dropout > 0 `dropout_key` draws the masks: it is
        required there."""
        if train and self.dropout > 0 and dropout_key is None:
            raise ValueError(f"dropout {self.dropout} in training needs a "
                             "dropout_key")
        with span("boxer.forward"):
            with span("boxer.backbone"):
                outs, pos = self.backbone(voxels, coordinates,
                                          num_points_per_voxel, batch_size,
                                          tuple(grid_shape))
                features = [self.input_proj[i](src.permute(0, 3, 1, 2))
                            .permute(0, 2, 3, 1)
                            for i, (src, _) in enumerate(outs)]
            hs, dec_ref_windows, _, _, enc_outputs = self.transformer(
                features, pos, self.enc_detector, inference=inference,
                dropout_key=dropout_key if train else None)
            with span("boxer.decoder"):
                out = self.detector(hs, dec_ref_windows)
        if not inference:
            out["enc_outputs"] = enc_outputs
        return out
