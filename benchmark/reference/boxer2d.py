"""BoxeR-2D instance segmentation, the inference forward with the deferred
top-k mask decode.

ResNet backbone, per-level input projections (1×1 conv + GroupNorm, a
stride-2 3×3 conv for the extra levels), BoxTransformer, the decoder's
Detector head with its mask head, and the encoder's proposal head.
Parameter names are the port's, so both take one state dict.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .box_transformer import BoxTransformer
from .position_encoding import fixed_box_embedding
from .predictor import Detector
from .resnet import BackBone, interpolate_mask_nearest

GN_EPS = 1e-6       # flax GroupNorm's epsilon


class BoxeR2D(nn.Module):
    def __init__(self, num_classes: int = 91, hidden_dim: int = 256,
                 nhead: int = 8, num_level: int = 4, enc_layers: int = 6,
                 dec_layers: int = 6, dim_feedforward: int = 1024,
                 dropout: float = 0.0, num_queries: int = 300,
                 aux_loss: bool = True, use_mask: bool = True,
                 ref_size: int = 4, residual_mode: str = "v1",
                 backbone_arch: str = "resnet50",
                 position_encoding: str = "fixed_box"):
        """The configuration's keys; `dropout` and `aux_loss` act only in
        training, and the forward is that of a segm model (`use_mask`)
        with box-shaped position encodings."""
        super().__init__()
        assert use_mask and position_encoding == "fixed_box"
        self.hidden_dim, self.num_level = hidden_dim, num_level
        self.ref_size = ref_size
        self.backbone = BackBone(backbone_arch, hidden_dim, ref_size)
        in_channels = self.backbone.num_channels
        projs = []
        for i in range(num_level):
            if i < len(in_channels):
                conv = nn.Conv2d(in_channels[i], hidden_dim, 1)
            else:
                conv = nn.Conv2d(in_channels[-1] if i == len(in_channels)
                                 else hidden_dim, hidden_dim, 3, stride=2,
                                 padding=1)
            projs.append(nn.Sequential(
                conv, nn.GroupNorm(32, hidden_dim, eps=GN_EPS)))
        self.input_proj = nn.ModuleList(projs)
        self.transformer = BoxTransformer(
            d_model=hidden_dim, nhead=nhead, nlevel=num_level,
            num_encoder_layers=enc_layers, num_decoder_layers=dec_layers,
            dim_feedforward=dim_feedforward, num_queries=num_queries,
            ref_size=ref_size, residual_mode=residual_mode)
        self.enc_detector = Detector(hidden_dim, 1)
        self.detector = Detector(hidden_dim, num_classes, with_mask=True)

    def forward(self, image, mask: Optional[torch.Tensor], postprocess: dict):
        """image: (B, H, W, 3) NHWC normalized; mask: (B, H, W) bool padding
        mask (True = padded) or None; postprocess: {canvas_hw, topk}.
        Returns {scores, labels, boxes, masks}."""
        dtype = self.input_proj[0][0].weight.dtype
        outs, pos = self.backbone(image.to(dtype), mask)

        features, masks, pos_encodings = [], [], []
        for i, (src, m) in enumerate(outs):
            feat = self.input_proj[i](src.permute(0, 3, 1, 2))
            features.append(feat.permute(0, 2, 3, 1))
            masks.append(m)
            pos_encodings.append(pos[i])

        last_raw = outs[-1][0].permute(0, 3, 1, 2)
        for i in range(len(features), self.num_level):
            x = (last_raw if i == len(outs)
                 else F.relu(features[-1]).permute(0, 3, 1, 2))
            feat = self.input_proj[i](x).permute(0, 2, 3, 1)
            m = (interpolate_mask_nearest(mask, feat.shape[1:3])
                 if mask is not None else None)
            pos_encodings.append(fixed_box_embedding(
                feat, m, self.hidden_dim, self.ref_size).to(feat.dtype))
            features.append(feat)
            masks.append(m)

        return self.transformer(features, masks, pos_encodings,
                                self.enc_detector, self.detector, postprocess)
