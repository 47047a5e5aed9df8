"""BoxeR-2D inference (detection + instance segmentation); port of
`boxer_tpu/models/boxer2d.py`.

ResNet backbone + per-level input projections (1×1 conv + GroupNorm, a
stride-2 3×3 conv for extra levels), BoxTransformer, and the decoder
Detector head. Parameter names are the reference e2edet ones, so
`load_state_dict` takes a reference checkpoint. Training is not ported yet.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from boxer_tpu_torch.evaluate.postprocess import coco_postprocess
from boxer_tpu_torch.nn.box_transformer import BoxTransformer
from boxer_tpu_torch.nn.init import reset_default_, xavier_uniform_
from boxer_tpu_torch.nn.position_encoding import build_position_encoding
from boxer_tpu_torch.nn.predictor import Detector
from boxer_tpu_torch.nn.resnet import BackBone, interpolate_mask_nearest

GN_EPS = 1e-6       # flax GroupNorm's epsilon


class BoxeR2D(nn.Module):
    def __init__(self, num_classes: int = 91, hidden_dim: int = 256,
                 nhead: int = 8, num_level: int = 4, enc_layers: int = 6,
                 dec_layers: int = 6, dim_feedforward: int = 1024,
                 dropout: float = 0.0, num_queries: int = 300,
                 aux_loss: bool = True, use_mask: bool = False,
                 ref_size: int = 4, residual_mode: str = "v1",
                 backbone_arch: str = "resnet50",
                 position_encoding: str = "fixed_box"):
        super().__init__()
        # dropout is a training knob; inference runs none
        self.hidden_dim, self.num_level = hidden_dim, num_level
        self.use_mask, self.ref_size = use_mask, ref_size
        self.backbone = BackBone(backbone_arch, ("layer2", "layer3", "layer4"),
                                 position_encoding, hidden_dim, ref_size)
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
            use_mask=use_mask, ref_size=ref_size, residual_mode=residual_mode)
        self.enc_detector = Detector(hidden_dim, 1, aux_loss=False)
        self.detector = Detector(hidden_dim, num_classes, aux_loss,
                                 mask_mode="mask_v1" if use_mask else "none")

    @classmethod
    def from_config(cls, config, num_classes: int):
        t = config["transformer"]["params"]
        bb = config["backbone"]
        return cls(
            num_classes=num_classes,
            hidden_dim=config["hidden_dim"],
            nhead=t["nhead"],
            num_level=t["nlevel"],
            enc_layers=t["enc_layers"],
            dec_layers=t["dec_layers"],
            dim_feedforward=t["dim_feedforward"],
            dropout=t["dropout"],
            num_queries=t["num_queries"],
            aux_loss=config["aux_loss"],
            use_mask=config["use_mask"],
            ref_size=config["ref_size"],
            residual_mode=t.get("residual_mode", "v1"),
            backbone_arch=bb["type"],
            position_encoding=bb["params"].get("position_encoding", "fixed_box"),
        )

    def reset_parameters_(self, g: torch.Generator):
        """Seeded random weights with the JAX package's initialisers."""
        for proj in self.input_proj:
            xavier_uniform_(proj[0].weight, g)
            proj[0].bias.data.zero_()

    def init_weights(self, seed: int = 0):
        """Fill every parameter from `torch.Generator().manual_seed(seed)`."""
        reset_default_(self, torch.Generator().manual_seed(seed))
        return self

    def forward(self, image, mask: Optional[torch.Tensor] = None,
                train: bool = False, inference: bool = True,
                postprocess: Optional[dict] = None):
        """image: (B, H, W, 3) NHWC normalized; mask: (B, H, W) bool padding
        mask (True = padded) or None.

        Returns pred_logits (B, nq, C), pred_boxes (B, nq, 4) [+ pred_masks
        (B, nq, 28, 28)] and aux_outputs. With postprocess (dict with
        canvas_hw, topk[, scale]): {scores, labels, boxes[, masks]} — for
        use_mask through the deferred top-k mask decode.
        """
        if train or not inference:
            raise NotImplementedError("training is not ported yet")
        dtype = self.input_proj[0][0].weight.dtype
        outs, pos = self.backbone(image.to(dtype), mask)

        features, masks, pos_encodings = [], [], []
        for i, (src, m) in enumerate(outs):
            feat = self.input_proj[i](src.permute(0, 3, 1, 2))
            features.append(feat.permute(0, 2, 3, 1))
            masks.append(m)
            pos_encodings.append(pos[i])

        pe = (build_position_encoding(self.backbone.position_encoding,
                                      self.hidden_dim)
              if self.backbone.position_encoding is not None else None)
        last_raw = outs[-1][0].permute(0, 3, 1, 2)
        for i in range(len(features), self.num_level):
            x = (last_raw if i == len(outs)
                 else F.relu(features[-1]).permute(0, 3, 1, 2))
            feat = self.input_proj[i](x).permute(0, 2, 3, 1)
            m = (interpolate_mask_nearest(mask, feat.shape[1:3])
                 if mask is not None else None)
            pos_encodings.append(pe(feat, m, self.ref_size).to(feat.dtype)
                                 if pe is not None else None)
            features.append(feat)
            masks.append(m)

        if postprocess is not None and self.use_mask:
            return self.transformer(features, masks, pos_encodings,
                                    self.enc_detector, detector=self.detector,
                                    postprocess=postprocess)
        hs, roi, dec_ref_windows, *_ = self.transformer(
            features, masks, pos_encodings, self.enc_detector)
        out = self.detector(hs, dec_ref_windows, roi=roi)
        if postprocess is None:
            return out
        return coco_postprocess(out["pred_logits"], out["pred_boxes"], None,
                                canvas_hw=postprocess["canvas_hw"],
                                topk=postprocess.get("topk", 100),
                                scale=postprocess.get("scale"))
