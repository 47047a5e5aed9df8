"""DETR, the baseline detector; port of `boxer_tpu/models/detr.py`.

A ResNet trunk's C5 feature with the sine position encoding, a 1x1
`input_proj` to the hidden width, the transformer of `nn/transformer.py`
over learned queries (`query_embed`), a softmax class head over
num_classes + 1 columns (the last is no object) and a 3-layer box MLP,
every decoder layer's outputs under `aux_outputs` in training. Parameter
names are the reference e2edet ones.
"""

from typing import Optional

import torch
from torch import nn

from boxer_tpu_torch.models import register_model
from boxer_tpu_torch.nn.dropout import name_sites
from boxer_tpu_torch.nn.init import reset_default_
from boxer_tpu_torch.nn.predictor import MLP, _layer_outputs
from boxer_tpu_torch.nn.resnet import BackBone
from boxer_tpu_torch.nn.transformer import Transformer


@register_model("detr")
class DETR(nn.Module):
    def __init__(self, num_classes: int = 91, hidden_dim: int = 256,
                 nhead: int = 8, enc_layers: int = 6, dec_layers: int = 6,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 num_queries: int = 100, aux_loss: bool = True,
                 backbone_arch: str = "resnet50"):
        super().__init__()
        self.dropout, self.aux_loss = dropout, aux_loss
        self.backbone = BackBone(backbone_arch, ("layer4",), "fixed",
                                 hidden_dim)
        self.input_proj = nn.Conv2d(self.backbone.num_channels[-1],
                                    hidden_dim, 1)
        self.query_embed = nn.Embedding(num_queries, hidden_dim)
        self.transformer = Transformer(
            d_model=hidden_dim, nhead=nhead, num_encoder_layers=enc_layers,
            num_decoder_layers=dec_layers, dim_feedforward=dim_feedforward,
            dropout=dropout)
        self.class_embed = nn.Linear(hidden_dim, num_classes + 1)
        self.bbox_embed = MLP(hidden_dim, hidden_dim, 4, 3)
        name_sites(self)

    @classmethod
    def from_config(cls, config, num_classes: int):
        t = config["transformer"]["params"]
        return cls(num_classes=num_classes, hidden_dim=config["hidden_dim"],
                   nhead=t["nhead"], enc_layers=t["enc_layers"],
                   dec_layers=t["dec_layers"],
                   dim_feedforward=t["dim_feedforward"], dropout=t["dropout"],
                   num_queries=t["num_queries"], aux_loss=config["aux_loss"],
                   backbone_arch=config["backbone"]["type"])

    def reset_parameters_(self, g: torch.Generator):
        """The queries' N(0, 1), as the JAX package initialises them."""
        with torch.no_grad():
            self.query_embed.weight.copy_(torch.randn(
                self.query_embed.weight.shape, generator=g))

    def init_weights(self, seed: int = 0):
        """Fill every parameter from `torch.Generator().manual_seed(seed)`."""
        reset_default_(self, torch.Generator().manual_seed(seed))
        return self

    def forward(self, image, mask: Optional[torch.Tensor] = None,
                train: bool = False, inference: bool = True,
                dropout_key=None):
        """image: (B, H, W, 3) NHWC normalized; mask: (B, H, W) bool, True =
        padded, or None. Returns pred_logits (B, NQ, num_classes + 1),
        pred_boxes (B, NQ, 4) cxcywh in [0, 1], and with inference=False
        every other decoder layer's under aux_outputs. In training at
        dropout > 0 `dropout_key` (`nn/dropout.py`) is required."""
        if train and self.dropout > 0 and dropout_key is None:
            raise ValueError(f"dropout {self.dropout} in training needs a "
                             "dropout_key")
        dtype = self.input_proj.weight.dtype
        outs, pos = self.backbone(image.to(dtype), mask)
        feat, feat_mask = outs[-1]
        src = self.input_proj(feat.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        hs = self.transformer(src, feat_mask, self.query_embed.weight,
                              pos[-1], inference=inference,
                              dropout_key=dropout_key if train else None)
        outputs_class = self.class_embed(hs)
        outputs_coord = torch.sigmoid(self.bbox_embed(hs).float())
        return _layer_outputs(outputs_class, outputs_coord,
                              self.aux_loss and not inference)
