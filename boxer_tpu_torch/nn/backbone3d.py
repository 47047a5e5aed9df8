"""3D (BEV) backbone: PillarFeatureNet -> dense scatter -> ConvNet neck; port
of `boxer_tpu/nn/backbone3d.py`.

Feature maps are NHWC at the interfaces, as in the JAX package. The neck
takes the canvas as a channels-last (B, C, H, W) view, and in training
runs its modules on it, in the layouts torch gives them. At inference
(`ConvNet.forward(inference=True)`) it stays channels-last from the canvas
to its outputs: each convolution runs on the channels-last tensor, and its
output's NHWC view goes through `ops/group_norm.py:group_norm_relu`, on the
card the hand-written K11 (`csrc/group_norm_relu.cu`: the GroupNorm and
the ReLU in two passes over NHWC), so the returned levels are
NHWC-contiguous. Parameter names, on either route: `reader.pfn_layers.{i}`,
`neck.blocks.{i}.{3j}` (the j-th 3x3 conv of stage i) and `.{3j+1}` (its
GroupNorm, flax's eps 1e-6). Spans (`utils/timer.py:span`): `boxer.pillars`
around the pillar net and the BEV scatter, `boxer.neck` around the ConvNet,
and inside it at inference `boxer.neck.norm` around each call of
`group_norm_relu`.
"""

from typing import Sequence, Tuple

import torch
from torch import nn

from boxer_tpu_torch.nn.init import he_normal_
from boxer_tpu_torch.nn.point_pillar import (GN_EPS, PillarFeatureNet,
                                             PointPillarsScatter)
from boxer_tpu_torch.nn.position_encoding import build_position_encoding
from boxer_tpu_torch.ops.group_norm import group_norm_relu
from boxer_tpu_torch.utils.timer import span


class ConvNet(nn.Module):
    """Stages of 3x3 conv + GroupNorm(32) + ReLU, the first conv of stage i
    at stride ds_strides[i]; returns every stage's output as (B, C, H, W),
    channels-last at inference."""

    def __init__(self, in_channels: int, num_layers: Sequence[int] = (2, 3, 3),
                 ds_strides: Sequence[int] = (1, 2, 2),
                 ds_filters: Sequence[int] = (256, 512, 1024)):
        super().__init__()
        blocks = []
        for n, s, f in zip(num_layers, ds_strides, ds_filters):
            layers = []
            for j in range(n):
                layers += [nn.Conv2d(in_channels, f, 3, stride=s if j == 0
                                     else 1, padding=1, bias=False),
                           nn.GroupNorm(32, f, eps=GN_EPS), nn.ReLU()]
                in_channels = f
            blocks.append(nn.Sequential(*layers))
        self.blocks = nn.ModuleList(blocks)

    def reset_parameters_(self, g):
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                he_normal_(mod.weight, g)

    def forward(self, x, inference: bool = False):
        """x: (B, C, H, W). With `inference` every GroupNorm + ReLU is one
        call of `group_norm_relu` on the NHWC view of its convolution's
        channels-last output; it has no backward. Otherwise the modules."""
        outs = []
        if inference:
            x = x.contiguous(memory_format=torch.channels_last)
        for block in self.blocks:
            if not inference:
                x = block(x)
            else:
                for conv, norm in zip(block[0::3], block[1::3]):
                    x = conv(x)
                    with span("boxer.neck.norm"):
                        x = group_norm_relu(x.permute(0, 2, 3, 1),
                                            norm.weight, norm.bias,
                                            norm.eps).permute(0, 3, 1, 2)
            outs.append(x)
        return outs


class Backbone3d(nn.Module):
    """The pillar reader, the BEV scatter and the ConvNet neck; the last
    `return_layers` neck stages with their position encodings. With
    `inference` the reader runs K10 on the card, one launch for the whole
    pillar net (`nn/point_pillar.py`), and the neck K11 for each GroupNorm
    + ReLU; training runs their torch paths."""

    def __init__(self, hidden_dim: int, reader_cfg: dict, neck_cfg: dict,
                 ref_size: int, position_encoding: str, return_layers: int):
        super().__init__()
        self.hidden_dim, self.ref_size = hidden_dim, ref_size
        self.position_encoding, self.return_layers = (position_encoding,
                                                      return_layers)
        self.reader = PillarFeatureNet(**reader_cfg)
        self.extractor = PointPillarsScatter()
        c = self.reader.pfn_layers[-1].linear.out_features
        self.neck = ConvNet(c, **neck_cfg)
        self.num_channels = list(neck_cfg["ds_filters"])[-return_layers:]

    def forward(self, voxels, coordinates, num_points_per_voxel,
                batch_size: int, input_shape: Tuple[int, int],
                inference: bool = False):
        """Returns ([(feature NHWC, None)] of the last `return_layers`
        levels, [position encoding NHWC])."""
        with span("boxer.pillars"):
            feats = self.reader(voxels, num_points_per_voxel, coordinates,
                                inference=inference)
            canvas = self.extractor(feats, coordinates, batch_size,
                                    input_shape)
        with span("boxer.neck"):
            outs = [(x.permute(0, 2, 3, 1), None) for x in self.neck(
                canvas.permute(0, 3, 1, 2), inference=inference)[
                    -self.return_layers:]]
        pe = build_position_encoding(self.position_encoding, self.hidden_dim)
        return outs, [pe(x, None, self.ref_size).to(x.dtype) for x, _ in outs]


def build_backbone3d(config) -> Backbone3d:
    """From a `{"type": "pointpillar", "params": {...}}` config that names
    the reader, the neck and the position encoding, as the shipped Waymo
    config does."""
    params = config["params"]
    assert config["type"] == "pointpillar", config["type"]
    neck, reader = params["neck"], params["reader"]
    return Backbone3d(
        hidden_dim=params["hidden_dim"],
        reader_cfg={k: reader[k] if k == "num_input_features"
                    else tuple(reader[k]) for k in (
                        "num_input_features", "num_filters", "voxel_size",
                        "pc_range")},
        neck_cfg={k: tuple(neck[k])
                  for k in ("num_layers", "ds_strides", "ds_filters")},
        ref_size=params.get("ref_size", 4),
        position_encoding=params["position_encoding"],
        return_layers=params.get("return_layers", 2))
