"""ResNet backbone with frozen batch-norm; port of `boxer_tpu/nn/resnet.py`.

Module and parameter names are torchvision's (`conv1`, `bn1`,
`layer3.5.conv2`, `layer1.0.downsample.{0,1}`), which is what the reference
checkpoints hold under `backbone.`. The public functions take and return
NHWC tensors like the JAX package; the convolutions run NCHW inside.
"""

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from boxer_tpu_torch.nn.position_encoding import build_position_encoding


def interpolate_mask_nearest(mask, size: Tuple[int, int]):
    """Nearest resize of a bool mask (B, H, W) -> (B, size[0], size[1]) with
    source index floor(dst * in/out), computed in f32 like the JAX package."""
    b, h, w = mask.shape
    oh, ow = size
    rows = np.floor(np.arange(oh, dtype=np.float32) * np.float32(h / oh))
    cols = np.floor(np.arange(ow, dtype=np.float32) * np.float32(w / ow))
    rows = torch.as_tensor(rows.astype(np.int64), device=mask.device)
    cols = torch.as_tensor(cols.astype(np.int64), device=mask.device)
    return mask[:, rows][:, :, cols]


class FrozenBatchNorm(nn.Module):
    """`y = x * scale + bias` with scale = w / sqrt(var + eps) and
    bias = b - mean * scale, from fixed buffers; NCHW input."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        scale = self.weight.float() * torch.reciprocal(
            torch.sqrt(self.running_var.float() + self.eps))
        bias = self.bias.float() - self.running_mean.float() * scale
        return (x * scale.to(x.dtype)[None, :, None, None]
                + bias.to(x.dtype)[None, :, None, None])


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, has_downsample: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride,
                               padding=dilation, dilation=dilation, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out)
        self.downsample = (nn.Sequential(
            nn.Conv2d(inplanes, out, 1, stride=stride, bias=False),
            FrozenBatchNorm(out)) if has_downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


def _arch_spec(arch: str):
    if arch in ("resnet50", "resnet50_dc5"):
        layers = (3, 4, 6, 3)
    elif arch in ("resnet101", "resnet101_dc5"):
        layers = (3, 4, 23, 3)
    elif arch == "resnet10":
        # one bottleneck per stage; test-size architecture of the JAX package
        layers = (1, 1, 1, 1)
    else:
        raise ValueError(f"Unknown resnet arch: {arch}")
    return layers, (False, False, arch.endswith("_dc5"))


class ResNetBackbone(nn.Module):
    """Torchvision-layout ResNet trunk returning intermediate layers.

    forward(x (B,H,W,3) NHWC, mask (B,H,W) bool or None) ->
    [(feature (B,h,w,C) NHWC, mask (B,h,w) or None)] for `return_layers`.
    """

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 return_layers: Sequence[str] = ("layer2", "layer3", "layer4"),
                 replace_stride_with_dilation: Sequence[bool] = (False,) * 3):
        super().__init__()
        self.return_layers = tuple(sorted(return_layers))
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        inplanes, planes, dilation = 64, 64, 1
        for stage_idx, blocks in enumerate(layers):
            stride = 1 if stage_idx == 0 else 2
            if stage_idx > 0 and replace_stride_with_dilation[stage_idx - 1]:
                dilation *= stride
                stride = 1
            stage = []
            for block_idx in range(blocks):
                stage.append(Bottleneck(
                    inplanes, planes, stride if block_idx == 0 else 1,
                    dilation, has_downsample=block_idx == 0))
                inplanes = planes * Bottleneck.expansion
            setattr(self, f"layer{stage_idx + 1}", nn.Sequential(*stage))
            planes *= 2
        self.num_stages = len(layers)

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs: List[Tuple[torch.Tensor, Optional[torch.Tensor]]] = []
        for i in range(self.num_stages):
            name = f"layer{i + 1}"
            x = getattr(self, name)(x)
            if name in self.return_layers:
                m = (interpolate_mask_nearest(mask, x.shape[2:4])
                     if mask is not None else None)
                outs.append((x.permute(0, 2, 3, 1), m))
        return outs


class BackBone(ResNetBackbone):
    """ResNet trunk + per-level position encodings: returns
    ([(feature NHWC, mask)], [pos NHWC in the feature's dtype])."""

    _CHANNELS = {"layer1": 256, "layer2": 512, "layer3": 1024, "layer4": 2048}

    def __init__(self, arch: str = "resnet50",
                 return_layers: Sequence[str] = ("layer2", "layer3", "layer4"),
                 position_encoding: Optional[str] = "fixed_box",
                 hidden_dim: int = 256, ref_size: int = 4):
        layers, dilation = _arch_spec(arch)
        super().__init__(layers, return_layers, dilation)
        self.position_encoding = position_encoding
        self.hidden_dim = hidden_dim
        self.ref_size = ref_size

    @property
    def num_channels(self) -> List[int]:
        return [self._CHANNELS[name] for name in self.return_layers]

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        outs = super().forward(x, mask)
        if self.position_encoding is None:
            return outs, [None] * len(outs)
        pe = build_position_encoding(self.position_encoding, self.hidden_dim)
        pos = [pe(feat, m, self.ref_size).to(feat.dtype) for feat, m in outs]
        return outs, pos
