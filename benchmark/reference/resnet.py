"""ResNet backbone with frozen batch-norm. Module and parameter names are
torchvision's (`conv1`, `bn1`, `layer3.5.conv2`, `layer1.0.downsample.
{0,1}`), as the port's. It takes and returns NHWC tensors; the
convolutions run NCHW inside.
"""

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .position_encoding import fixed_box_embedding


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
                 has_downsample: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
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


# bottleneck blocks a stage; resnet10 is the tests' size
ARCHS = {"resnet50": (3, 4, 6, 3), "resnet10": (1, 1, 1, 1)}
RETURN_LAYERS = ("layer2", "layer3", "layer4")
CHANNELS = (512, 1024, 2048)


class BackBone(nn.Module):
    """ResNet trunk + box-shaped position encodings: forward(x (B,H,W,3)
    NHWC, mask (B,H,W) bool or None) -> ([(feature NHWC, mask)] of
    layer2-4, [pos NHWC in the feature's dtype])."""

    num_channels = list(CHANNELS)

    def __init__(self, arch: str = "resnet50", hidden_dim: int = 256,
                 ref_size: int = 4):
        super().__init__()
        self.hidden_dim, self.ref_size = hidden_dim, ref_size
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        inplanes, planes = 64, 64
        for stage_idx, blocks in enumerate(ARCHS[arch]):
            stride = 1 if stage_idx == 0 else 2
            stage = []
            for block_idx in range(blocks):
                stage.append(Bottleneck(
                    inplanes, planes, stride if block_idx == 0 else 1,
                    has_downsample=block_idx == 0))
                inplanes = planes * Bottleneck.expansion
            setattr(self, f"layer{stage_idx + 1}", nn.Sequential(*stage))
            planes *= 2

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs: List[Tuple[torch.Tensor, Optional[torch.Tensor]]] = []
        for i in range(4):
            name = f"layer{i + 1}"
            x = getattr(self, name)(x)
            if name in RETURN_LAYERS:
                m = (interpolate_mask_nearest(mask, x.shape[2:4])
                     if mask is not None else None)
                outs.append((x.permute(0, 2, 3, 1), m))
        pos = [fixed_box_embedding(feat, m, self.hidden_dim,
                                   self.ref_size).to(feat.dtype)
               for feat, m in outs]
        return outs, pos
