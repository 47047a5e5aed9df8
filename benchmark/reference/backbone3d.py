"""The BEV backbone of BoxeR-3D: the pillar net, the dense scatter and the
ConvNet neck, with the sine position encoding of each returned level.

The neck is stages of 3x3 convolutions, each followed by GroupNorm(32)
and a ReLU, the first of stage i at stride ds_strides[i] (the port's
GroupNorm in place of the published BatchNorm, flax's eps 1e-6).
Parameter names are the port's (`reader.pfn_layers.{i}`,
`neck.blocks.{i}.{3j}` for the j-th conv of stage i, `.{3j+1}` its norm).
"""

import math
from typing import Sequence

import torch
from torch import nn

from .point_pillar import GN_EPS, PillarFeatureNet, scatter

EPS = 1e-6


class ConvNet(nn.Module):
    def __init__(self, in_channels: int, num_layers: Sequence[int],
                 ds_strides: Sequence[int], ds_filters: Sequence[int]):
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

    def forward(self, x):
        """x: (B, C, H, W). Returns every stage's output."""
        outs = []
        for block in self.blocks:
            x = block(x)
            outs.append(x)
        return outs


def sine_position(x, num_pos_feats: int):
    """DETR's sine encoding of each cell's normalized centre, (B, H, W,
    2 * num_pos_feats) f32, the x channels first. x: (B, H, W, C)."""
    b, h, w = x.shape[:3]
    dev = x.device
    y = torch.arange(1, h + 1, dtype=torch.float32, device=dev)
    xs = torch.arange(1, w + 1, dtype=torch.float32, device=dev)
    y = (y - 0.5) / (h + EPS) * 2 * math.pi
    xs = (xs - 0.5) / (w + EPS) * 2 * math.pi
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=dev)
    dim_t = 10000.0 ** (2.0 * torch.floor(dim_t / 2.0) / num_pos_feats)

    def embed(v):
        pos = v[:, None] / dim_t
        return torch.stack([pos[:, 0::2].sin(), pos[:, 1::2].cos()],
                           dim=-1).reshape(len(v), num_pos_feats)

    px = embed(xs)[None, :, :].expand(h, w, num_pos_feats)
    py = embed(y)[:, None, :].expand(h, w, num_pos_feats)
    return torch.cat([px, py], dim=-1)[None].expand(b, h, w, -1)


class Backbone3d(nn.Module):
    def __init__(self, hidden_dim: int, reader: dict, neck: dict,
                 return_layers: int):
        super().__init__()
        self.hidden_dim, self.return_layers = hidden_dim, return_layers
        self.reader = PillarFeatureNet(**reader)
        self.neck = ConvNet(reader["num_filters"][-1], **neck)
        self.num_channels = list(neck["ds_filters"])[-return_layers:]

    def forward(self, voxels, coords, num_points, batch_size: int, grid):
        """Returns ([NHWC feature of each returned level], [its position
        encoding])."""
        canvas = scatter(self.reader(voxels, num_points, coords), coords,
                         batch_size, grid)
        outs = [x.permute(0, 2, 3, 1) for x in self.neck(
            canvas.permute(0, 3, 1, 2))[-self.return_layers:]]
        return outs, [sine_position(x, self.hidden_dim // 2).to(x.dtype)
                      for x in outs]
