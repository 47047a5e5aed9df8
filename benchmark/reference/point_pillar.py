"""PointPillars' pillar feature net and dense BEV scatter, plain, in f32.

A pillar's points are decorated with their offset from the pillar's point
mean and from the pillar's centre, and the raw coordinates stay in f32
into the first layer (the published PointPillars net runs in f32). Each
layer is a Linear, a GroupNorm over a pillar's points and each group's
channels, a ReLU and the max over the pillar's points. Parameter names
are the port's (`pfn_layers.{i}.linear`, `.norm`).

Departures from the published description, each the port's own: the
norm is GroupNorm(32) per pillar (the published net has BatchNorm1d),
with flax's eps 1e-6, its variance taken in two passes over the centred
values; padded points are zeroed before the first layer and their
features, after each norm, excluded from the max.
"""

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

GN_EPS = 1e-6       # flax GroupNorm's epsilon


def group_norm(h, norm: nn.GroupNorm):
    """`norm` on h (V, P, C), statistics per pillar over P and each group's
    channels, two-pass."""
    v, p, c = h.shape
    g = h.reshape(v, p, norm.num_groups, c // norm.num_groups)
    xc = g - g.mean(dim=(1, 3), keepdim=True)
    var = xc.square().mean(dim=(1, 3), keepdim=True)
    out = (xc * torch.rsqrt(var + norm.eps)).reshape(v, p, c)
    return out * norm.weight + norm.bias


class PFNLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 last_layer: bool = True):
        super().__init__()
        self.last_layer = last_layer
        out = out_channels if last_layer else out_channels // 2
        self.linear = nn.Linear(in_channels, out, bias=False)
        self.norm = nn.GroupNorm(min(32, out), out, eps=GN_EPS)

    def forward(self, x, point_mask):
        """x: (V, P, C). Returns (V, 1, out) for the last layer, else (V,
        P, 2 * out): each point's features beside the pillar's max."""
        h = F.relu(group_norm(self.linear(x), self.norm))
        h = h.masked_fill(~point_mask[..., None], -1e9)
        h_max = h.amax(dim=1, keepdim=True)
        if self.last_layer:
            return h_max
        h = h.masked_fill(~point_mask[..., None], 0.0)
        return torch.cat([h, h_max.expand_as(h)], dim=-1)


class PillarFeatureNet(nn.Module):
    def __init__(self, num_input_features: int, num_filters: Sequence[int],
                 voxel_size: Sequence[float], pc_range: Sequence[float]):
        super().__init__()
        self.voxel_size, self.pc_range = tuple(voxel_size), tuple(pc_range)
        ins = [num_input_features + 5] + [2 * (f // 2) for f in num_filters]
        n = len(num_filters)
        self.pfn_layers = nn.ModuleList(
            PFNLayer(ins[i], f, last_layer=i == n - 1)
            for i, f in enumerate(num_filters))

    def forward(self, features, num_points, coords):
        """features: (V, P, F) f32; num_points: (V,); coords: (V, 4) [b, z,
        y, x]. Returns (V, num_filters[-1])."""
        p = features.shape[1]
        xyz = features[:, :, :3]
        mean = xyz.sum(dim=1, keepdim=True) / num_points.float().clamp(
            min=1.0)[:, None, None]
        vx, vy = self.voxel_size[0], self.voxel_size[1]
        cx = coords[:, 3].float()[:, None] * vx + (vx / 2 + self.pc_range[0])
        cy = coords[:, 2].float()[:, None] * vy + (vy / 2 + self.pc_range[1])
        x = torch.cat([features, xyz - mean,
                       torch.stack([features[:, :, 0] - cx,
                                    features[:, :, 1] - cy], dim=-1)], dim=-1)
        point_mask = (torch.arange(p, device=features.device)[None, :]
                      < num_points[:, None])
        x = x.masked_fill(~point_mask[..., None], 0.0)
        for layer in self.pfn_layers:
            x = layer(x, point_mask)
        return x[:, 0]


def scatter(voxel_features, coords, batch_size: int,
            grid: Tuple[int, int]):
    """The dense BEV canvas (B, ny, nx, C): each live pillar's features at
    its cell, zeros elsewhere; rows with b = -1 are padding."""
    nx, ny = grid
    c = voxel_features.shape[-1]
    canvas = voxel_features.new_zeros((batch_size, ny, nx, c))
    live = coords[:, 0] >= 0
    co = coords[live].long()
    canvas[co[:, 0], co[:, 2], co[:, 3]] = voxel_features[live]
    return canvas
