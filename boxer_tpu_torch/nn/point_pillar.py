"""PointPillars: the pillar feature net and the dense BEV scatter; port of
`boxer_tpu/nn/point_pillar.py`.

Fixed-capacity voxel tensors (V, P, F) with per-voxel point counts, as the
voxelizer and `pad_voxels` emit them. Parameter names are the reference
PointPillars ones (`reader.pfn_layers.{i}.linear`, `.norm`). The norm is
flax's GroupNorm on (V, P, C): statistics per voxel over its P points
(masked points, zeroed, included) and each group's channels, eps 1e-6.

One difference from the JAX package, by design: the norm takes its
variance in two passes, and its gradient on centred values (`group_norm`).
A one-point pillar's masked rows all repeat the pillar's max, so a group
can be near-constant over its points; flax's default one-pass variance,
E[x²] - E[x]², and torch's fused GroupNorm backward, Σ dy·x - mean·Σ dy,
both cancel there and lose the digits, where the two-pass form keeps
them (`tests/test_torch_boxer3d.py` holds the port to flax's pillar net
run in float64, and a train step on one-point pillars to its float64
run).

A second, also by design: the decorated points reach the first PFN layer
in f32, and that layer (its Linear, norm and max) runs in f32 whatever the
weights' type and with autocast off; its output takes the next layer's
type. The decoration holds the raw x and y of each point, up to 75 m in
Waymo's range, where bf16's spacing is 0.5 m against a pillar 0.32 m
wide: rounded before the Linear, every point of a far pillar moves by the
same error, which no later layer averages away. The JAX package casts
them to the Dense's type (flax promotes the input), so a bf16 model there
rounds them; `tests/test_torch_boxer3d_reference.py` holds the port's
bf16 and autocast pillar nets to their f32 run on far frames, which that
cast does not meet.
"""

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from boxer_tpu_torch.nn.init import xavier_uniform_

GN_EPS = 1e-6       # flax GroupNorm's epsilon


def group_norm(h, norm: nn.GroupNorm):
    """`norm` on h (V, P, C), statistics per voxel over P and each group's
    channels, in f32 at least and in two passes, written out so that
    autograd's backward works on the centred values too. The output's type
    is h's and the weight's promoted (f32 under autocast, as torch's
    GroupNorm)."""
    v, p, c = h.shape
    acc = torch.promote_types(h.dtype, torch.float32)
    g = h.to(acc).reshape(v, p, norm.num_groups, c // norm.num_groups)
    xc = g - g.mean(dim=(1, 3), keepdim=True)
    var = xc.square().mean(dim=(1, 3), keepdim=True)
    out = (xc * torch.rsqrt(var + norm.eps)).reshape(v, p, c)
    out = out * norm.weight.to(acc) + norm.bias.to(acc)
    return out.to(torch.promote_types(h.dtype, norm.weight.dtype))


class PFNLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 last_layer: bool = True):
        super().__init__()
        self.last_layer = last_layer
        out = out_channels if last_layer else out_channels // 2
        self.linear = nn.Linear(in_channels, out, bias=False)
        self.norm = nn.GroupNorm(min(32, out), out, eps=GN_EPS)

    def reset_parameters_(self, g):
        xavier_uniform_(self.linear.weight, g)

    def forward(self, x, point_mask, weight=None):
        """x: (V, P, C); point_mask: (V, P) bool; weight: the Linear's
        kernel in another type (the first layer's in f32), else its own.
        Returns (V, 1, out) for the last layer, else (V, P, 2 * out): the
        masked points' features beside the voxel's max."""
        h = self.linear(x) if weight is None else F.linear(x, weight)
        h = F.relu(group_norm(h, self.norm))
        h = h.masked_fill(~point_mask[..., None], -1e9)
        h_max = h.amax(dim=1, keepdim=True)
        if self.last_layer:
            return h_max
        h = h.masked_fill(~point_mask[..., None], 0.0)
        return torch.cat([h, h_max.expand_as(h)], dim=-1)


class PillarFeatureNet(nn.Module):
    """Decorates each point with its offset from the pillar's point mean and
    from the pillar's centre, then runs the PFN layers. The decoration and
    the first PFN layer run in f32 whatever the input's, the weights' or
    autocast's type (module docstring); the layers after it in their
    weights' type, or autocast's."""

    def __init__(self, num_input_features: int = 4,
                 num_filters: Sequence[int] = (64,),
                 voxel_size: Sequence[float] = (0.2, 0.2, 4),
                 pc_range: Sequence[float] = (0, -40, -3, 70.4, 40, 1)):
        super().__init__()
        self.voxel_size, self.pc_range = tuple(voxel_size), tuple(pc_range)
        ins = [num_input_features + 5] + [2 * (f // 2) for f in num_filters]
        n = len(num_filters)
        self.pfn_layers = nn.ModuleList(
            PFNLayer(ins[i], f, last_layer=i == n - 1)
            for i, f in enumerate(num_filters))

    def forward(self, features, num_voxels, coors):
        """features: (V, P, F); num_voxels: (V,) points per pillar; coors:
        (V, 4) [b, z, y, x]. Returns (V, num_filters[-1])."""
        features = features.float()
        p = features.shape[1]
        denom = num_voxels.float().clamp(min=1.0)
        points_mean = features[:, :, :3].sum(dim=1, keepdim=True) / denom[
            :, None, None]
        f_cluster = features[:, :, :3] - points_mean
        vx, vy = self.voxel_size[0], self.voxel_size[1]
        x_offset = vx / 2 + self.pc_range[0]
        y_offset = vy / 2 + self.pc_range[1]
        fx = features[:, :, 0] - (coors[:, 3].float()[:, None] * vx + x_offset)
        fy = features[:, :, 1] - (coors[:, 2].float()[:, None] * vy + y_offset)
        x = torch.cat([features, f_cluster, torch.stack([fx, fy], dim=-1)],
                      dim=-1)
        point_mask = (torch.arange(p, device=features.device)[None, :]
                      < num_voxels[:, None])
        x = x.masked_fill(~point_mask[..., None], 0.0)
        first, *rest = self.pfn_layers
        with torch.autocast(x.device.type, enabled=False):
            x = first(x, point_mask, weight=first.linear.weight.float())
        x = x.to(first.linear.weight.dtype)
        for layer in rest:
            x = layer(x, point_mask)
        return x.squeeze(1)


class PointPillarsScatter(nn.Module):
    def forward(self, voxel_features, coords, batch_size: int,
                input_shape: Tuple[int, int]):
        """voxel_features: (V, C); coords: (V, 4) [b, z, y, x], b = -1 for
        padding voxels; input_shape: (nx, ny). Returns the dense canvas
        (B, ny, nx, C) NHWC. No two live voxels may share a cell (the
        voxelizer never emits two): which one a card keeps is unspecified,
        as in XLA. Padding voxels go to an extra row that is dropped."""
        nx, ny = int(input_shape[0]), int(input_shape[1])
        c = voxel_features.shape[-1]
        total = batch_size * ny * nx
        b = coords[:, 0].long()
        lin = b * (ny * nx) + coords[:, 2].long() * nx + coords[:, 3].long()
        lin = torch.where(b >= 0, lin, total)
        canvas = voxel_features.new_zeros((total + 1, c)).index_copy(
            0, lin, voxel_features)
        return canvas[:total].reshape(batch_size, ny, nx, c)
