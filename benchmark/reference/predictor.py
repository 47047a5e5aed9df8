"""Prediction heads: MLP, the mask head SegmentMLP, and the class and box
head Detector. Parameter names are the port's (`bbox_embed.layers.{j}`,
`mask_embed.layers.{0.0, 1.0, 2}`).
"""

import torch
import torch.nn.functional as F
from torch import nn

from .general import inverse_sigmoid

NEG_INF = -65504.0  # largest finite fp16 magnitude (reference parity)


class MLP(nn.Module):
    """ReLU MLP."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            nn.Linear(i, o) for i, o in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class _SelectableConv1x1(nn.Conv2d):
    """1×1 conv whose output channel can be chosen per sample: with
    ``select`` (N,) only column sel[n] of the kernel is applied to sample n,
    equal to computing all channels and gathering one."""

    def __init__(self, in_channels: int, features: int):
        super().__init__(in_channels, features, 1)

    def forward(self, h, select=None):
        """h: (N, C, X, Y) -> (N, features, X, Y), or (N, X, Y) with select."""
        if select is None:
            return super().forward(h)
        w_sel = self.weight[select, :, 0, 0]                   # (N, C)
        out = torch.einsum("ncxy,nc->nxy", h, w_sel)
        return out + self.bias[select][:, None, None]


class SegmentMLP(nn.Module):
    """Mask head: 2× upsample (ConvTranspose 2×2/2) + 1×1 convs.

    x: (nl, B, L, s, s, C) -> (nl, B, L, out, 2s, 2s), or (nl, B, L, 2s, 2s)
    when ``select`` (nl*B*L,) picks one output channel per query.
    """

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 2, kernel_size: int = 1):
        super().__init__()
        layers = [nn.Sequential(
            nn.ConvTranspose2d(input_dim, hidden_dim, 2, stride=2), nn.ReLU())]
        for _ in range(num_layers - 1):
            layers.append(nn.Sequential(
                nn.Conv2d(hidden_dim, hidden_dim, kernel_size,
                          padding=kernel_size // 2), nn.ReLU()))
        layers.append(_SelectableConv1x1(hidden_dim, output_dim))
        self.layers = nn.ModuleList(layers)

    def forward(self, x, select=None):
        n, b, l, s, _, c = x.shape
        h = x.reshape(n * b * l, s, s, c).permute(0, 3, 1, 2)
        for layer in self.layers[:-1]:
            h = layer(h)
        h = self.layers[-1](h, select=select)
        if select is not None:
            return h.reshape(n, b, l, 2 * s, 2 * s)
        return h.reshape(n, b, l, -1, 2 * s, 2 * s)


class Detector(nn.Module):
    """Class, box and mask heads; the box refines its reference window."""

    def __init__(self, hidden_dim: int, num_classes: int,
                 with_mask: bool = False):
        super().__init__()
        self.class_embed = nn.Linear(hidden_dim, num_classes)
        self.bbox_embed = MLP(hidden_dim, hidden_dim, 4, 3)
        if with_mask:
            self.mask_embed = SegmentMLP(hidden_dim, hidden_dim, num_classes, 2)

    def forward(self, x, ref_windows):
        """x: (B, L, C); ref_windows (B, L, 4). Returns the class logits
        (B, L, classes) and the boxes (B, L, 4), cxcywh in [0, 1]."""
        coord = self.bbox_embed(x).float() + inverse_sigmoid(
            ref_windows.float())
        return self.class_embed(x), torch.sigmoid(coord)
