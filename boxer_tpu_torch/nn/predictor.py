"""Prediction heads; port of `boxer_tpu/nn/predictor.py` (MLP, SegmentMLP,
Detector).

Decoder states are stacked over layers with a leading ``nl`` dim:
x (nl, B, L, C); ref_windows (B, L, 4). Parameter names are the reference
e2edet ones (`bbox_embed.layers.{j}`, `mask_embed.layers.{0.0, 1.0, 2}`).
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from boxer_tpu_torch.utils.general import inverse_sigmoid

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
    """Class + box (+ mask) head with box refinement, focal-loss style:
    num_classes outputs with the prior-prob bias.

    mask_mode: none | mask_v1 (per-class masks, the channel at each query's
    argmax class).
    """

    def __init__(self, hidden_dim: int, num_classes: int, aux_loss: bool,
                 mask_mode: str = "none"):
        super().__init__()
        assert mask_mode in ("none", "mask_v1")
        self.aux_loss, self.mask_mode = aux_loss, mask_mode
        self.class_embed = nn.Linear(hidden_dim, num_classes)
        self.bbox_embed = MLP(hidden_dim, hidden_dim, 4, 3)
        if mask_mode == "mask_v1":
            self.mask_embed = SegmentMLP(hidden_dim, hidden_dim, num_classes, 2)

    def reset_parameters_(self, g):
        self.class_embed.bias.data.fill_(-math.log((1 - 0.01) / 0.01))
        last = self.bbox_embed.layers[-1]
        last.weight.data.zero_()
        last.bias.data.zero_()

    def forward(self, x, ref_windows=None, roi=None, defer_mask: bool = False):
        """x: (nl, B, L, C); ref_windows (B, L, 4) or (nl, B, L, 4); roi:
        (nl, B, L, s, s, C) with a mask head, or None with defer_mask=True
        (the caller runs mask_embed on a selected-query subset)."""
        outputs_class = self.class_embed(x)
        outputs_coord = self.bbox_embed(x).float()

        outputs_mask = None
        if self.mask_mode == "mask_v1":
            if roi is None:
                assert defer_mask, (
                    "roi is required with a mask head unless defer_mask=True "
                    "(deferred top-k mask decode)")
            else:
                top = outputs_class.argmax(dim=-1)              # (nl, B, L)
                outputs_mask = self.mask_embed(roi, select=top.reshape(-1))

        if ref_windows is not None:
            assert ref_windows.shape[-1] == 4
            outputs_coord = outputs_coord + inverse_sigmoid(ref_windows.float())
        outputs_coord = torch.sigmoid(outputs_coord)

        out = {"pred_logits": outputs_class[-1], "pred_boxes": outputs_coord[-1]}
        if outputs_mask is not None:
            out["pred_masks"] = outputs_mask[-1]
        if self.aux_loss:
            aux = []
            for i in range(x.shape[0] - 1):
                a = {"pred_logits": outputs_class[i],
                     "pred_boxes": outputs_coord[i]}
                if outputs_mask is not None:
                    a["pred_masks"] = outputs_mask[i]
                aux.append(a)
            out["aux_outputs"] = aux
        return out
