"""Prediction heads; port of `boxer_tpu/nn/predictor.py` (MLP, SegmentMLP,
Detector, and the 3D heads Detector3d and MultiDetector3d).

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


def _permute_7dof(coord):
    """Raw head outputs (x, y, l, w, rad, z, h) -> (x, y, z, l, w, h, rad)."""
    return torch.cat([coord[..., 0:2], coord[..., 5:6], coord[..., 2:4],
                      coord[..., 6:7], coord[..., 4:5]], dim=-1)


def _layer_outputs(outputs_class, outputs_coord, aux_loss: bool):
    """The last layer's {pred_logits, pred_boxes}, with every other layer's
    under aux_outputs."""
    out = {"pred_logits": outputs_class[-1], "pred_boxes": outputs_coord[-1]}
    if aux_loss:
        out["aux_outputs"] = [
            {"pred_logits": outputs_class[i], "pred_boxes": outputs_coord[i]}
            for i in range(outputs_class.shape[0] - 1)]
    return out


def _reset_focal_head(head, g):
    """Prior-prob class bias, zero last box layer (the JAX initialisers)."""
    head.class_embed.bias.data.fill_(-math.log((1 - 0.01) / 0.01))
    last = head.bbox_embed.layers[-1]
    last.weight.data.zero_()
    last.bias.data.zero_()


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

    reset_parameters_ = _reset_focal_head

    def forward(self, x, ref_windows=None, roi=None, x_mask=None,
                defer_mask: bool = False):
        """x: (nl, B, L, C); ref_windows (B, L, 4) or (nl, B, L, 4); roi:
        (nl, B, L, s, s, C) with a mask head, or None with defer_mask=True
        (the caller runs mask_embed on a selected-query subset); x_mask
        (nl, B, L) bool: masked entries get NEG_INF logits and coordinates
        (zero boxes after the sigmoid)."""
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
        if x_mask is not None:
            outputs_class = outputs_class.masked_fill(x_mask[..., None],
                                                      NEG_INF)
            outputs_coord = outputs_coord.masked_fill(x_mask[..., None],
                                                      NEG_INF)
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


class Detector3d(nn.Module):
    """7-DoF box head: the raw (x, y, l, w, rad, z, h) refinement of the
    reference window, permuted to (x, y, z, l, w, h, rad) before the
    sigmoid."""

    def __init__(self, hidden_dim: int, num_classes: int, aux_loss: bool):
        super().__init__()
        self.aux_loss = aux_loss
        self.class_embed = nn.Linear(hidden_dim, num_classes)
        self.bbox_embed = MLP(hidden_dim, hidden_dim, 7, 3)

    reset_parameters_ = _reset_focal_head

    def forward(self, x, ref_windows):
        """x: (nl, B, L, C); ref_windows: (B, L, 7) raw-order boxes in
        [0, 1]."""
        outputs_class = self.class_embed(x)
        outputs_coord = self.bbox_embed(x).float() + inverse_sigmoid(
            ref_windows.float())
        outputs_coord = torch.sigmoid(_permute_7dof(outputs_coord))
        return _layer_outputs(outputs_class, outputs_coord, self.aux_loss)


class MultiDetector3d(nn.Module):
    """Per-cell head over `num_references` reference windows (the encoder's
    proposals): outputs flattened over L * R. References whose centre lies
    outside (0.001, 0.999) get NEG_INF logits and zero boxes."""

    def __init__(self, hidden_dim: int, num_classes: int, num_references: int,
                 aux_loss: bool):
        super().__init__()
        self.aux_loss, self.num_references = aux_loss, num_references
        self.class_embed = nn.Linear(hidden_dim, num_references * num_classes)
        self.bbox_embed = MLP(hidden_dim, hidden_dim, num_references * 7, 3)

    reset_parameters_ = _reset_focal_head

    def forward(self, x, ref_windows):
        """x: (nl, B, L, C); ref_windows: (B, L, >=R, 5) normalized (cx, cy,
        l, w, rad)."""
        nl, b, l = x.shape[:3]
        r = self.num_references
        ref = ref_windows[..., :r, :]
        mask = ~((ref[..., :2] > 0.001) & (ref[..., :2] < 0.999)).all(-1)
        outputs_class = self.class_embed(x).reshape(nl, b, l, r, -1)
        coord = self.bbox_embed(x).float().reshape(nl, b, l, r, 7)
        box = coord[..., :5] + inverse_sigmoid(ref.float())
        coord = _permute_7dof(torch.cat([box, coord[..., 5:]], dim=-1))
        outputs_class = outputs_class.masked_fill(mask[..., None], NEG_INF)
        coord = coord.masked_fill(mask[..., None], NEG_INF)
        outputs_class = outputs_class.reshape(nl, b, l * r, -1)
        outputs_coord = torch.sigmoid(coord.reshape(nl, b, l * r, 7))
        return _layer_outputs(outputs_class, outputs_coord, self.aux_loss)
