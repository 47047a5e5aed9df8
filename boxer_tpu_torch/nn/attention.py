"""Box / instance / rotated 3D box attention modules; port of
`boxer_tpu/nn/attention.py` (inference and training paths).

Parameter names are the reference e2edet ones: `linear_box_weight`,
`linear_box_bias`, `linear_attn_weight`, `linear_attn_bias` as raw
parameters, `value_proj` and `out_proj` as Linears.

Tensor parallel (`tp`, the mp axis, set by `parallel/sharding.py:
shard_model`): a rank holds `num_head` = H / mp heads: its rows of
`value_proj`, `linear_box_*` and `linear_attn_*` (head-major, as the
reshapes below read them) and its columns of `out_proj`, a `RowLinear`
that sums the heads' products over mp, and its heads' reference windows
where they are given per head. The query and the value enter through
`copy_to_mp`. Sequence parallel: with `tokens` (`parallel/
collectives.py:Tokens`) the value holds this rank's tokens and is
gathered over sp after `value_proj`, so this rank's queries sample the
whole quad tables.
"""

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from boxer_tpu_torch.nn.init import uniform_, xavier_uniform_
from boxer_tpu_torch.ops.box_attention import (box_attention_qminor,
                                               instance_attention_qminor)
from boxer_tpu_torch.parallel.collectives import (RowLinear, column_input,
                                                  gather_tokens)

Shapes = Tuple[Tuple[int, int], ...]


def make_kernel_indices(kernel_size: int, divisor: Optional[float] = None):
    """Normalized k×k tap offsets (k*k, 2) as (x, y) f32: even k centers at
    ±(i+0.5), odd k integer offsets, divided by `divisor` (default k)."""
    if divisor is None:
        divisor = float(kernel_size)
    if kernel_size % 2 == 0:
        start, end = -kernel_size // 2 + 0.5, kernel_size // 2 - 0.5
    else:
        start, end = -(kernel_size - 1) // 2, (kernel_size - 1) // 2
    indices = np.linspace(start, end, kernel_size).astype(np.float32)
    i, j = np.meshgrid(indices, indices, indexing="ij")
    k = np.stack([j, i], axis=-1).reshape(-1, 2) / np.float32(divisor)
    return torch.from_numpy(k.astype(np.float32))


class HeadMergeDense(RowLinear):
    """Output projection that also takes the sampling op's raw
    (B, H, LQ, C) layout (`raw`)."""

    def raw(self, x):
        b, nh, lq, ch = x.shape
        return self(x.permute(0, 2, 1, 3).reshape(b, lq, nh * ch))


def _qminor_ref_parts(ref_windows):
    """ref_windows (B, LQ, D) or (B, LQ, H, D) -> D tensors, each (B, 1|H,
    1, LQ), broadcastable against (B, H, L, LQ)."""
    ref_t = torch.movedim(ref_windows, 1, -1)     # (B, D, LQ) or (B, H, D, LQ)
    if ref_windows.dim() == 3:
        return [ref_t[:, None, None, i] for i in range(ref_t.shape[1])]
    return [ref_t[:, :, None, i] for i in range(ref_t.shape[2])]


def _offsets(module, query):
    """The predicted box variables, (B, H, L, num_variable, LQ) f32."""
    b, lq = query.shape[:2]
    offset = F.linear(query, module.linear_box_weight, module.linear_box_bias)
    return torch.movedim(offset, 1, -1).float().reshape(
        b, module.num_head, module.num_level, module.num_variable, lq)


def _valid_scaled(gx, gy, v_valid_ratios):
    if v_valid_ratios is not None:
        gx = gx * v_valid_ratios[:, None, :, None, None, 0]
        gy = gy * v_valid_ratios[:, None, :, None, None, 1]
    return gx, gy


def _where_to_attend(module, query, v_valid_ratios, ref_windows):
    """Query-minor sampling grid (gx, gy), each (B, H, L, P, LQ) f32;
    ref_windows (B, LQ, 4) cxcywh."""
    off = _offsets(module, query)
    dx, dy, dw, dh = off[:, :, :, 0], off[:, :, :, 1], off[:, :, :, 2], \
        off[:, :, :, 3]                                  # (B, H, L, LQ)

    rcx, rcy, rw, rh = _qminor_ref_parts(ref_windows)
    cx = rcx + dx / 8.0 * rw
    cy = rcy + dy / 8.0 * rh
    sw = F.relu(rw + dw / 8.0 * rw)
    sh = F.relu(rh + dh / 8.0 * rh)

    kernel = make_kernel_indices(module.kernel_size).to(query.device)
    kx = kernel[:, 0][None, None, None, :, None]
    ky = kernel[:, 1][None, None, None, :, None]
    gx = cx[:, :, :, None, :] + kx * sw[:, :, :, None, :]
    gy = cy[:, :, :, None, :] + ky * sh[:, :, :, None, :]
    return _valid_scaled(gx, gy, v_valid_ratios)


class _SamplingAttention(nn.Module):
    """Parameters shared by box and instance attention."""
    tp = None

    def __init__(self, d_model: int, num_level: int, num_head: int,
                 kernel_size: int, n_attn: int, num_variable: int = 4):
        super().__init__()
        assert d_model % num_head == 0
        self.d_model, self.num_level, self.num_head = d_model, num_level, num_head
        self.kernel_size, self.num_variable = kernel_size, num_variable
        self.head_dim = d_model // num_head
        n_box = num_head * num_level * num_variable
        self.value_proj = nn.Linear(d_model, d_model)
        self.out_proj = HeadMergeDense(d_model, d_model)
        self.linear_box_weight = nn.Parameter(torch.zeros(n_box, d_model))
        self.linear_box_bias = nn.Parameter(torch.zeros(n_box))
        self.linear_attn_weight = nn.Parameter(torch.zeros(n_attn, d_model))
        self.linear_attn_bias = nn.Parameter(torch.zeros(n_attn))

    def reset_parameters_(self, g):
        xavier_uniform_(self.value_proj.weight, g)
        xavier_uniform_(self.out_proj.weight, g)
        self.value_proj.bias.data.zero_()
        self.out_proj.bias.data.zero_()
        self.linear_box_weight.data.zero_()
        uniform_(self.linear_box_bias, g)
        self.linear_attn_weight.data.zero_()
        self.linear_attn_bias.data.zero_()

    def _enter(self, query, value):
        """query and value as the column-parallel projections take them."""
        return column_input(query, self.tp), column_input(value, self.tp)

    def _own_heads(self, ref_windows):
        """Reference windows given per head, (B, LQ, H, D): this rank's."""
        if self.tp is None or ref_windows.dim() == 3:
            return ref_windows
        return ref_windows.narrow(2, self.tp.index * self.num_head,
                                  self.num_head)

    def _project_value(self, value, v_mask, tokens=None):
        """(B, S, heads, Ch); with `tokens` gathered over sp."""
        value = self.value_proj(value)
        if v_mask is not None:
            value = value.masked_fill(v_mask[..., None], 0.0)
        if tokens is not None:
            value = gather_tokens(value, tokens)
        b, l2 = value.shape[:2]
        return value.reshape(b, l2, self.num_head, self.head_dim)


class BoxAttention(_SamplingAttention):
    """Multi-scale box attention (k=2 -> 4 taps per level)."""

    def __init__(self, d_model: int, num_level: int, num_head: int,
                 kernel_size: int = 2):
        super().__init__(d_model, num_level, num_head, kernel_size,
                         num_head * num_level * kernel_size ** 2)
        self.num_point = kernel_size ** 2

    def forward(self, query, value, v_shape: Shapes, v_mask, v_valid_ratios,
                ref_windows, fold=None, tokens=None):
        """fold=True: the inference sampling path; fold=None (or False):
        the differentiable training path (see `box_attention_qminor`).
        tokens: the value's token axis split over sp (the encoder's)."""
        b, l1 = query.shape[:2]
        query, value = self._enter(query, value)
        value = self._project_value(value, v_mask, tokens)
        attn = F.linear(query, self.linear_attn_weight, self.linear_attn_bias)
        attn = torch.softmax(attn.reshape(b, l1, self.num_head, -1).float(),
                             dim=-1)
        attn_q = torch.movedim(attn, 1, -1).reshape(
            b, self.num_head, self.num_level, self.num_point, l1)
        gx, gy = _where_to_attend(self, query, v_valid_ratios,
                                  self._own_heads(ref_windows))
        out = box_attention_qminor(value, v_shape, gx, gy, attn_q, raw=True,
                                   fold=fold)
        attn = attn.reshape(b, l1, self.num_head, self.num_level,
                            self.num_point)
        return self.out_proj.raw(out), attn


class InstanceAttention(_SamplingAttention):
    """Instance attention: k×k (=14×14) RoI sampling with the attention
    weights predicted on a compact (L, 2, 2) quadrant grid."""

    def __init__(self, d_model: int, num_level: int, num_head: int,
                 kernel_size: int = 14):
        super().__init__(d_model, num_level, num_head, kernel_size,
                         num_head * num_level * 4)

    def _expand_quadrant_weights(self, w):
        """(B, H, L, 2, 2, LQ) -> (B, H, L, k*k, LQ), each quadrant value
        repeated over its (k/2)×(k/2) taps."""
        k = self.kernel_size
        w = w.repeat_interleave(k // 2, dim=3).repeat_interleave(k // 2, dim=4)
        b, h, l = w.shape[:3]
        return w.reshape(b, h, l, k * k, w.shape[-1])

    def project_roi(self, mask_out):
        """Output projection of a mask RoI (B, K, k, k, H*Ch)."""
        return self.out_proj(mask_out)

    def forward(self, query, value, v_shape: Shapes, v_mask, v_valid_ratios,
                ref_windows, emit_roi: bool = False, raw_roi: bool = False):
        """emit_roi=False: attention output only (inference layers), through
        the fused sampling kernel. emit_roi=True: also the k×k mask RoI,
        projected, or raw (unprojected) when raw_roi=True, differentiable
        where autograd needs a gradient. Returns (out, roi or None,
        weights)."""
        b, l1 = query.shape[:2]
        k = self.kernel_size
        nh, nl = self.num_head, self.num_level
        query, value = self._enter(query, value)
        value = self._project_value(value, v_mask)

        attn = F.linear(query, self.linear_attn_weight, self.linear_attn_bias)
        attn = torch.movedim(attn, 1, -1).float().reshape(b, nh, nl, 2, 2, l1)
        # spatial softmax over the EXPANDED (L*k*k) taps: each quadrant value
        # appears (k/2)^2 times, so it equals exp(w) / ((k/2)^2 * sum exp(w))
        # over the compact grid
        mult = (k // 2) ** 2
        flat = attn.reshape(b, nh, nl * 4, l1)
        e = torch.exp(flat - flat.amax(dim=2, keepdim=True))
        spatial_c = (e / (e.sum(dim=2, keepdim=True) * mult)).reshape(
            b, nh, nl, 2, 2, l1)
        spatial = self._expand_quadrant_weights(spatial_c)
        gx, gy = _where_to_attend(self, query, v_valid_ratios,
                                  self._own_heads(ref_windows))

        if emit_roi:
            # level softmax over L per quadrant (multiplicity cancels)
            level = self._expand_quadrant_weights(torch.softmax(attn, dim=2))
            out, mask_out = instance_attention_qminor(
                value, v_shape, gx, gy, spatial, level, kernel_size=k,
                raw=True)
            if raw_roi:
                return self.out_proj.raw(out), mask_out, (spatial, level)
            return (self.out_proj.raw(out), self.out_proj(mask_out),
                    (spatial, level))

        out = box_attention_qminor(value, v_shape, gx, gy, spatial, raw=True,
                                   fold=True)
        return self.out_proj.raw(out), None, (spatial,)


class Box3dAttention(_SamplingAttention):
    """Rotation-aware box attention over BEV features: a 5th box variable
    turns the k×k grid by `(ref_angle + dθ/16) * 2π` (with_rotation, the
    decoder); without it (the encoder) the grid is still turned, by the
    reference window's own angle. `fold` as `BoxAttention`'s: True on the
    inference forward (K9, the rotation already in the grid), None in
    training, the per-tap differentiable path at P = 4 taps (K2, K5), as in
    JAX. ref_windows: (B, LQ, 5) or per head (B, LQ, H, 5), (cx, cy, w, h,
    angle)."""

    def __init__(self, d_model: int, num_level: int, num_head: int,
                 with_rotation: bool = True, kernel_size: int = 2):
        super().__init__(d_model, num_level, num_head, kernel_size,
                         num_head * num_level * kernel_size ** 2,
                         num_variable=5 if with_rotation else 4)
        self.with_rotation = with_rotation
        self.num_point = kernel_size ** 2

    def _where_to_attend(self, query, v_valid_ratios, ref_windows):
        """grid = centre + R(angle) @ (kernel * size), each (B, H, L, P, LQ)
        f32."""
        off = _offsets(self, query)
        dx, dy, dw, dh = off[:, :, :, 0], off[:, :, :, 1], off[:, :, :, 2], \
            off[:, :, :, 3]
        rcx, rcy, rw, rh, rang = _qminor_ref_parts(ref_windows)
        if self.with_rotation:
            angles = (rang + off[:, :, :, 4] / 16.0) * 2.0 * math.pi
        else:
            angles = rang
        cx = rcx + dx / 8.0 * rw
        cy = rcy + dy / 8.0 * rh
        sw = F.relu(rw + dw / 8.0 * rw)
        sh = F.relu(rh + dh / 8.0 * rh)
        cos_a = torch.cos(angles)[:, :, :, None, :]
        sin_a = torch.sin(angles)[:, :, :, None, :]

        kernel = make_kernel_indices(self.kernel_size, divisor=2.0).to(
            query.device)
        ox = kernel[:, 0][None, None, None, :, None] * sw[:, :, :, None, :]
        oy = kernel[:, 1][None, None, None, :, None] * sh[:, :, :, None, :]
        gx = cx[:, :, :, None, :] + ox * cos_a - oy * sin_a
        gy = cy[:, :, :, None, :] + ox * sin_a + oy * cos_a
        return _valid_scaled(gx, gy, v_valid_ratios)

    def forward(self, query, value, v_shape: Shapes, v_mask, v_valid_ratios,
                ref_windows, fold=None):
        b, l1 = query.shape[:2]
        query, value = self._enter(query, value)
        value = self._project_value(value, v_mask)
        attn = F.linear(query, self.linear_attn_weight, self.linear_attn_bias)
        attn = torch.softmax(attn.reshape(b, l1, self.num_head, -1).float(),
                             dim=-1)
        attn_q = torch.movedim(attn, 1, -1).reshape(
            b, self.num_head, self.num_level, self.num_point, l1)
        gx, gy = self._where_to_attend(query, v_valid_ratios,
                                       self._own_heads(ref_windows))
        out = box_attention_qminor(value, v_shape, gx, gy, attn_q, raw=True,
                                   fold=fold)
        attn = attn.reshape(b, l1, self.num_head, self.num_level,
                            self.num_point)
        return self.out_proj.raw(out), attn
