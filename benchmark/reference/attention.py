"""Box and instance attention modules, as the segm inference forward runs
them: the sampling grids and weights predicted from the query, the value
projected, sampled (`box_attention.py`) and projected out.

Parameter names are the port's: `linear_box_weight`, `linear_box_bias`,
`linear_attn_weight`, `linear_attn_bias` as raw parameters, `value_proj`
and `out_proj` as Linears.
"""

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .box_attention import box_attention_qminor, instance_attention_qminor

Shapes = Tuple[Tuple[int, int], ...]


def make_kernel_indices(kernel_size: int):
    """Normalized k×k tap offsets (k*k, 2) as (x, y) f32: even k centers at
    ±(i+0.5), odd k integer offsets, divided by k."""
    if kernel_size % 2 == 0:
        start, end = -kernel_size // 2 + 0.5, kernel_size // 2 - 0.5
    else:
        start, end = -(kernel_size - 1) // 2, (kernel_size - 1) // 2
    indices = np.linspace(start, end, kernel_size).astype(np.float32)
    i, j = np.meshgrid(indices, indices, indexing="ij")
    k = np.stack([j, i], axis=-1).reshape(-1, 2) / np.float32(kernel_size)
    return torch.from_numpy(k.astype(np.float32))


class HeadMergeDense(nn.Linear):
    """Output projection that also takes the sampling op's raw
    (B, H, LQ, C) layout (`raw`)."""

    def raw(self, x):
        b, nh, lq, ch = x.shape
        return self(x.permute(0, 2, 1, 3).reshape(b, lq, nh * ch))


def _qminor_ref_parts(ref_windows):
    """ref_windows (B, LQ, D) -> D tensors, each (B, 1, 1, LQ),
    broadcastable against (B, H, L, LQ)."""
    ref_t = torch.movedim(ref_windows, 1, -1)                 # (B, D, LQ)
    return [ref_t[:, None, None, i] for i in range(ref_t.shape[1])]


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

    def __init__(self, d_model: int, num_level: int, num_head: int,
                 kernel_size: int, n_attn: int):
        super().__init__()
        assert d_model % num_head == 0
        self.d_model, self.num_level, self.num_head = d_model, num_level, num_head
        self.kernel_size, self.num_variable = kernel_size, 4
        self.head_dim = d_model // num_head
        n_box = num_head * num_level * self.num_variable
        self.value_proj = nn.Linear(d_model, d_model)
        self.out_proj = HeadMergeDense(d_model, d_model)
        self.linear_box_weight = nn.Parameter(torch.zeros(n_box, d_model))
        self.linear_box_bias = nn.Parameter(torch.zeros(n_box))
        self.linear_attn_weight = nn.Parameter(torch.zeros(n_attn, d_model))
        self.linear_attn_bias = nn.Parameter(torch.zeros(n_attn))

    def _project_value(self, value, v_mask):
        """(B, S, H, Ch)."""
        value = self.value_proj(value)
        if v_mask is not None:
            value = value.masked_fill(v_mask[..., None], 0.0)
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
                ref_windows):
        b, l1 = query.shape[:2]
        value = self._project_value(value, v_mask)
        attn = F.linear(query, self.linear_attn_weight, self.linear_attn_bias)
        attn = torch.softmax(attn.reshape(b, l1, self.num_head, -1).float(),
                             dim=-1)
        attn_q = torch.movedim(attn, 1, -1).reshape(
            b, self.num_head, self.num_level, self.num_point, l1)
        gx, gy = _where_to_attend(self, query, v_valid_ratios, ref_windows)
        out = box_attention_qminor(value, v_shape, gx, gy, attn_q)
        return self.out_proj.raw(out)


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
                ref_windows, emit_roi: bool = False):
        """Returns (out, the raw, unprojected k×k mask RoI (B, LQ, k, k,
        H*Ch) with emit_roi, else None)."""
        b, l1 = query.shape[:2]
        k = self.kernel_size
        nh, nl = self.num_head, self.num_level
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
        gx, gy = _where_to_attend(self, query, v_valid_ratios, ref_windows)
        if not emit_roi:
            out = box_attention_qminor(value, v_shape, gx, gy, spatial)
            return self.out_proj.raw(out), None
        # level softmax over L per quadrant (multiplicity cancels)
        level = self._expand_quadrant_weights(torch.softmax(attn, dim=2))
        out, mask_out = instance_attention_qminor(
            value, v_shape, gx, gy, spatial, level, kernel_size=k)
        return self.out_proj.raw(out), mask_out
