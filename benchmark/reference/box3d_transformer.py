"""Box3dTransformer, BoxeR-3D's inference forward: rotated box attention
over the BEV levels in the encoder, the top proposals of the encoder head,
dense self-attention and rotated box attention in the decoder.

Each BEV cell carries 8 reference windows (cx, cy, w, h, angle), one a
head of the encoder's attention, which turns its grid by the window's
angle; the encoder head scores the first 3 of each cell. The decoder's
attention predicts a fifth box variable, dθ, that turns its grid by
(angle + dθ / 16) * 2π. Module names follow the port's
state dict (`transformer.encoder.layers.{i}`, `transformer.encoder.
enc_linear.{0,1}`, `transformer.decoder.layers.{i}.{self_attn,
multihead_attn}`).
"""

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .attention import HeadMergeDense, make_kernel_indices
from .box_attention import box_attention_qminor
from .dense_attention import MultiHeadAttention
from .follow import Follow
from .general import (flatten_with_shape, get_proposal_pos_embed,
                      inverse_sigmoid, top_k)
from .predictor import NEG_INF

Shapes = Tuple[Tuple[int, int], ...]
LN_EPS = 1e-6       # flax LayerNorm's epsilon


def create_ref_windows_3d(tensor_list, ref_size: int):
    """(B, S, 8, 5) per-cell anchors (cx, cy, w, h, angle normalized to
    [0, 1)) f32 over the NHWC levels."""
    angle = torch.tensor([0, 2 * math.pi / 3, -2 * math.pi / 3,
                          0, 2 * math.pi / 3, -2 * math.pi / 3,
                          0, math.pi], dtype=torch.float32)
    angle = (angle + math.pi) / (2 * math.pi)
    wins = []
    for t in tensor_list:
        b, h, w = t.shape[:3]
        dev = t.device
        y = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        x = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        yy, xx = torch.meshgrid(y, x, indexing="ij")
        shape = (b, h, w, 8)
        ref = torch.stack([
            xx[None, :, :, None].expand(shape),
            yy[None, :, :, None].expand(shape),
            torch.full(shape, ref_size / w, device=dev),
            torch.full(shape, ref_size / h, device=dev),
            angle.to(dev)[None, None, None, :].expand(shape)], dim=-1)
        wins.append(ref.reshape(b, h * w, 8, 5))
    return torch.cat(wins, dim=1)


class Box3dAttention(nn.Module):
    """Rotated box attention (k = 2: 4 taps a level). Parameter names are
    the port's."""

    def __init__(self, d_model: int, num_level: int, num_head: int,
                 with_rotation: bool, kernel_size: int = 2):
        super().__init__()
        self.num_level, self.num_head = num_level, num_head
        self.head_dim = d_model // num_head
        self.kernel_size, self.num_point = kernel_size, kernel_size ** 2
        self.with_rotation = with_rotation
        self.num_variable = 5 if with_rotation else 4
        n_box = num_head * num_level * self.num_variable
        n_attn = num_head * num_level * self.num_point
        self.value_proj = nn.Linear(d_model, d_model)
        self.out_proj = HeadMergeDense(d_model, d_model)
        self.linear_box_weight = nn.Parameter(torch.zeros(n_box, d_model))
        self.linear_box_bias = nn.Parameter(torch.zeros(n_box))
        self.linear_attn_weight = nn.Parameter(torch.zeros(n_attn, d_model))
        self.linear_attn_bias = nn.Parameter(torch.zeros(n_attn))

    def grid(self, query, ref_windows):
        """(gx, gy), each (B, H, L, P, LQ): the window's centre plus the
        kernel's offsets scaled by its size and turned by its angle.
        ref_windows (B, LQ, 5) or one a head, (B, LQ, H, 5)."""
        b, lq = query.shape[:2]
        off = torch.movedim(F.linear(query, self.linear_box_weight,
                                     self.linear_box_bias), 1, -1).reshape(
            b, self.num_head, self.num_level, self.num_variable, lq)
        ref = torch.movedim(ref_windows, 1, -1)     # (B, [H,] 5, LQ)
        if ref_windows.dim() == 3:
            rcx, rcy, rw, rh, rang = (ref[:, None, None, i] for i in range(5))
        else:
            rcx, rcy, rw, rh, rang = (ref[:, :, None, i] for i in range(5))
        # the encoder's windows turn by their normalized angle as it is, in
        # [0, 1) radians, the decoder's by (angle + dθ / 16) * 2π: the
        # published code's rule
        angle = ((rang + off[:, :, :, 4] / 16.0) * 2.0 * math.pi
                 if self.with_rotation else rang)
        cx = rcx + off[:, :, :, 0] / 8.0 * rw
        cy = rcy + off[:, :, :, 1] / 8.0 * rh
        sw = F.relu(rw + off[:, :, :, 2] / 8.0 * rw)[:, :, :, None]
        sh = F.relu(rh + off[:, :, :, 3] / 8.0 * rh)[:, :, :, None]
        kernel = make_kernel_indices(self.kernel_size).to(query.device)
        ox = kernel[:, 0][None, None, None, :, None] * sw
        oy = kernel[:, 1][None, None, None, :, None] * sh
        cos_a, sin_a = angle.cos()[:, :, :, None], angle.sin()[:, :, :, None]
        gx = cx[:, :, :, None] + ox * cos_a - oy * sin_a
        gy = cy[:, :, :, None] + ox * sin_a + oy * cos_a
        return gx, gy

    def forward(self, query, value, v_shape: Shapes, ref_windows):
        b, l1 = query.shape[:2]
        value = self.value_proj(value).reshape(b, value.shape[1],
                                               self.num_head, self.head_dim)
        attn = F.linear(query, self.linear_attn_weight, self.linear_attn_bias)
        attn = torch.softmax(attn.reshape(b, l1, self.num_head, -1), dim=-1)
        attn = torch.movedim(attn, 1, -1).reshape(
            b, self.num_head, self.num_level, self.num_point, l1)
        gx, gy = self.grid(query, ref_windows)
        return self.out_proj.raw(box_attention_qminor(value, v_shape, gx, gy,
                                                      attn))


def _ffn(layer, x):
    return layer.linear2(F.relu(layer.linear1(x)))


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, nlevel: int,
                 dim_feedforward: int):
        super().__init__()
        self.self_attn = Box3dAttention(d_model, nlevel, nhead,
                                        with_rotation=False)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, src, pos, v_shape: Shapes, ref_windows):
        src = self.norm1(src + self.self_attn(src + pos, src, v_shape,
                                              ref_windows))
        return self.norm2(src + _ffn(self, src))


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, nlevel: int,
                 dim_feedforward: int):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead)
        self.multihead_attn = Box3dAttention(d_model, nlevel, nhead,
                                             with_rotation=True)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)

    def forward(self, tgt, query_pos, memory, v_shape: Shapes, ref_windows):
        q = tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(q, q, tgt))
        tgt = self.norm2(tgt + self.multihead_attn(tgt + query_pos, memory,
                                                   v_shape, ref_windows))
        return self.norm3(tgt + _ffn(self, tgt))


class _Encoder(nn.Module):
    def __init__(self, d_model, nhead, nlevel, dim_feedforward, num_layers):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, nhead, nlevel, dim_feedforward)
            for _ in range(num_layers))
        self.enc_linear = nn.Sequential(nn.Linear(d_model, d_model),
                                        nn.LayerNorm(d_model, eps=LN_EPS))


class _Decoder(nn.Module):
    def __init__(self, d_model, nhead, nlevel, dim_feedforward, num_layers):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, nhead, nlevel, dim_feedforward)
            for _ in range(num_layers))


class Box3dTransformer(Follow, nn.Module):
    def __init__(self, d_model: int, nhead: int, nlevel: int,
                 num_encoder_layers: int, num_decoder_layers: int,
                 dim_feedforward: int, num_queries: int,
                 num_references: int, ref_size: int):
        super().__init__()
        self.d_model, self.num_queries = d_model, num_queries
        self.num_references, self.ref_size = num_references, ref_size
        self.forced, self.seen = {}, {}
        self.encoder = _Encoder(d_model, nhead, nlevel, dim_feedforward,
                                num_encoder_layers)
        self.decoder = _Decoder(d_model, nhead, nlevel, dim_feedforward,
                                num_decoder_layers)

    def _get_enc_proposals(self, enc_detector, output, ref_windows):
        """The top num_queries of the encoder head's logits over each
        cell's first R references (those whose centre lies outside
        (0.001, 0.999) score NEG_INF). Returns (decoder embed, decoder
        windows (B, NQ, 7) in the head's raw (x, y, l, w, rad, z, h)
        order, decoder position encoding)."""
        b, l = output.shape[:2]
        r = self.num_references
        ref = ref_windows[..., :r, :]
        valid = ((ref[..., :2] > 0.001) & (ref[..., :2] < 0.999)).all(-1)
        logits = enc_detector.class_embed(output).reshape(b, l, r, -1)[..., 0]
        logits = logits.masked_fill(~valid, NEG_INF).reshape(b, l * r)
        _, indexes = top_k(logits, self.num_queries)
        indexes = self.follow("proposals", indexes, logits)

        cell = indexes // r
        embed = torch.gather(output, 1, cell[..., None].expand(
            -1, -1, output.shape[-1]))
        raw = enc_detector.bbox_embed(embed).reshape(b, -1, r, 7)
        raw = torch.gather(raw, 2, (indexes % r)[..., None, None].expand(
            -1, -1, 1, 7))[:, :, 0]
        win = torch.gather(ref, 1, cell[..., None, None].expand(
            -1, -1, r, 5))
        win = torch.gather(win, 2, (indexes % r)[..., None, None].expand(
            -1, -1, 1, 5))[:, :, 0]
        out_ref = torch.sigmoid(torch.cat([raw[..., :5] + inverse_sigmoid(win),
                                           raw[..., 5:]], dim=-1))
        pos = (get_proposal_pos_embed(out_ref[..., :2], self.d_model)
               + get_proposal_pos_embed(out_ref[..., 2:4], self.d_model)
               + get_proposal_pos_embed(out_ref[..., 4:5].expand(-1, -1, 2),
                                        self.d_model))
        return self.encoder.enc_linear(embed), out_ref, pos

    def forward(self, srcs: Sequence[torch.Tensor], pos_list, enc_detector):
        """srcs, pos_list: the NHWC levels and their encodings. Returns the
        last decoder layer's output (B, NQ, C) and the decoder windows
        (B, NQ, 7)."""
        ref_windows = create_ref_windows_3d(srcs, self.ref_size)
        src, _, v_shape = flatten_with_shape(srcs, None)
        pos = torch.cat([p.reshape(p.shape[0], -1, p.shape[-1])
                         for p in pos_list], dim=1)
        output = src
        for layer in self.encoder.layers:
            output = layer(output, pos, v_shape, ref_windows)
        tgt, dec_ref, dec_pos = self._get_enc_proposals(enc_detector, output,
                                                        ref_windows)
        for layer in self.decoder.layers:
            tgt = layer(tgt, dec_pos, output, v_shape, dec_ref[..., :5])
        return tgt, dec_ref
