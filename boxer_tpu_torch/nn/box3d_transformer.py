"""Box3dTransformer: rotation-aware box-attention encoder and decoder over
BEV features; port of `boxer_tpu/nn/box3d_transformer.py`.

Each BEV cell carries 8 reference windows (3 orientations x 2, and 2 more),
and the 8 anchors ride the 8 heads of the encoder's `Box3dAttention`. The
encoder proposals are the top `num_queries` of the `MultiDetector3d` head
over the first 3 references of every cell. Module names follow the 2D
port's: `transformer.encoder.layers.{i}`, `transformer.encoder.enc_linear.
{0,1}` (the JAX `enc_linear` and `enc_norm`), `transformer.decoder.layers.
{i}.{self_attn,multihead_attn}`; the encoder head (`enc_detector`) sits at
the top of the model and is passed in. Dropout at the JAX package's sites
(`boxer_tpu/nn/box3d_transformer.py:72`, `:96-108`), drawn from the train
step's key (`nn/dropout.py`); no remat, as in JAX. Tensor parallel as
the 2D transformer (`nn/box_transformer.py`); no sequence parallel (JAX's
BoxeR-3D takes no `seq_shard`). The inference forward samples through K9
(`fold=True`), as the 2D one does; training per tap. Spans
(`utils/timer.py:span`) as the 2D transformer's: `boxer.encoder`,
`boxer.proposals`, `boxer.decoder`.
"""

import functools
import math
from typing import Sequence, Tuple

import torch
from torch import nn

from boxer_tpu_torch.nn.attention import Box3dAttention
from boxer_tpu_torch.nn.dense_attention import PallasMultiHeadAttention
from boxer_tpu_torch.nn.dropout import Dropout
from boxer_tpu_torch.nn.predictor import NEG_INF
from boxer_tpu_torch.parallel.collectives import RowLinear, feed_forward
from boxer_tpu_torch.utils.general import (flatten_with_shape,
                                           get_proposal_pos_embed,
                                           inverse_sigmoid, top_k)
from boxer_tpu_torch.utils.timer import span

Shapes = Tuple[Tuple[int, int], ...]
LN_EPS = 1e-6       # flax LayerNorm's epsilon


def create_ref_windows_3d(tensor_list, ref_size: int):
    """(B, S, 8, 5) per-cell anchors (cx, cy, w, h, angle normalized to
    [0, 1)) f32 over the NHWC levels of tensor_list."""
    angle = torch.tensor([0, 2 * math.pi / 3, -2 * math.pi / 3,
                          0, 2 * math.pi / 3, -2 * math.pi / 3,
                          0, 2 * math.pi / 2], dtype=torch.float32)
    angle = (angle + 0.5 * (2 * math.pi)) / (2 * math.pi)
    wins = []
    for t in tensor_list:
        b, h, w = t.shape[:3]
        dev = t.device
        y = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        x = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        yy, xx = torch.meshgrid(y, x, indexing="ij")
        shape = (b, h, w, angle.shape[0])
        ref = torch.stack([
            xx[None, :, :, None].expand(shape),
            yy[None, :, :, None].expand(shape),
            torch.full(shape, ref_size / w, device=dev),
            torch.full(shape, ref_size / h, device=dev),
            angle.to(dev)[None, None, None, :].expand(shape)], dim=-1)
        wins.append(ref.reshape(b, h * w, angle.shape[0], 5))
    return torch.cat(wins, dim=1)


class Box3dEncoderLayer(nn.Module):
    tp = None

    def __init__(self, d_model: int, nhead: int, nlevel: int,
                 dim_feedforward: int, dropout: float = 0.0):
        super().__init__()
        self.self_attn = Box3dAttention(d_model, nlevel, nhead,
                                        with_rotation=False)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = RowLinear(dim_feedforward, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dropout = Dropout(dropout)

    def forward(self, src, pos, v_shape: Shapes, ref_windows, key=None,
                fold=None):
        drop = functools.partial(self.dropout, key=key)
        src2, _ = self.self_attn(src + pos, src, v_shape, None, None,
                                 ref_windows, fold=fold)
        src = self.norm1(src + drop(src2, index=0))
        src2 = feed_forward(self, src, key, 1)
        return self.norm2(src + drop(src2, index=2))


class Box3dDecoderLayer(nn.Module):
    """Dense self-attention (K3), then rotated box cross-attention."""
    tp = None

    def __init__(self, d_model: int, nhead: int, nlevel: int,
                 dim_feedforward: int, dropout: float = 0.0):
        super().__init__()
        self.self_attn = PallasMultiHeadAttention(d_model, nhead, dropout)
        self.multihead_attn = Box3dAttention(d_model, nlevel, nhead,
                                             with_rotation=True)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = RowLinear(dim_feedforward, d_model)
        self.dropout = Dropout(dropout)

    def forward(self, tgt, query_pos, memory, v_shape: Shapes, ref_windows,
                key=None, fold=None):
        drop = functools.partial(self.dropout, key=key)
        q = tgt + query_pos
        tgt = self.norm1(tgt + drop(self.self_attn(q, q, tgt, dropout_key=key),
                                    index=0))
        tgt2, _ = self.multihead_attn(tgt + query_pos, memory, v_shape, None,
                                      None, ref_windows, fold=fold)
        tgt = self.norm2(tgt + drop(tgt2, index=1))
        tgt2 = feed_forward(self, tgt, key, 2)
        return self.norm3(tgt + drop(tgt2, index=3))


class _Encoder(nn.Module):
    def __init__(self, d_model, nhead, nlevel, dim_feedforward, num_layers,
                 dropout):
        super().__init__()
        self.layers = nn.ModuleList(
            Box3dEncoderLayer(d_model, nhead, nlevel, dim_feedforward, dropout)
            for _ in range(num_layers))
        self.enc_linear = nn.Sequential(nn.Linear(d_model, d_model),
                                        nn.LayerNorm(d_model, eps=LN_EPS))


class _Decoder(nn.Module):
    def __init__(self, d_model, nhead, nlevel, dim_feedforward, num_layers,
                 dropout):
        super().__init__()
        self.layers = nn.ModuleList(
            Box3dDecoderLayer(d_model, nhead, nlevel, dim_feedforward, dropout)
            for _ in range(num_layers))


class Box3dTransformer(nn.Module):
    def __init__(self, d_model: int = 256, nhead: int = 8, nlevel: int = 2,
                 num_encoder_layers: int = 2, num_decoder_layers: int = 2,
                 dim_feedforward: int = 1024, num_queries: int = 300,
                 num_references: int = 3, ref_size: int = 4,
                 dropout: float = 0.0):
        super().__init__()
        self.d_model, self.num_queries = d_model, num_queries
        self.num_references, self.ref_size = num_references, ref_size
        self.encoder = _Encoder(d_model, nhead, nlevel, dim_feedforward,
                                num_encoder_layers, dropout)
        self.decoder = _Decoder(d_model, nhead, nlevel, dim_feedforward,
                                num_decoder_layers, dropout)

    def _get_enc_proposals(self, enc_detector, output, ref_windows):
        """Top-num_queries over the L * R encoder proposals (invalid
        references score NEG_INF; ties to the lower index). Returns
        (decoder embed, decoder ref windows (B, NQ, 7) f32 in the head's raw
        (x, y, l, w, rad, z, h) order, decoder pos, indexes). The ref
        windows and the embed's input carry no gradient, as JAX's
        `stop_gradient`s rule."""
        b, l = output.shape[:2]
        r = self.num_references
        ref = ref_windows[..., :r, :]                           # (B, L, R, 5)
        tmp = enc_detector.bbox_embed(output).float().reshape(b, l, r, 7)
        tmp_box = tmp[..., :5] + inverse_sigmoid(ref.float())
        out_ref = torch.sigmoid(torch.cat([tmp_box, tmp[..., 5:]], dim=-1))
        out_ref = out_ref.reshape(b, l * r, 7)

        valid = ((ref[..., :2] > 0.001) & (ref[..., :2] < 0.999)).all(-1)
        logits = enc_detector.class_embed(output).reshape(b, l, r, -1)[..., 0]
        logits = logits.float().masked_fill(~valid, NEG_INF).reshape(b, l * r)
        _, indexes = top_k(logits, self.num_queries)

        out_ref = torch.gather(out_ref, 1, indexes[..., None].expand(
            -1, -1, 7)).detach()
        pos = get_proposal_pos_embed(out_ref[..., :2], self.d_model)
        size = get_proposal_pos_embed(out_ref[..., 2:4], self.d_model)
        rad = get_proposal_pos_embed(out_ref[..., 4:5].expand(-1, -1, 2),
                                     self.d_model)
        out_pos = (pos + size + rad).to(output.dtype)
        emb_idx = indexes // r
        out_embed = torch.gather(output, 1, emb_idx[..., None].expand(
            -1, -1, output.shape[-1]))
        out_embed = self.encoder.enc_linear(out_embed.detach())
        return out_embed, out_ref, out_pos, indexes

    def forward(self, srcs: Sequence[torch.Tensor], pos_list, enc_detector,
                inference: bool = True, dropout_key=None):
        """srcs, pos_list: lists of (B, Hi, Wi, C). Returns (hs (nl, B, NQ,
        C), dec_ref_windows (B, NQ, 7), encoder output, src_ref_windows (B,
        S, 8, 5), enc_outputs); nl = 1 and enc_outputs None with
        inference=True, else every decoder layer and the encoder head's
        outputs over all S * 3 proposals. The box attentions sample through
        K9 with `inference` (`fold=True`), else per tap (K2, K5)."""
        fold = True if inference else None
        with span("boxer.encoder"):
            src_ref_windows = create_ref_windows_3d(srcs, self.ref_size)
            src, _, v_shape = flatten_with_shape(srcs, None)
            src_pos = torch.cat([p.reshape(p.shape[0], -1, p.shape[-1])
                                 for p in pos_list], dim=1)
            output = src
            for layer in self.encoder.layers:
                output = layer(output, src_pos, v_shape, src_ref_windows,
                               key=dropout_key, fold=fold)

        with span("boxer.proposals"):
            tgt, dec_ref_windows, dec_pos, _ = self._get_enc_proposals(
                enc_detector, output, src_ref_windows)
        with span("boxer.decoder"):
            inter = []
            for layer in self.decoder.layers:
                tgt = layer(tgt, dec_pos, output, v_shape,
                            dec_ref_windows[..., :5], key=dropout_key,
                            fold=fold)
                inter.append(tgt)
            hs = torch.stack(inter[-1:] if inference else inter)
        enc_outputs = None
        if not inference:
            enc = enc_detector(output[None], src_ref_windows)
            enc_outputs = [{"pred_logits": enc["pred_logits"],
                            "pred_boxes": enc["pred_boxes"]}]
        return hs, dec_ref_windows, output, src_ref_windows, enc_outputs
