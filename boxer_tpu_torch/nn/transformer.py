"""DETR's transformer: post- or pre-norm encoder and decoder layers over
dense attention, learned-query decoder; port of
`boxer_tpu/nn/transformer.py`.

Module names are the reference e2edet ones: `encoder.layers.{i}` with
`self_attn`, `linear1/2`, `norm1/2`; `decoder.layers.{i}` with `self_attn`,
`multihead_attn`, `linear1/2`, `norm1..3`; `encoder.norm` (pre-norm only)
and `decoder.norm`, the shared final norm the decoder applies to every
intermediate state. Attention is `MultiHeadAttention`, plain torch as
flax's module in the JAX package, with probability dropout in training.

The padding mask takes torch's meaning, `key_padding_mask` True =
excluded. The JAX package turns it round twice (`key_mask = ~mask` at
`:129`, then `~src_key_padding_mask` in each layer, `:32`, `:82`) and
hands flax's attention, which attends where its mask is True, the padded
keys alone: with no padding it attends to no key. The port follows the
reference (`ROADMAP.md` section 3, "Known divergences").

Tensor parallel as the BoxeR transformers (`nn/box_transformer.py`): each
attention runs this rank's heads, each FFN its hidden features. No
sequence parallel (JAX's DETR takes no `seq_shard`).
"""

import functools
from typing import Optional

import torch
from torch import nn

from boxer_tpu_torch.nn.dense_attention import MultiHeadAttention
from boxer_tpu_torch.nn.dropout import Dropout
from boxer_tpu_torch.parallel.collectives import RowLinear, feed_forward

LN_EPS = 1e-6       # flax LayerNorm's epsilon


class TransformerEncoderLayer(nn.Module):
    tp = None

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float, normalize_before: bool = False):
        super().__init__()
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = RowLinear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dropout = Dropout(dropout)

    def forward(self, src, pos, key_padding_mask, key=None):
        drop = functools.partial(self.dropout, key=key)

        def attn(x):
            q = x if pos is None else x + pos
            return self.self_attn(q, q, x, key_padding_mask, dropout_key=key)

        def ffn(x):
            return feed_forward(self, x, key, 1)

        if self.normalize_before:
            src = src + drop(attn(self.norm1(src)), index=0)
            return src + drop(ffn(self.norm2(src)), index=2)
        src = self.norm1(src + drop(attn(src), index=0))
        return self.norm2(src + drop(ffn(src), index=2))


class TransformerDecoderLayer(nn.Module):
    tp = None

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float, normalize_before: bool = False):
        super().__init__()
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout)
        self.multihead_attn = MultiHeadAttention(d_model, nhead, dropout)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = RowLinear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dropout = Dropout(dropout)

    def forward(self, tgt, memory, query_pos, pos, memory_key_padding_mask,
                key=None):
        drop = functools.partial(self.dropout, key=key)

        def self_block(x):
            q = x if query_pos is None else x + query_pos
            return self.self_attn(q, q, x, dropout_key=key)

        def cross_block(x):
            q = x if query_pos is None else x + query_pos
            k = memory if pos is None else memory + pos
            return self.multihead_attn(q, k, memory, memory_key_padding_mask,
                                       dropout_key=key)

        def ffn(x):
            return feed_forward(self, x, key, 2)

        if self.normalize_before:
            tgt = tgt + drop(self_block(self.norm1(tgt)), index=0)
            tgt = tgt + drop(cross_block(self.norm2(tgt)), index=1)
            return tgt + drop(ffn(self.norm3(tgt)), index=3)
        tgt = self.norm1(tgt + drop(self_block(tgt), index=0))
        tgt = self.norm2(tgt + drop(cross_block(tgt), index=1))
        return self.norm3(tgt + drop(ffn(tgt), index=3))


class _Encoder(nn.Module):
    def __init__(self, layer_args, num_layers, normalize_before):
        super().__init__()
        self.layers = nn.ModuleList(TransformerEncoderLayer(*layer_args)
                                    for _ in range(num_layers))
        if normalize_before:
            self.norm = nn.LayerNorm(layer_args[0], eps=LN_EPS)


class _Decoder(nn.Module):
    def __init__(self, layer_args, num_layers):
        super().__init__()
        self.layers = nn.ModuleList(TransformerDecoderLayer(*layer_args)
                                    for _ in range(num_layers))
        self.norm = nn.LayerNorm(layer_args[0], eps=LN_EPS)


class Transformer(nn.Module):
    """DETR transformer: a flattened single-level memory, learned queries,
    the decoder's intermediate states stacked (nl, B, NQ, C)."""

    def __init__(self, d_model: int = 256, nhead: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 normalize_before: bool = False):
        super().__init__()
        args = (d_model, nhead, dim_feedforward, dropout, normalize_before)
        self.normalize_before = normalize_before
        self.encoder = _Encoder(args, num_encoder_layers, normalize_before)
        self.decoder = _Decoder(args, num_decoder_layers)

    def forward(self, src, mask: Optional[torch.Tensor], query_embed, pos,
                inference: bool = False, dropout_key=None):
        """src, pos: (B, H, W, C); mask: (B, H, W) bool, True = padded, or
        None; query_embed: (NQ, C). Returns (nl, B, NQ, C), nl = 1 with
        inference=True."""
        b, h, w, c = src.shape
        src = src.reshape(b, h * w, c)
        pos = pos.reshape(b, h * w, c)
        key_padding_mask = None if mask is None else mask.reshape(b, h * w)

        out = src
        for layer in self.encoder.layers:
            out = layer(out, pos, key_padding_mask, key=dropout_key)
        if self.normalize_before:
            out = self.encoder.norm(out)

        query_pos = query_embed[None].expand(b, -1, -1)
        tgt = torch.zeros_like(query_pos, dtype=out.dtype)
        inter = []
        for layer in self.decoder.layers:
            tgt = layer(tgt, out, query_pos, pos, key_padding_mask,
                        key=dropout_key)
            inter.append(self.decoder.norm(tgt))
        return torch.stack(inter[-1:] if inference else inter)
