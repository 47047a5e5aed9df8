"""Dense multi-head attention; port of `boxer_tpu/nn/dense_attention.py` and
of flax's `MultiHeadDotProductAttention` where the JAX package uses it.

Parameter names are the reference `nn.MultiheadAttention`'s
(`in_proj_weight`, `in_proj_bias`, `out_proj`), so reference checkpoints
load as they are.

- `MultiHeadAttention` is flax's math in plain torch: the query scaled by
  1/sqrt(d), the scores, masked keys at the dtype's lowest value, the
  softmax, then, in training with a dropout key, attention-probability
  dropout with flax's default `broadcast_dropout=True`: one (Lq, Lk) keep
  mask shared over the batch and the heads, multiplied in as keep /
  keep_prob (`flax/linen/attention.py`). DETR runs it (the JAX package
  runs DETR through flax's module).
- `PallasMultiHeadAttention` runs the flash kernel (K3, differentiable
  through `attention`) and takes the plain math only where it draws
  dropout: the JAX package leaves K3 for flax's module at dropout > 0
  (`boxer_tpu/nn/box_transformer.py:158-167`). At dropout 0 and at eval
  K3 stays.

Tensor parallel (`tp`, set by `parallel/sharding.py:shard_model`): a rank
holds `num_heads` = H / mp heads, its rows of each of the q, k and v
blocks of `in_proj_weight` (packed again, q then k then v) and its
columns of `out_proj`, a `RowLinear`; the inputs enter through
`copy_to_mp`. The probability dropout's mask is one (Lq, Lk) for every
head, so a rank draws the mask of the unsharded module.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from boxer_tpu_torch.nn.dropout import Dropout, DropoutKey
from boxer_tpu_torch.nn.init import lecun_normal_
from boxer_tpu_torch.ops.flash_attention import NEG_INF, attention
from boxer_tpu_torch.parallel.collectives import RowLinear, column_input


class MultiHeadAttention(nn.Module):
    tp = None

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        assert embed_dim % num_heads == 0
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim,
                                                       embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = RowLinear(embed_dim, embed_dim)
        self.dropout = Dropout(dropout)

    def reset_parameters_(self, g):
        for w in self.in_proj_weight.data.chunk(3):    # three flax Denses
            lecun_normal_(w, g)
        self.in_proj_bias.data.zero_()

    def _project(self, inputs_q, inputs_k, inputs_v):
        """q, k, v, each (B, L, H, D) (this rank's heads)."""
        h = self.num_heads
        w = self.in_proj_weight.chunk(3)
        bias = self.in_proj_bias.chunk(3)
        entered = {}
        xs = [entered.setdefault(id(x), column_input(x, self.tp))
              for x in (inputs_q, inputs_k, inputs_v)]
        return [F.linear(x, wi, bi).reshape(x.shape[0], x.shape[1], h, -1)
                for x, wi, bi in zip(xs, w, bias)]

    def forward(self, inputs_q, inputs_k, inputs_v,
                key_padding_mask: Optional[torch.Tensor] = None,
                dropout_key: Optional[DropoutKey] = None):
        """inputs_*: (B, L, C); key_padding_mask: (B, Lkv) bool, True =
        excluded (torch's meaning). Returns (B, Lq, C)."""
        b, lq = inputs_q.shape[:2]
        q, k, v = self._project(inputs_q, inputs_k, inputs_v)
        q = q / math.sqrt(q.shape[-1])
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if key_padding_mask is not None:
            scores = scores.masked_fill(key_padding_mask[:, None, None, :],
                                        torch.finfo(scores.dtype).min)
        p = torch.softmax(scores, dim=-1)
        if self.dropout.active(dropout_key):
            keep = self.dropout.keep(dropout_key, p.shape[-2:], p.device)
            p = p * (keep.to(p.dtype) / (1.0 - self.dropout.rate))
        out = torch.einsum("bhqk,bkhd->bqhd", p, v)
        return self.out_proj(out.reshape(b, lq, -1))


class PallasMultiHeadAttention(MultiHeadAttention):
    def forward(self, inputs_q, inputs_k, inputs_v,
                key_padding_mask: Optional[torch.Tensor] = None,
                dropout_key: Optional[DropoutKey] = None):
        """As `MultiHeadAttention`, through K3 unless it draws dropout."""
        if self.dropout.active(dropout_key):
            return super().forward(inputs_q, inputs_k, inputs_v,
                                   key_padding_mask, dropout_key)
        b, lq = inputs_q.shape[:2]
        lkv = inputs_k.shape[1]
        h = self.num_heads
        q, k, v = self._project(inputs_q, inputs_k, inputs_v)
        d = q.shape[-1]

        def split(x, l):
            return x.permute(0, 2, 1, 3).reshape(b * h, l, d).contiguous()

        mask = None
        if key_padding_mask is not None:
            mask = torch.where(key_padding_mask, NEG_INF, 0.0).float()
            mask = mask.repeat_interleave(h, dim=0).contiguous()
        out = attention(split(q, lq), split(k, lkv), split(v, lkv), mask)
        out = out.reshape(b, h, lq, d).permute(0, 2, 1, 3).reshape(
            b, lq, h * d)
        return self.out_proj(out)
