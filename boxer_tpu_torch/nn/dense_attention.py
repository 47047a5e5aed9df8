"""Dense multi-head attention over the flash kernel (K3, differentiable
through `attention`); port of `boxer_tpu/nn/dense_attention.py`.

Parameter names are the reference `nn.MultiheadAttention`'s
(`in_proj_weight`, `in_proj_bias`, `out_proj`), so reference checkpoints
load as they are. Attention-probability dropout is not supported (every
shipped config uses 0 there).
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from boxer_tpu_torch.nn.init import lecun_normal_
from boxer_tpu_torch.ops.flash_attention import NEG_INF, attention


class PallasMultiHeadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        assert embed_dim % num_heads == 0
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim,
                                                       embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def reset_parameters_(self, g):
        for w in self.in_proj_weight.data.chunk(3):    # three flax Denses
            lecun_normal_(w, g)
        self.in_proj_bias.data.zero_()

    def forward(self, inputs_q, inputs_k, inputs_v,
                key_padding_mask: Optional[torch.Tensor] = None):
        """inputs_*: (B, L, C); key_padding_mask: (B, Lkv) bool, True =
        masked. Returns (B, Lq, C)."""
        b, lq, c = inputs_q.shape
        lkv = inputs_k.shape[1]
        h = self.num_heads
        d = c // h
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)

        def split(x, l):
            return x.reshape(b, l, h, d).permute(0, 2, 1, 3).reshape(
                b * h, l, d).contiguous()

        q = split(F.linear(inputs_q, wq, bq), lq)
        k = split(F.linear(inputs_k, wk, bk), lkv)
        v = split(F.linear(inputs_v, wv, bv), lkv)
        mask = None
        if key_padding_mask is not None:
            mask = torch.where(key_padding_mask, NEG_INF, 0.0).float()
            mask = mask.repeat_interleave(h, dim=0).contiguous()
        out = attention(q, k, v, mask)
        out = out.reshape(b, h, lq, d).permute(0, 2, 1, 3).reshape(b, lq, c)
        return self.out_proj(out)
