"""Dense multi-head attention, the decoder's self-attention, in plain
torch: the query scaled by 1/sqrt(d), the scores, the softmax, the values.

Parameter names are the port's (`in_proj_weight`, `in_proj_bias`,
`out_proj`)."""

import math

import torch
import torch.nn.functional as F
from torch import nn


class MultiHeadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        assert embed_dim % num_heads == 0
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim,
                                                       embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, inputs_q, inputs_k, inputs_v):
        """inputs_*: (B, L, C). Returns (B, Lq, C)."""
        b, lq = inputs_q.shape[:2]
        q, k, v = (F.linear(x, w, bias).reshape(b, x.shape[1],
                                                 self.num_heads, -1)
                   for x, w, bias in zip((inputs_q, inputs_k, inputs_v),
                                         self.in_proj_weight.chunk(3),
                                         self.in_proj_bias.chunk(3)))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
        out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
        return self.out_proj(out.reshape(b, lq, -1))
