"""The collectives of tensor (mp) and sequence (sp) parallelism, as
autograd Functions; the port's counterpart of the all-gathers and
all-reduces that XLA's SPMD partitioner inserts for the JAX package's
`param_spec` and `seq_constraint` (`boxer_tpu/parallel/sharding.py`).

Built from the collectives that gloo serves for CUDA tensors (all_reduce,
all_gather), so one card can hold several ranks:

- `copy_to_mp`: identity forward, all-reduce over mp backward; at the
  input of a column-parallel block (heads, FFN hidden);
- `reduce_from_mp`: all-reduce over mp forward, identity backward; at the
  output of a row-parallel block (`RowLinear`);
- `gather_tokens`: all-gather over sp forward, the pad stripped; sum over
  sp (all-reduce) then this rank's slice backward;
- `slice_tokens`: this rank's slice of the token axis, padded to a
  multiple of sp, forward; zero-padded backward.

Each raises when its axis has no group: a layout that shards an axis
never runs it unsharded. `COUNTS` tallies every call and its bytes
(forward and backward); every collective goes through `_all_reduce` or
`_all_gather`.
"""

from collections import defaultdict
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from boxer_tpu_torch.parallel.mesh import Axis

# {name: [calls, bytes]} of every collective since the last reset
COUNTS = defaultdict(lambda: [0, 0])


def reset_counts():
    COUNTS.clear()


def _group(axis: Axis, what: str):
    if axis is None or axis.group is None:
        raise RuntimeError(f"{what}: the layout shards this axis but it "
                           "has no process group")
    return axis.group


def _count(name, t: torch.Tensor, copies: int = 1):
    c = COUNTS[name]
    c[0] += 1
    c[1] += t.numel() * t.element_size() * copies


def _all_reduce(t: torch.Tensor, axis: Axis, name: str) -> torch.Tensor:
    t = t.contiguous().clone()
    dist.all_reduce(t, group=_group(axis, name))
    _count(name, t)
    return t


def _all_gather(x: torch.Tensor, axis: Axis, name: str) -> list:
    """Every rank's x over `axis`, in index order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x, group=_group(axis, name))
    _count(name, x, axis.size)
    return parts


class _CopyToMp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        _group(axis, "copy_to_mp")
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis, "copy_to_mp backward"), None


class _ReduceFromMp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis, "reduce_from_mp")

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_mp(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return _CopyToMp.apply(x, axis)


def reduce_from_mp(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return _ReduceFromMp.apply(x, axis)


@dataclass(frozen=True, eq=False)
class Tokens:
    """A token axis of `n` tokens split over `axis` (sp): each rank holds
    `per_rank` of them from `start`, the last padded past n."""
    axis: Axis
    n: int

    @property
    def per_rank(self) -> int:
        return -(-self.n // self.axis.size)

    @property
    def start(self) -> int:
        return self.axis.index * self.per_rank


def _pad_to(x: torch.Tensor, dim: int, length: int, value=0):
    pad = length - x.shape[dim]
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_full(shape, value)], dim=dim)


class _SliceTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tokens, dim, pad_value):
        _group(tokens.axis, "slice_tokens")
        ctx.tokens, ctx.dim = tokens, dim
        x = _pad_to(x, dim, tokens.per_rank * tokens.axis.size, pad_value)
        return x.narrow(dim, tokens.start, tokens.per_rank).contiguous()

    @staticmethod
    def backward(ctx, g):
        t = ctx.tokens
        shape = list(g.shape)
        shape[ctx.dim] = t.per_rank * t.axis.size
        full = g.new_zeros(shape)
        full.narrow(ctx.dim, t.start, t.per_rank).copy_(g)
        return full.narrow(ctx.dim, 0, t.n), None, None, None


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tokens, dim):
        ctx.tokens, ctx.dim = tokens, dim
        parts = _all_gather(x, tokens.axis, "gather_tokens")
        return torch.cat(parts, dim=dim).narrow(dim, 0, tokens.n)

    @staticmethod
    def backward(ctx, g):
        # every rank's tokens were used by every rank: the cotangent of
        # this rank's slice is the sum over sp of that slice (all-reduce,
        # then the slice: reduce-scatter as gloo can run it)
        t = ctx.tokens
        g = _pad_to(g, ctx.dim, t.per_rank * t.axis.size)
        g = _all_reduce(g, t.axis, "gather_tokens backward")
        return g.narrow(ctx.dim, t.start, t.per_rank), None, None


def slice_tokens(x: torch.Tensor, tokens: Tokens, dim: int = 1,
                 pad_value=0) -> torch.Tensor:
    """This rank's `tokens.per_rank` tokens of x's axis `dim` (n long),
    the axis padded with `pad_value` to a multiple of sp."""
    return _SliceTokens.apply(x, tokens, dim, pad_value)


def gather_tokens(x: torch.Tensor, tokens: Tokens, dim: int = 1
                  ) -> torch.Tensor:
    """Every rank's slice of axis `dim`, in sp order, the pad stripped:
    the whole n tokens."""
    return _GatherTokens.apply(x, tokens, dim)


class RowLinear(nn.Linear):
    """A Linear that may be row-parallel: with `tp` (the mp axis, set by
    `parallel/sharding.py:shard_model`) its weight holds this rank's input
    features, the partial products are summed over mp and the bias, whole
    on every rank, is added once."""
    tp = None

    def forward(self, x):
        if self.tp is None:
            return super().forward(x)
        return reduce_from_mp(F.linear(x, self.weight), self.tp) + self.bias


def column_input(x: torch.Tensor, tp) -> torch.Tensor:
    """The input of a column-parallel block: `copy_to_mp` under mp, x as
    it is without."""
    return x if tp is None else copy_to_mp(x, tp)


def feed_forward(layer, x, key=None, index: int = 0, parts=()):
    """linear2(drop(relu(linear1(x)))) of a transformer layer (its
    `linear1`, `linear2` (a `RowLinear`), `dropout` and `tp`), draw `index`
    inside; `parts` the dropout parts of x's other axes (its tokens under
    sp). Under mp linear1 is column-parallel: this rank's hidden features,
    whose part of the whole hidden's mask it draws."""
    tp = layer.tp
    h = F.relu(layer.linear1(column_input(x, tp)))
    if tp is not None:
        n = h.shape[-1]
        parts = tuple(parts) + ((h.dim() - 1, tp.index * n, n * tp.size),)
    return layer.linear2(layer.dropout(h, key, index, parts))
