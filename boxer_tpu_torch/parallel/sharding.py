"""Parameter sharding over mp and ZeRO-1 over dp; port of
`boxer_tpu/parallel/sharding.py`.

Tensor parallel (mp), Megatron's column / row form. The JAX package's
`param_spec` shards, by name, every Dense kernel under `linear1`,
`value_proj`, `query`, `key` or `value` over its output features and every
one under `linear2`, `out_proj` or `out` over its input features, and XLA
inserts the collectives. The port cuts the same weights (`tp_rule`), by
head where a weight feeds attention heads: `value_proj` and `linear1`
(rows, with their biases), each of the q, k and v blocks of a dense
attention's packed `in_proj_weight` and `in_proj_bias` (rows), `out_proj`
and `linear2` (columns; their biases stay whole). It also cuts the rows of
`linear_box_*` and `linear_attn_*`, which JAX keeps whole: their outputs
are read by head, so each rank computes only its heads' offsets and
weights and every parameter is either mp-sharded or mp-identical. The
modules run the collectives (`parallel/collectives.py`); `shard_model`
cuts a whole model into this rank's part and `gather_state` puts a state
dict back together, so checkpoints hold the whole model.

ZeRO-1 (dp). The JAX package shards each optimizer moment's largest axis
over `dp` (`_zero1_spec`), keeping its mp sharding;
`torch.distributed.optim.ZeroRedundancyOptimizer` over the dp group gives
each dp rank whole (mp-local) parameters instead (the largest first, each
to the rank holding the fewest elements so far, group by group) and
broadcasts each updated parameter from its owner after the step. Both
compute the same update; only where the state lives differs.
"""

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.optim import ZeroRedundancyOptimizer

from boxer_tpu_torch.parallel.mesh import Layout

# parameter names cut over mp, by how (see the module docstring)
_COLUMN = ("value_proj.weight", "value_proj.bias", "linear1.weight",
           "linear1.bias", "linear_box_weight", "linear_box_bias",
           "linear_attn_weight", "linear_attn_bias")
_QKV = ("in_proj_weight", "in_proj_bias")
_ROW = ("out_proj.weight", "linear2.weight")


def tp_rule(name: str) -> Optional[str]:
    """"column" (rows cut), "qkv" (each third's rows cut), "row" (columns
    cut) or None (whole on every mp rank) for a parameter's name."""
    for kind, leaves in (("column", _COLUMN), ("qkv", _QKV), ("row", _ROW)):
        if any(name == leaf or name.endswith("." + leaf) for leaf in leaves):
            return kind
    return None


def _part(t: torch.Tensor, kind: str, size: int, index: int):
    if kind == "column":
        return t.chunk(size, 0)[index]
    if kind == "row":
        return t.chunk(size, 1)[index]
    return torch.cat([third.chunk(size, 0)[index] for third in t.chunk(3)])


def _whole(parts: Sequence[torch.Tensor], kind: str):
    if kind == "column":
        return torch.cat(list(parts), 0)
    if kind == "row":
        return torch.cat(list(parts), 1)
    return torch.cat([torch.cat([p.chunk(3)[j] for p in parts])
                      for j in range(3)])


def shard_state(state: Dict[str, torch.Tensor], layout: Layout
                ) -> Dict[str, torch.Tensor]:
    """This rank's part of a whole model's state dict: every tensor that
    `tp_rule` names cut to this rank's heads or features, the rest as
    they are."""
    mp = layout.mp
    if mp.size == 1:
        return dict(state)
    return {k: (_part(v, tp_rule(k), mp.size, mp.index).clone()
                if tp_rule(k) and v.dim() > 0 else v)
            for k, v in state.items()}


def gather_state(state: Dict[str, torch.Tensor], layout: Layout
                 ) -> Dict[str, torch.Tensor]:
    """The whole model's state dict from every mp rank's part (all
    tensors of one dtype go in one all_gather over the mp group; every mp
    rank must call it and gets the whole state)."""
    mp = layout.mp
    if mp.size == 1:
        return dict(state)
    out = dict(state)
    cut = [k for k, v in state.items() if tp_rule(k) and v.dim() > 0]
    for dtype in sorted({state[k].dtype for k in cut}, key=str):
        keys = [k for k in cut if state[k].dtype == dtype]
        flat = torch.cat([state[k].detach().reshape(-1) for k in keys])
        parts = [torch.empty_like(flat) for _ in range(mp.size)]
        dist.all_gather(parts, flat.contiguous(), group=mp.group)
        offset = 0
        for k in keys:
            n = state[k].numel()
            out[k] = _whole([p[offset:offset + n].view_as(state[k])
                             for p in parts], tp_rule(k))
            offset += n
    return out


def shard_model(model: nn.Module, layout: Layout) -> nn.Module:
    """Cut a whole model (the same weights on every rank) to this rank's
    part of `layout`, in place: under mp its `tp_rule` parameters become
    this rank's part and every module that runs a collective of tensor
    parallelism takes the mp axis (`tp`), its attention modules holding H
    / mp heads; under sp its transformer, built with `seq_shard` (BoxeR-2D
    only, `models.check_seq_shard`), takes the sp axis. Call it before the
    optimizer is built."""
    sp, mp = layout.sp, layout.mp
    if sp.size > 1:
        model.transformer.sp = sp
    if mp.size == 1:
        return model
    for name, mod in model.named_modules():
        heads = getattr(mod, "num_head", getattr(mod, "num_heads", None))
        ff = getattr(getattr(mod, "linear1", None), "out_features", None)
        for what, n in (("heads", heads), ("FFN features", ff)):
            if hasattr(type(mod), "tp") and n is not None and n % mp.size:
                raise ValueError(f"{name}: {n} {what} do not split over "
                                 f"mp={mp.size}")
    params = dict(model.named_parameters())
    local = shard_state({k: v.detach() for k, v in params.items()
                         if tp_rule(k)}, layout)
    for name, t in local.items():
        owner, leaf = name.rsplit(".", 1)
        setattr(model.get_submodule(owner), leaf, nn.Parameter(
            t, requires_grad=params[name].requires_grad))
    for mod in model.modules():
        if not hasattr(type(mod), "tp"):
            continue
        mod.tp = mp
        for attr in ("num_head", "num_heads"):
            if hasattr(mod, attr):
                setattr(mod, attr, getattr(mod, attr) // mp.size)
    return model


def zero1(optimizer: torch.optim.Optimizer, group=None
          ) -> ZeroRedundancyOptimizer:
    """`optimizer`'s class over the same parameter groups (their names,
    base LRs and hyperparameters kept), its state sharded over the ranks of
    `group` (the dp group; None: the default group). The LR is set
    through the wrapper's `param_groups`, which its step copies to the
    local optimizer."""
    return ZeroRedundancyOptimizer([dict(g) for g in optimizer.param_groups],
                                   optimizer_class=type(optimizer),
                                   process_group=group)


def param_names(model: nn.Module, optimizer: torch.optim.Optimizer
                ) -> List[str]:
    """The names of the optimizer's parameters in its global index order."""
    name_of = {id(p): n for n, p in model.named_parameters()}
    return [name_of[id(p)] for g in optimizer.param_groups
            for p in g["params"]]


def _state_by_name(state_dict, names, fn):
    """A copy of the optimizer state dict with `fn({name: tensor})` over
    its tensors of each state key (the moments; a scalar step count is
    left)."""
    state = {i: dict(st) for i, st in state_dict["state"].items()}
    state_dict = dict(state_dict, state=state)
    keys = sorted({k for st in state.values() for k, v in st.items()
                   if torch.is_tensor(v) and v.dim() > 0})
    for k in keys:
        done = fn({names[i]: st[k] for i, st in sorted(state.items())
                   if k in st})
        for i, st in state.items():
            if k in st:
                st[k] = done[names[i]]
    return state_dict


def optimizer_state_dict(optimizer: torch.optim.Optimizer,
                         layout: Optional[Layout] = None,
                         names: Optional[List[str]] = None) -> Optional[dict]:
    """The optimizer's whole state as a plain optimizer over the whole
    model gives it (global parameter indices), so a checkpoint does not
    depend on the layout. From a ZeRO-1 optimizer every dp rank sends its
    shard, keyed by global index and on the CPU, to its dp group's first
    rank in one `gather_object` (every rank must call this; the others
    get None); ZeRO's own `consolidate_state_dict` moves the same state,
    one broadcast a rank, each byte tensor built from a bytearray element
    by element, which is far slower (`chip_smoke.py` phase 12 times both;
    `PERF.md` §6). Under mp (`layout`, with the parameters' `names` in
    index order) the moments' parts are then gathered over mp into whole
    tensors; the result is the whole state on rank 0."""
    if isinstance(optimizer, ZeroRedundancyOptimizer):
        index = {id(p): i for i, p in enumerate(
            p for g in optimizer.param_groups for p in g["params"])}
        shard = {index[id(p)]: {k: v.cpu() if torch.is_tensor(v) else v
                                for k, v in st.items()}
                 for p, st in optimizer.optim.state.items()}
        group = optimizer.process_group
        first = (0 if group in (None, dist.group.WORLD)
                 else dist.get_global_rank(group, 0))
        mine = dist.get_rank() == first
        shards = [None] * dist.get_world_size(group) if mine else None
        dist.gather_object(shard, shards, dst=first, group=group)
        if not mine:
            return None
        out = torch.optim.Optimizer.state_dict(optimizer)
        out["state"] = dict(sorted((i, st) for part in shards
                                   for i, st in part.items()))
    else:
        out = optimizer.state_dict()
    if layout is None or layout.mp.size == 1:
        return out
    device = optimizer.param_groups[0]["params"][0].device
    return _state_by_name(out, names, lambda part: {
        k: v.cpu() for k, v in gather_state(
            {k: v.to(device) for k, v in part.items()}, layout).items()})


def load_optimizer_state(optimizer: torch.optim.Optimizer, state_dict: dict,
                         layout: Optional[Layout] = None,
                         names: Optional[List[str]] = None):
    """Load a whole state (`optimizer_state_dict`'s) into this rank's
    optimizer: under mp each moment cut to this rank's part first."""
    if layout is not None and layout.mp.size > 1:
        state_dict = _state_by_name(state_dict, names, lambda part: (
            shard_state(part, layout)))
    optimizer.load_state_dict(state_dict)
