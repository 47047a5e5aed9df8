"""ZeRO-1: the optimizer state sharded over the data-parallel ranks; port of
the ZeRO-1 part of `boxer_tpu/parallel/sharding.py`.

The JAX package shards each optimizer moment's largest axis over `dp`
(`_zero1_spec`); `torch.distributed.optim.ZeroRedundancyOptimizer` gives
each rank whole parameters instead (the largest first, each to the rank
holding the fewest elements so far, group by group) and broadcasts each
updated parameter from its owner after the step. Both compute the same
update; only where the state lives differs. The batch and tensor-parallel
rules (`batch_sharding`, `param_spec`) have no counterpart at `dp` only: a
rank holds its own batch and every parameter.
"""

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.optim import ZeroRedundancyOptimizer


def zero1(optimizer: torch.optim.Optimizer) -> ZeroRedundancyOptimizer:
    """`optimizer`'s class over the same parameter groups (their names,
    base LRs and hyperparameters kept), its state sharded over the ranks of
    the default process group. The LR is set through the wrapper's
    `param_groups`, which its step copies to the local optimizer."""
    return ZeroRedundancyOptimizer([dict(g) for g in optimizer.param_groups],
                                   optimizer_class=type(optimizer))


def optimizer_state_dict(optimizer: torch.optim.Optimizer) -> Optional[dict]:
    """The optimizer's whole state as a plain optimizer over the same groups
    gives it (global parameter indices), so a checkpoint does not depend on
    the world size. From a ZeRO-1 optimizer every rank sends its shard,
    keyed by global index and on the CPU, to rank 0 in one `gather_object`
    (every rank must call this; the others get None). ZeRO's own
    `consolidate_state_dict` moves the same state, one broadcast a rank,
    each byte tensor built from a bytearray element by element, which is
    far slower (`chip_smoke.py` phase 12 times both; `PERF.md` §6)."""
    if not isinstance(optimizer, ZeroRedundancyOptimizer):
        return optimizer.state_dict()
    index = {id(p): i for i, p in enumerate(
        p for g in optimizer.param_groups for p in g["params"])}
    shard = {index[id(p)]: {k: v.cpu() if torch.is_tensor(v) else v
                            for k, v in st.items()}
             for p, st in optimizer.optim.state.items()}
    rank = dist.get_rank()
    shards = [None] * dist.get_world_size() if rank == 0 else None
    dist.gather_object(shard, shards, dst=0)
    if rank != 0:
        return None
    out = torch.optim.Optimizer.state_dict(optimizer)
    out["state"] = dict(sorted((i, st) for part in shards
                               for i, st in part.items()))
    return out

