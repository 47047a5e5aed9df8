"""The (dp, sp, mp) layout and its process groups; port of
`boxer_tpu/parallel/mesh.py`.

The JAX package builds one device mesh with named axes dp, sp, mp
(`create_mesh`, devices laid out as `reshape(dp, sp, mp)`); the port runs
one process per device, so the layout is resolved against the processes
and each axis is a set of `torch.distributed` groups:

  dp   data parallel: the batch is split over it;
  sp   sequence parallel: BoxeR-2D's encoder tokens are split over it;
  mp   tensor parallel: attention heads and FFN hidden features are split
       over it (`parallel/sharding.py`);
  grad dp x sp, the ranks that hold the same parameter shard: a
       gradient is summed over it.

Rank r has the coordinate (d, s, m) with r = (d * sp + s) * mp + m, as
JAX's reshape orders devices. A world of one process has no group.
"""

from dataclasses import dataclass
from typing import Any, Mapping, Optional


def resolve_dp(world_size: int, dp: Optional[int] = None, mp: int = 1,
               sp: int = 1) -> int:
    """The data-parallel size of a run of `world_size` processes: `dp`
    None means the world size over mp * sp. dp * sp * mp must equal the
    world size; otherwise ValueError."""
    mp, sp = int(mp or 1), int(sp or 1)
    if mp < 1 or sp < 1:
        raise ValueError(f"mp({mp}) and sp({sp}) must be at least 1")
    if dp is None:
        if world_size % (mp * sp):
            raise ValueError(f"{world_size} processes (the world size) do "
                             f"not split into mp({mp}) * sp({sp})")
        dp = world_size // (mp * sp)
    dp = int(dp)
    if dp < 1 or dp * mp * sp != world_size:
        raise ValueError(f"dp({dp}) * sp({sp}) * mp({mp}) != world size "
                         f"({world_size} processes)")
    return dp


def num_processes(dist_config: Mapping) -> int:
    """The processes a run of the `distributed` config node takes: dp * sp
    * mp, or `world_size` when dp is null (the config's `${device_count:}`:
    the visible cards on cuda, 1 on cpu), as the JAX config reads it."""
    dp = dist_config.get("dp")
    if dp is None:
        return int(dist_config.get("world_size") or 1)
    return int(dp) * int(dist_config.get("sp") or 1) * int(
        dist_config.get("mp") or 1)


@dataclass(frozen=True, eq=False)
class Axis:
    """One axis as a rank sees it: its size, the rank's index on it, and
    the group of the ranks that differ from this one only on it (None at
    size 1)."""
    size: int = 1
    index: int = 0
    group: Any = None


@dataclass(frozen=True, eq=False)
class Layout:
    dp: Axis = Axis()
    sp: Axis = Axis()
    mp: Axis = Axis()
    grad: Axis = Axis()

    @property
    def world(self) -> int:
        return self.dp.size * self.sp.size * self.mp.size

    @property
    def leads_shard(self) -> bool:
        """The rank at (s, m) = (0, 0): the one that speaks for its data
        shard (its eval records; the others hold the same)."""
        return self.sp.index == 0 and self.mp.index == 0


def create_layout(dp: Optional[int] = None, mp: int = 1,
                  sp: int = 1) -> Layout:
    """The layout of this process group (a world of one without a group):
    every group is made here, on every rank in the same order, as
    `dist.new_group` requires. A group that spans the world is the default
    group."""
    import torch.distributed as dist

    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    rank = dist.get_rank() if grouped else 0
    mp, sp = int(mp or 1), int(sp or 1)
    dp = resolve_dp(world, dp, mp, sp)
    d, s, m = rank // (sp * mp), rank // mp % sp, rank % mp

    def rank_of(d_, s_, m_):
        return (d_ * sp + s_) * mp + m_

    def axis(size, index, groups):
        """groups: every group of this axis as (its ranks in index order);
        this rank's is the one that holds it."""
        mine = None
        for ranks in groups:
            if size == 1:
                continue
            g = (dist.group.WORLD if len(ranks) == world
                 else dist.new_group(ranks))
            if rank in ranks:
                mine = g
        return Axis(size, index, mine)

    return Layout(
        dp=axis(dp, d, [[rank_of(i, s_, m_) for i in range(dp)]
                        for s_ in range(sp) for m_ in range(mp)]),
        sp=axis(sp, s, [[rank_of(d_, i, m_) for i in range(sp)]
                        for d_ in range(dp) for m_ in range(mp)]),
        mp=axis(mp, m, [[rank_of(d_, s_, i) for i in range(mp)]
                        for d_ in range(dp) for s_ in range(sp)]),
        grad=axis(dp * sp, d * sp + s,
                  [[rank_of(i // sp, i % sp, m_) for i in range(dp * sp)]
                   for m_ in range(mp)]))
