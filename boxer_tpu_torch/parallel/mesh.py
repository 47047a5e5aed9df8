"""The (dp, mp, sp) layout; port of `boxer_tpu/parallel/mesh.py` for data
parallelism only.

The JAX package builds a device mesh with named axes dp, sp, mp
(`create_mesh`); the port runs one process per device, and one rank is one
`dp` shard, so there is no mesh object: the layout is resolved against the
number of processes, as `create_mesh` resolves it against the devices.
"""

from typing import Mapping, Optional


def resolve_dp(world_size: int, dp: Optional[int] = None, mp: int = 1,
               sp: int = 1) -> int:
    """The data-parallel size of a run of `world_size` processes: `dp`
    None means the world size (over mp * sp). dp * mp * sp must equal the
    world size; mp or sp above 1 raise NotImplementedError (model and
    sequence parallelism are not ported)."""
    mp, sp = int(mp or 1), int(sp or 1)
    for axis, size in (("mp", mp), ("sp", sp)):
        if size > 1:
            raise NotImplementedError(
                f"distributed.{axis}={size}: the port runs data parallel "
                "only; the mp and sp axes are the last item of ROADMAP "
                "queue 1, item 5")
    if dp is None:
        dp = world_size
    dp = int(dp)
    if dp < 1 or dp * mp * sp != world_size:
        raise ValueError(f"dp({dp}) * mp({mp}) * sp({sp}) != world size "
                         f"({world_size} processes)")
    return dp


def num_processes(dist_config: Mapping) -> int:
    """The processes a run of the `distributed` config node takes: `dp`,
    or `world_size` when dp is null (the config's `${device_count:}`: the
    visible cards on cuda, 1 on cpu), as the JAX config reads it."""
    dp = dist_config.get("dp")
    return int(dp if dp is not None else dist_config.get("world_size") or 1)
