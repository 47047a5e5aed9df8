"""Process-group utilities and the launcher; port of
`boxer_tpu/parallel/distributed.py`.

One process drives one device and is one rank of a `torch.distributed`
process group, as the reference's `e2edet/utils/distributed.py` and
`tools/run.py:43-78` arrange it (the JAX package runs one program over a
device mesh instead). Without a process group every function answers for a
world of one process and communicates nothing.

- `get_rank`, `get_world_size`, `is_master`, `is_dist_avail_and_initialized`
  (a process group exists, whatever its size);
- `synchronize` (a barrier), `all_gather` / `gather` of picklables,
  `broadcast_scalar`, `reduce_dict`, `shared_random_seed`; `broadcast`
  and `all_reduce_sum` of a tensor, in place (`all_reduce_sum` over a
  group of the layout, `parallel/mesh.py`, too);
- `initialize_if_needed`: joins the group that torchrun's environment
  describes (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`,
  `MASTER_PORT`);
- `launch`: runs a function in `world_size` new processes, one rank each,
  joined into one group at a free localhost port (the CLI's way to use
  every card of a node, and how the tests run two ranks on the CPU).
"""

import os
import socket
import time
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def is_dist_avail_and_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    return dist.get_rank() if is_dist_avail_and_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if is_dist_avail_and_initialized() else 1


def is_master() -> bool:
    return get_rank() == 0


def synchronize():
    """A barrier over every rank (nothing without a group)."""
    if is_dist_avail_and_initialized():
        dist.barrier()


def all_gather(data: Any) -> List[Any]:
    """Every rank's picklable `data`, in rank order, on every rank."""
    if not is_dist_avail_and_initialized():
        return [data]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, data)
    return out


def gather(data: Any, dst: int = 0) -> List[Any]:
    """Every rank's picklable `data` in rank order on `dst`, [] on the
    others."""
    if not is_dist_avail_and_initialized():
        return [data]
    out = [None] * dist.get_world_size() if get_rank() == dst else None
    dist.gather_object(data, out, dst=dst)
    return out or []


def broadcast_scalar(value, src: int = 0):
    """`src`'s python scalar on every rank."""
    if not is_dist_avail_and_initialized():
        return value
    box = [value]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def reduce_dict(d, average: bool = True):
    """The mean (or sum) over ranks of a dict of scalars, as host floats."""
    gathered = all_gather({k: float(v) for k, v in d.items()})
    return {k: sum(g[k] for g in gathered) / (len(gathered) if average
                                               else 1) for k in d}


def shared_random_seed(low: int = 0, high: int = 2 ** 31) -> int:
    """One draw from [low, high) on rank 0, the same on every rank."""
    return int(broadcast_scalar(int(np.random.randint(low, high))))


def broadcast(tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
    """`src`'s tensor, in place, on every rank."""
    if is_dist_avail_and_initialized():
        dist.broadcast(tensor, src=src)
    return tensor


def all_reduce_sum(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Sum `tensor` over the ranks (of `group`, by default the world's) in
    place and return it (as it is without a process group)."""
    if is_dist_avail_and_initialized():
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
    return tensor


def initialize_if_needed(backend: str) -> bool:
    """Join the process group that torchrun's environment describes, on
    the card LOCAL_RANK for NCCL; True if this process is one of its
    ranks. Without WORLD_SIZE in the environment it does nothing."""
    if "WORLD_SIZE" not in os.environ or is_dist_avail_and_initialized():
        return is_dist_avail_and_initialized()
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, init_method="env://")
    return True


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(fn: Callable, world_size: int, backend: str, args: Sequence = (),
           devices: Optional[Sequence[int]] = None,
           timeout: Optional[float] = None):
    """Run fn(*args) in `world_size` new (spawned) processes, rank r joined
    to one process group over `backend` ("nccl" or "gloo") at a free
    localhost port, with card `devices[r]` as its current CUDA device
    (`devices` None: the ranks use no card). Returns when every rank has
    returned; raises when a rank fails (the others are terminated) or,
    past `timeout` seconds, kills every rank and raises TimeoutError.
    `fn` must be importable by name (a module's top-level function).
    Ranks without a card share this process's threads: each takes
    `torch.get_num_threads() // world_size`, at least one, so a budget
    given to the launcher (`OMP_NUM_THREADS`) holds for its ranks."""
    if devices is not None and len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    port = _free_port()
    threads = max(1, torch.get_num_threads() // world_size)
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(fn, tuple(args), world_size, backend, port,
                          None if devices is None else tuple(devices),
                          threads),
        nprocs=world_size, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"{world_size} ranks of {fn.__name__} still running "
                    f"after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def _rank_main(rank, fn, args, world_size, backend, port, devices, threads):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    if devices is not None:
        torch.cuda.set_device(devices[rank])
    else:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world_size)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()
