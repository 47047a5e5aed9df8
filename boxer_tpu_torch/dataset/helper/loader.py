"""Threaded data loader with the host-to-device copy; port of
`boxer_tpu/dataset/helper/loader.py`.

Worker threads run the host-side load/augment/collate pipeline, one whole
batch each, and the batches come out in sampler order. Every batch has its
own `np.random.RandomState`, seeded by the loader's seed, the batch's index
in the epoch and the sampler's epoch (and, in a data-parallel run, the
rank), so a batch is the same whichever thread builds it and a resumed
epoch that starts at batch `start` replays the rest of it exactly.

A dataset with state that its loads advance (the Waymo task's GT-database
sampler, whose per-class cursors every frame moves) exposes `draw(idx,
rng)`, `draw_state()` and `set_draw_state(state)`. The loader takes a
batch's draws on the consumer's thread as it submits the batch, in batch
order, from a second RandomState of the batch's seed, and hands them to
`load(idx, rng, drawn)`; so the draws follow batch order however the
workers run (the JAX loader's single producer thread draws in its loads,
from the batch's own RandomState). `draw_state` is the dataset's state
after the last batch handed out; `iterate` starts from it, so draws made
for batches fetched ahead and never handed out are taken again, and a
trainer that records it in a checkpoint resumes with the same draws.

On a CUDA device the worker also pins the batch, and the consumer's thread
copies it to the card `non_blocking` on its current stream as it hands the
batch out, in place of the JAX loader's `jax.device_put`: the step, on the
same stream, reads it after the copy, and the pinned host memory is kept
until the copy is done. A side-stream copy from the worker (the reference's
`Prefetcher`, `dataset/helper/prefetcher.py:11-62`) measured no faster on
an H100 (`tools/bench_trainer.py`); a pageable copy on the consumer's
thread cost it about 18 ms an update.
"""

import collections
import itertools
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
import torch

_HOST_KEYS = ("meta", "grid_shape", "batch_size")


class DataLoader:
    """dataset: must expose load(idx, rng) + collate(items).

    iter_per_update > 1 stacks microbatches on a leading axis (reference
    `collate_fn.py:93-111` split); with iter_per_update 1 every array gets a
    leading axis of 1. Batches hold torch tensors on `device` (CPU tensors
    share the collated numpy memory); `meta` and the static 3D entries stay
    on the host."""

    def __init__(self, dataset, sampler, batch_size: int,
                 num_workers: int = 2, iter_per_update: int = 1,
                 drop_last: bool = False, seed: int = 0,
                 device: Optional[torch.device] = None):
        if batch_size % iter_per_update:
            raise ValueError(f"batch_size {batch_size} is not a multiple of "
                             f"iter_per_update {iter_per_update}")
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.iter_per_update = iter_per_update
        self.drop_last = drop_last
        self.seed = seed
        self.device = torch.device(device or "cpu")
        self.draw_state = None

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batches(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            while len(batch) < self.batch_size:  # pad to fixed shape
                batch.append(batch[len(batch) % len(batch) - 1])
            yield batch

    def __iter__(self) -> Iterator:
        return self.iterate()

    def iterate(self, start: int = 0) -> Iterator:
        """The epoch's batches from batch index `start` on (the earlier ones
        are not loaded); each as the whole epoch's run would give it."""
        todo = itertools.islice(enumerate(self._batches()), start, None)
        drawing = hasattr(self.dataset, "draw")
        if drawing and self.draw_state is not None:
            self.dataset.set_draw_state(self.draw_state)
        pool = ThreadPoolExecutor(self.num_workers)

        def submit(bi, indices):
            if not drawing:
                return pool.submit(self._make, bi, indices), None
            rng = np.random.RandomState(self._seed(bi, 1))
            drawn = [self.dataset.draw(i, rng) for i in indices]
            return (pool.submit(self._make, bi, indices, drawn),
                    self.dataset.draw_state())

        pending = collections.deque(
            submit(bi, indices)
            for bi, indices in itertools.islice(todo, self.num_workers + 1))
        try:
            while pending:
                future, state = pending.popleft()
                batch = future.result()
                for bi, indices in itertools.islice(todo, 1):
                    pending.append(submit(bi, indices))
                if drawing:
                    self.draw_state = state
                yield _map_arrays(batch, lambda t: t.to(self.device,
                                                         non_blocking=True))
        finally:
            pool.shutdown(wait=True, cancel_futures=True)

    def _seed(self, bi, *stream):
        """The seed of batch bi's RandomState (stream 1: its draws): the
        JAX loader's seed, wrapped to RandomState's 32 bits (there it
        overflows, and raises, for any loader seed above 42,948); with more
        than one replica the sampler's (replicas, rank) are folded in, so
        the ranks of a data-parallel run augment (and draw for) their own
        images differently (the JAX loader gives every process the same
        stream)."""
        seed = ((self.seed * 100003 + bi * 1009
                 + getattr(self.sampler, "epoch", 0)) % 2 ** 32)
        replicas = getattr(self.sampler, "num_replicas", 1)
        key = [seed, *stream] + ([replicas, self.sampler.rank]
                                 if replicas > 1 else [])
        return key if len(key) > 1 else seed

    def _make(self, bi, indices, drawn=None):
        rng = np.random.RandomState(self._seed(bi))
        if drawn is None:
            items = [self.dataset.load(i, rng) for i in indices]
        else:
            items = [self.dataset.load(i, rng, d)
                     for i, d in zip(indices, drawn)]
        batch = self._reshape_microbatches(self.dataset.collate(items))
        pinned = self.device.type == "cuda"
        return _map_arrays(batch, lambda x: torch.from_numpy(x).pin_memory()
                           if pinned else torch.from_numpy(x))

    def _reshape_microbatches(self, batch):
        a = self.iter_per_update
        mb = self.batch_size // a

        if a == 1:
            # single microbatch: uniform leading A=1 dim on every array
            def split(x):
                return x[None] if isinstance(x, np.ndarray) else x
        else:
            # voxel batches: every sample occupies a fixed max_voxel_num
            # block (pad_voxels), so the (B*MV, ...) arrays split evenly
            # into (A, MB*MV, ...); the batch prefix in coordinates is
            # remapped from the global sample index to the within-microbatch
            # index (padding rows keep -1). Reference split semantics:
            # `collate_fn.py:115-196`.
            nvox = (batch["voxels"].shape[0] // self.batch_size
                    if "voxels" in batch else 0)

            def split(x):
                if not isinstance(x, np.ndarray):
                    return x
                if x.shape[0] == self.batch_size:
                    return x.reshape((a, mb) + x.shape[1:])
                if nvox and x.shape[0] == self.batch_size * nvox:
                    return x.reshape((a, mb * nvox) + x.shape[1:])
                return x

        out = {}
        for k, v in batch.items():
            if k in _HOST_KEYS:
                out[k] = v
            elif isinstance(v, dict):
                out[k] = {kk: split(vv) for kk, vv in v.items()}
            else:
                out[k] = split(v)
        if a > 1 and "coordinates" in out:
            c = out["coordinates"]
            out["coordinates"] = np.concatenate(
                [np.where(c[..., :1] >= 0, c[..., :1] % mb, -1), c[..., 1:]],
                axis=-1)
            # the static batch size the model takes is a microbatch's (the
            # JAX trainer passes it to its step; the batch keeps B there)
            out["batch_size"] = mb
        return out


def _map_arrays(batch, fn):
    """fn over every array (numpy or torch) of the batch (one level of
    nesting); the host keys as they are."""
    arrays = (np.ndarray, torch.Tensor)
    out = {}
    for k, v in batch.items():
        if k in _HOST_KEYS:
            out[k] = v
        elif isinstance(v, dict):
            out[k] = {kk: fn(vv) if isinstance(vv, arrays) else vv
                      for kk, vv in v.items()}
        else:
            out[k] = fn(v) if isinstance(v, arrays) else v
    return out
