"""Epoch-seeded distributed samplers; copy of
`boxer_tpu/dataset/helper/sampler.py`.

Parity: reference `e2edet/dataset/helper/sampler.py:8-90` —
DistributedSampler (pad to even shards, shard round-robin, epoch-seeded
shuffle) and ShardDistributedSampler (shard first, contiguous, then
shuffle within the shard, so that a `cache_mode` dataset's ranks each keep
their own images in RAM). "Rank" is the data shard (the trainer's dp axis:
0 of 1 without a torch.distributed group).
"""

from typing import Iterator, List

import numpy as np


class DistributedSampler:
    def __init__(self, dataset_len: int, num_replicas: int = 1, rank: int = 0,
                 shuffle: bool = True, seed: int = 0):
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.num_samples = -(-dataset_len // num_replicas)
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _padded_indices(self) -> np.ndarray:
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            indices = rng.permutation(self.dataset_len)
        else:
            indices = np.arange(self.dataset_len)
        pad = self.total_size - len(indices)
        if pad > 0:
            indices = np.concatenate([indices, indices[:pad]])
        return indices

    def __iter__(self) -> Iterator[int]:
        indices = self._padded_indices()
        return iter(indices[self.rank:self.total_size:self.num_replicas].tolist())

    def __len__(self):
        return self.num_samples


class ShardDistributedSampler(DistributedSampler):
    """Shard first (contiguous), then shuffle within the shard (reference
    `sampler.py:56-90`)."""

    def __iter__(self) -> Iterator[int]:
        indices = np.arange(self.dataset_len)
        pad = self.total_size - len(indices)
        if pad > 0:
            indices = np.concatenate([indices, indices[:pad]])
        shard = indices[self.rank * self.num_samples:
                        (self.rank + 1) * self.num_samples]
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            shard = rng.permutation(shard)
        return iter(shard.tolist())
