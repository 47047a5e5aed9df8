"""Dataset registry and build functions; port of
`boxer_tpu/dataset/__init__.py`.

Parity: reference `e2edet/dataset/__init__.py:19-93` (`build_dataset`,
`build_dataloader`, `register_task`). The tasks: COCO (`detection`) and
Waymo (`detection3d`). Besides: `synthetic` (seeded training batches).
"""

import os

import torch

from boxer_tpu_torch.utils.registry import TASK_REGISTRY


def register_task(name):
    return TASK_REGISTRY.register(name)


def build_dataset(task_name: str, dataset_config, dataset_type: str):
    """Returns None when the split's annotation file doesn't exist (so
    partial run_types work without the full corpus on disk)."""
    imdb_files = dataset_config.get("imdb_files", {})
    if dataset_type not in imdb_files:
        return None
    imdb = imdb_files[dataset_type]
    cfg = dataset_config.to_dict() if hasattr(dataset_config, "to_dict") \
        else dict(dataset_config)
    imdb = dict(imdb) if not isinstance(imdb, dict) else imdb

    task_cls = TASK_REGISTRY.get(task_name)
    root = os.environ.get("E2E_DATASETS", ".")
    index_file = imdb.get("anno_file") or imdb.get("info_path")
    index_path = (index_file if os.path.isabs(index_file)
                  else os.path.join(root, index_file))
    if not os.path.exists(index_path):
        return None
    return task_cls(cfg, dataset_type, imdb)


def build_dataloader(dataset, dataset_type: str, batch_size: int,
                     num_workers: int = 2, iter_per_update: int = 1,
                     seed: int = 0, device=None, replicas=None, rank=None):
    """The split's loader; its batches are tensors on `device` (CPU by
    default). The sampler's replicas are the data shards (`replicas`, this
    one `rank`: the trainer's dp axis; by default the torch.distributed
    group's processes, 1 without a group); a dataset whose config sets
    `cache_mode` takes the shard-first sampler, as the JAX package's."""
    from boxer_tpu_torch.dataset.helper.loader import DataLoader
    from boxer_tpu_torch.dataset.helper.sampler import (
        DistributedSampler,
        ShardDistributedSampler,
    )

    dist = torch.distributed
    grouped = dist.is_available() and dist.is_initialized()
    if replicas is None:
        replicas = dist.get_world_size() if grouped else 1
        rank = dist.get_rank() if grouped else 0
    cache_mode = bool(getattr(dataset, "config", {}).get("cache_mode", False))
    sampler_cls = ShardDistributedSampler if cache_mode else DistributedSampler
    sampler = sampler_cls(
        len(dataset),
        num_replicas=replicas,
        rank=rank,
        shuffle=(dataset_type == "train"),
        seed=seed,
    )
    return DataLoader(
        dataset, sampler, batch_size=batch_size, num_workers=num_workers,
        iter_per_update=iter_per_update,
        drop_last=(dataset_type == "train" and iter_per_update > 1),
        seed=seed, device=device)


# populate registry
from boxer_tpu_torch.dataset.coco import COCODetection  # noqa: E402,F401
from boxer_tpu_torch.dataset.waymo import WaymoDetection  # noqa: E402,F401
