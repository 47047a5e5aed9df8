"""Model registry and build function; port of
`boxer_tpu/models/__init__.py`.

`build_model` returns the module built from its config node (the
constructors' `from_config` reads the JAX package's config keys); its
weights are filled by the caller.
"""

import inspect

from boxer_tpu_torch.utils.registry import MODEL_REGISTRY


def register_model(name):
    return MODEL_REGISTRY.register(name)


def check_seq_shard(config):
    """Raise ValueError unless the model of `config` takes `seq_shard`
    (sequence parallelism): only BoxeR-2D does, as in the JAX package,
    where BoxeR-3D's and DETR's `from_config` reject it."""
    cls = MODEL_REGISTRY.get(config.get("type"))
    if "seq_shard" not in inspect.signature(cls.from_config).parameters:
        raise ValueError(f"{config.get('type')} has no sequence "
                         "parallelism (distributed.sp > 1): only boxer2d "
                         "shards its encoder tokens")


def build_model(config, num_classes: int, seq_shard: bool = False):
    """config: the per-model config node (e.g. config.model_config.boxer2d).
    `seq_shard` goes only to a model that takes it (`check_seq_shard`)."""
    kwargs = {"seq_shard": True} if seq_shard else {}
    return MODEL_REGISTRY.get(config.get("type")).from_config(
        config, num_classes, **kwargs)


# populate registry
from boxer_tpu_torch.models.boxer2d import BoxeR2D  # noqa: E402,F401
from boxer_tpu_torch.models.boxer3d import BoxeR3D  # noqa: E402,F401
from boxer_tpu_torch.models.detr import DETR  # noqa: E402,F401
