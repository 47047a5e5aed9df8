"""Model registry and build function; port of
`boxer_tpu/models/__init__.py`.

`build_model` returns the module built from its config node (the
constructors' `from_config` reads the JAX package's config keys); its
weights are filled by the caller.
"""

from boxer_tpu_torch.utils.registry import MODEL_REGISTRY


def register_model(name):
    return MODEL_REGISTRY.register(name)


def build_model(config, num_classes: int):
    """config: the per-model config node (e.g. config.model_config.boxer2d)."""
    return MODEL_REGISTRY.get(config.get("type")).from_config(config,
                                                             num_classes)


# populate registry
from boxer_tpu_torch.models.boxer2d import BoxeR2D  # noqa: E402,F401
from boxer_tpu_torch.models.boxer3d import BoxeR3D  # noqa: E402,F401
from boxer_tpu_torch.models.detr import DETR  # noqa: E402,F401
