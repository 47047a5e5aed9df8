"""The readers; the names the JAX package's
`boxer_tpu/dataset/reader/__init__.py` exports, imported from their
modules at first use (`point_reader` imports the Waymo task)."""

import importlib

_MODULES = {"ImageReader": "image_reader", "PointReader": "point_reader",
            "WaymoReader": "point_reader"}

__all__ = list(_MODULES)


def __getattr__(name):
    if name not in _MODULES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_MODULES[name]}"),
                   name)
