"""The port's layers; the names the JAX package's `boxer_tpu/nn/__init__.py`
exports, each its port counterpart (`PallasMultiHeadAttention`: the dense
attention that runs the flash kernel K3). A name is imported from its
module at first use, so importing this package builds no kernel and
imports no layer module."""

import importlib

_MODULES = {
    "BoxAttention": "attention",
    "Box3dAttention": "attention",
    "InstanceAttention": "attention",
    "BoxTransformer": "box_transformer",
    "MLP": "predictor",
    "Detector": "predictor",
    "Detector3d": "predictor",
    "MultiDetector3d": "predictor",
    "SegmentMLP": "predictor",
    "BackBone": "resnet",
    "build_resnet": "resnet",
    "Box3dTransformer": "box3d_transformer",
    "Transformer": "transformer",
    "PallasMultiHeadAttention": "dense_attention",
    "HungarianMatcher": "matcher",
    "HungarianMatcher3d": "matcher",
    "build_matcher": "matcher",
    "hungarian": "matcher",
    "Backbone3d": "backbone3d",
    "build_backbone3d": "backbone3d",
    "PillarFeatureNet": "point_pillar",
    "PointPillarsScatter": "point_pillar",
}

__all__ = list(_MODULES)


def __getattr__(name):
    if name not in _MODULES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_MODULES[name]}"),
                   name)
