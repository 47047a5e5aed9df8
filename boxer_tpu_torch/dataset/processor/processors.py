"""Composable processor (augmentation) registry; copy of
`boxer_tpu/dataset/processor/processors.py`.

Parity target: reference `e2edet/dataset/processor/processors.py` registry
(:12-53) and the 2D processor set used by the COCO configs: to_tensor,
normalize, random_resize, random_size_crop (+v2), fixed_size_crop,
random_horizontal_flip, random_select, resize_scale (LSJ), compose; and
the 3D set of the Waymo configs: random_flip, global_rotate, global_scale,
global_translate, filter_by_range, shuffle_points, voxelize, normalize3d,
double_flip, np_to_tensor.

Each processor is `p(sample, target, rng) -> (sample, target)` with a
per-call numpy RandomState for reproducibility.
"""

from typing import Any, Dict, List

import numpy as np

from boxer_tpu_torch.dataset.processor import transforms_2d as T
from boxer_tpu_torch.dataset.processor import transforms_3d as T3
from boxer_tpu_torch.dataset.processor.voxelizer import points_to_voxel
from boxer_tpu_torch.utils.registry import PROCESSOR_REGISTRY


def register_processor(name):
    return PROCESSOR_REGISTRY.register(name)


def build_processor(config) -> "BaseProcessor":
    return PROCESSOR_REGISTRY.get(config["type"])(config.get("params") or {})


class BaseProcessor:
    def __init__(self, params: Dict[str, Any]):
        self.params = dict(params or {})

    def __call__(self, sample, target, rng: np.random.RandomState):
        raise NotImplementedError


@register_processor("compose")
class Compose(BaseProcessor):
    def __init__(self, params):
        super().__init__(params)
        self.procs = [build_processor(p) for p in params["preprocessors"]]

    def __call__(self, sample, target, rng):
        for p in self.procs:
            sample, target = p(sample, target, rng)
        return sample, target


@register_processor("random_select")
class RandomSelect(BaseProcessor):
    """Choose one of the sub-processors with given probs
    (reference usage: `base_boxer2d_detection.yaml:24-60`)."""

    def __init__(self, params):
        super().__init__(params)
        self.procs = [build_processor(p) for p in params["preprocessors"]]
        self.probs = params.get("probs") or [1.0 / len(self.procs)] * len(self.procs)

    def __call__(self, sample, target, rng):
        i = rng.choice(len(self.procs), p=np.asarray(self.probs) / sum(self.probs))
        return self.procs[i](sample, target, rng)


@register_processor("random_horizontal_flip")
class RandomHorizontalFlip(BaseProcessor):
    def __call__(self, sample, target, rng):
        if rng.rand() < self.params.get("prob", 0.5):
            return T.hflip(sample, target)
        return sample, target


@register_processor("random_resize")
class RandomResize(BaseProcessor):
    """min_size: scalar | [start, stop, step] range | explicit list;
    shortest-edge resize with max_size cap."""

    def __init__(self, params):
        super().__init__(params)
        ms = params["min_size"]
        if isinstance(ms, (list, tuple)) and len(ms) == 3 and ms[1] > ms[0]:
            self.sizes = list(range(int(ms[0]), int(ms[1]), int(ms[2])))
        elif isinstance(ms, (list, tuple)):
            self.sizes = [int(s) for s in ms]
        else:
            self.sizes = [int(ms)]
        self.max_size = params.get("max_size")

    def __call__(self, sample, target, rng):
        size = self.sizes[rng.randint(len(self.sizes))]
        return T.resize(sample, target, size, self.max_size)


@register_processor("random_size_crop")
class RandomSizeCrop(BaseProcessor):
    """Random crop with side lengths in [min_size, max_size]."""

    def __call__(self, sample, target, rng):
        w, h = sample["image"].size
        min_size = self.params["min_size"]
        max_size = self.params["max_size"]
        cw = rng.randint(min_size, min(w, max_size) + 1) if w > min_size else w
        ch = rng.randint(min_size, min(h, max_size) + 1) if h > min_size else h
        i = rng.randint(0, h - ch + 1)
        j = rng.randint(0, w - cw + 1)
        return T.crop(sample, target, (i, j, ch, cw))


@register_processor("resize_scale")
class ResizeScale(BaseProcessor):
    """LSJ scale jitter: uniform scale in [min_scale, max_scale] of a fixed
    target canvas (reference `functional.py:22-42`)."""

    def __call__(self, sample, target, rng):
        scale = rng.uniform(self.params["min_scale"], self.params["max_scale"])
        return T.resize_scale(
            sample, target, scale,
            self.params["target_height"], self.params["target_width"])


@register_processor("fixed_size_crop")
class FixedSizeCrop(BaseProcessor):
    def __call__(self, sample, target, rng):
        size = (self.params["crop_width"], self.params["crop_height"])
        return T.random_crop(sample, target, size, is_fixed=True,
                             pad_value=self.params.get("pad_value", 0), rng=rng)


@register_processor("random_size_crop_v2")
class RandomSizeCropV2(BaseProcessor):
    def __call__(self, sample, target, rng):
        size = (self.params["crop_width"], self.params["crop_height"])
        return T.random_crop(sample, target, size, is_fixed=False, rng=rng)


@register_processor("to_tensor")
class ToTensor(BaseProcessor):
    def __call__(self, sample, target, rng):
        return T.to_tensor(sample, target)


@register_processor("normalize")
class Normalize(BaseProcessor):
    def __call__(self, sample, target, rng):
        return T.normalize(sample, target, self.params["mean"],
                           self.params["std"])


@register_processor("answer")
class AnswerProcessor(BaseProcessor):
    """Category vocabulary: maps raw COCO category ids to contiguous labels.

    The reference reads a class file (`base.py:50-67` + answer processor).
    Here the vocabulary can also be built directly from the annotation file's
    categories section (set by the dataset)."""

    def __init__(self, params):
        super().__init__(params)
        self.classes: List[str] = []
        self.cat_id_to_label: Dict[int, int] = {}
        class_file = params.get("class_file")
        if class_file:
            import os

            if os.path.exists(class_file):
                with open(class_file) as f:
                    self.classes = [l.strip() for l in f if l.strip()]

    def set_categories(self, categories):
        """categories: list of {"id", "name"} dicts from COCO json."""
        cats = sorted(categories, key=lambda c: c["id"])
        self.classes = [c["name"] for c in cats]
        self.cat_id_to_label = {c["id"]: i for i, c in enumerate(cats)}
        self.label_to_cat_id = {i: c["id"] for i, c in enumerate(cats)}

    def get_size(self) -> int:
        return len(self.classes)

    def __call__(self, sample, target, rng):
        return sample, target


# =========================== #
# --------- 3d ops ---------- #
# =========================== #


@register_processor("random_flip")
class RandomFlip3D(BaseProcessor):
    def __call__(self, sample, target, rng):
        return T3.random_flip(sample, target, rng,
                              self.params.get("prob", 0.5))


@register_processor("global_rotate")
class GlobalRotate(BaseProcessor):
    def __call__(self, sample, target, rng):
        return T3.global_rotation(sample, target, rng,
                                  self.params["rotation"])


@register_processor("global_scale")
class GlobalScale(BaseProcessor):
    def __call__(self, sample, target, rng):
        return T3.global_scaling(sample, target, rng,
                                 self.params["min_scale"],
                                 self.params["max_scale"])


@register_processor("global_translate")
class GlobalTranslate(BaseProcessor):
    def __call__(self, sample, target, rng):
        return T3.global_translate(sample, target, rng,
                                   self.params.get("noise_std", 0.0))


@register_processor("filter_by_range")
class FilterByRange(BaseProcessor):
    def __call__(self, sample, target, rng):
        return T3.filter_by_pc_range(sample, target, self.params["pc_range"])


@register_processor("shuffle_points")
class ShufflePoints(BaseProcessor):
    def __call__(self, sample, target, rng):
        return T3.shuffle_points(sample, target, rng)


@register_processor("voxelize")
class Voxelize(BaseProcessor):
    def __call__(self, sample, target, rng):
        voxels, coords, num_points = points_to_voxel(
            sample["points"],
            self.params["voxel_size"],
            self.params["pc_range"],
            max_points=self.params.get("max_points_per_voxel", 20),
            reverse=True,
            max_voxels=self.params.get("max_voxel_num", 32000),
        )
        sample = dict(sample)
        sample.update({
            "voxels": voxels,
            "coordinates": coords,
            "num_points_per_voxel": num_points,
        })
        return sample, target


@register_processor("normalize3d")
class Normalize3D(BaseProcessor):
    def __call__(self, sample, target, rng):
        return T3.normalize3d(sample, target, self.params["pc_range"],
                              self.params.get("normalize_angle", "sigmoid"))


@register_processor("double_flip")
class DoubleFlip(BaseProcessor):
    def __call__(self, sample, target, rng):
        return T3.double_flip(sample, target)


@register_processor("np_to_tensor")
class NpToTensor(BaseProcessor):
    """No-op: the arrays stay numpy until the loader makes tensors of the
    collated batch; kept for the config surface (reference
    `functional.py:459-463`)."""

    def __call__(self, sample, target, rng):
        return sample, target
