"""2D augmentation primitives (host-side numpy/PIL); copy of
`boxer_tpu/dataset/processor/transforms_2d.py`.

Parity targets: reference `e2edet/dataset/processor/functional.py` 2D section —
resize shortest-edge semantics (:167-234), crop with box clamp + empty-box
filtering (:45-122), hflip (:125-143), pad bottom-right (:146-164), LSJ
resize_scale (:22-42) + random_crop (:45-74), normalize with box→cxcywh
normalization keeping orig_boxes (:243-257).

Samples are dicts: {"image": PIL.Image | np.ndarray HWC float32}; targets are
dicts of numpy arrays {"boxes" xyxy, "labels", "area", "iscrowd",
["masks" (N,H,W) bool], "size" [h,w], "orig_size", "image_id"}.
"""

from typing import Optional, Tuple

import numpy as np
from PIL import Image


def resize(sample, target, size, max_size=None):
    """size: scalar shortest-edge or (w, h) tuple."""

    img = sample["image"]
    w, h = img.size

    def _with_aspect(size, max_size):
        if max_size is not None:
            min_orig, max_orig = float(min(w, h)), float(max(w, h))
            if max_orig / min_orig * size > max_size:
                size = int(round(max_size * min_orig / max_orig))
        if (w <= h and w == size) or (h <= w and h == size):
            return (h, w)
        if w < h:
            ow = size
            oh = int(size * h / w)
        else:
            oh = size
            ow = int(size * w / h)
        return (oh, ow)

    if isinstance(size, (list, tuple)):
        oh, ow = size[::-1]
    else:
        oh, ow = _with_aspect(size, max_size)

    rescaled = img.resize((ow, oh), Image.BILINEAR)

    if target is None:
        sample = dict(sample)
        sample["image"] = rescaled
        return sample, None

    ratio_w, ratio_h = ow / w, oh / h
    target = dict(target)
    if "boxes" in target:
        target["boxes"] = target["boxes"] * np.array(
            [ratio_w, ratio_h, ratio_w, ratio_h], np.float32)
    if "area" in target:
        target["area"] = target["area"] * (ratio_w * ratio_h)
    target["size"] = np.array([oh, ow])
    if "masks" in target and len(target["masks"]):
        target["masks"] = _resize_masks_nearest(target["masks"], (oh, ow))
    elif "masks" in target:
        target["masks"] = np.zeros((0, oh, ow), bool)

    sample = dict(sample)
    sample["image"] = rescaled
    return sample, target


def _resize_masks_nearest(masks, size):
    """Torch F.interpolate(mode='nearest') parity: src = floor(dst*in/out)."""
    n, h, w = masks.shape
    oh, ow = size
    rows = np.floor(np.arange(oh) * (h / oh)).astype(np.int64)
    cols = np.floor(np.arange(ow) * (w / ow)).astype(np.int64)
    return masks[:, rows][:, :, cols]


def crop(sample, target, region):
    """region: (i, j, h, w) top-left y/x + size. Filters empty boxes
    (reference `functional.py:77-122`)."""
    i, j, h, w = region
    img = sample["image"]
    cropped = img.crop((j, i, j + w, i + h))

    target = dict(target)
    target["size"] = np.array([h, w])
    fields = [f for f in ("labels", "area", "iscrowd") if f in target]

    if "boxes" in target:
        boxes = target["boxes"] - np.array([j, i, j, i], np.float32)
        boxes = np.minimum(
            boxes.reshape(-1, 2, 2), np.array([w, h], np.float32))
        boxes = np.clip(boxes, 0, None)
        target["area"] = (boxes[:, 1] - boxes[:, 0]).prod(axis=1)
        target["boxes"] = boxes.reshape(-1, 4)
        fields.append("boxes")

    if "masks" in target:
        target["masks"] = target["masks"][:, i:i + h, j:j + w]
        fields.append("masks")

    if "boxes" in target or "masks" in target:
        if "boxes" in target:
            b = target["boxes"].reshape(-1, 2, 2)
            keep = (b[:, 1] > b[:, 0]).all(axis=1)
        else:
            keep = target["masks"].reshape(len(target["masks"]), -1).any(axis=1)
        for f in set(fields):
            target[f] = target[f][keep]

    sample = dict(sample)
    sample["image"] = cropped
    return sample, target


def hflip(sample, target):
    img = sample["image"]
    w, h = img.size
    flipped = img.transpose(Image.FLIP_LEFT_RIGHT)

    target = dict(target)
    if "boxes" in target:
        b = target["boxes"]
        target["boxes"] = (
            b[:, [2, 1, 0, 3]] * np.array([-1, 1, -1, 1], np.float32)
            + np.array([w, 0, w, 0], np.float32)
        )
    if "masks" in target:
        target["masks"] = target["masks"][:, :, ::-1]

    sample = dict(sample)
    sample["image"] = flipped
    return sample, target


def pad(sample, target, padding, pad_value=0):
    """padding: (right, bottom); parity `functional.py:146-164`."""
    img = sample["image"]
    w, h = img.size
    padded = Image.new(img.mode, (w + padding[0], h + padding[1]),
                       tuple([pad_value] * len(img.getbands()))
                       if img.mode != "L" else pad_value)
    padded.paste(img, (0, 0))

    sample = dict(sample)
    sample["image"] = padded
    if target is None:
        return sample, None
    target = dict(target)
    target["size"] = np.array([h + padding[1], w + padding[0]])
    if "masks" in target:
        m = target["masks"]
        target["masks"] = np.pad(
            m, ((0, 0), (0, padding[1]), (0, padding[0])))
    return sample, target


def resize_scale(sample, target, scale, target_height, target_width):
    """LSJ scale jitter (reference `functional.py:22-42`)."""
    w, h = sample["image"].size
    out_scale = min(target_height * scale / h, target_width * scale / w)
    oh = int(round(h * out_scale))
    ow = int(round(w * out_scale))
    return resize(sample, target, (ow, oh))


def random_crop(sample, target, crop_size, is_fixed=True, pad_value=0,
                rng: Optional[np.random.RandomState] = None):
    """LSJ fixed/variable crop (reference `functional.py:45-74`)."""
    rng = rng or np.random
    w, h = sample["image"].size
    ow, oh = crop_size

    max_off_y = max(h - oh, 0)
    max_off_x = max(w - ow, 0)
    r = rng.uniform(0.0, 1.0)
    off_y = int(round(max_off_y * r))
    off_x = int(round(max_off_x * r))

    if is_fixed:
        pad_y = max(oh - h, 0)
        pad_x = max(ow - w, 0)
        sample, target = pad(sample, target, (pad_x, pad_y),
                             pad_value=pad_value)
        region = (off_y, off_x, oh, ow)
    else:
        region = (off_y, off_x, min(oh, h), min(ow, w))
    return crop(sample, target, region)


def to_tensor(sample, target):
    """PIL -> float32 HWC in [0,1] (the models take NHWC images)."""
    img = np.asarray(sample["image"], np.float32) / 255.0
    if img.ndim == 2:
        img = img[:, :, None]
    sample = dict(sample)
    sample["image"] = img
    return sample, target


def normalize(sample, target, mean, std):
    """Channel normalize + boxes -> normalized cxcywh, keep orig_boxes
    (reference `functional.py:243-257`)."""
    img = sample["image"]
    img = (img - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    sample = dict(sample)
    sample["image"] = img
    if target is None:
        return sample, None

    target = dict(target)
    h, w = img.shape[:2]
    if "boxes" in target:
        boxes = target["boxes"]
        target["orig_boxes"] = boxes
        cxcywh = np.concatenate(
            [(boxes[:, :2] + boxes[:, 2:]) / 2, boxes[:, 2:] - boxes[:, :2]],
            axis=-1)
        target["boxes"] = cxcywh / np.array([w, h, w, h], np.float32)
    return sample, target
