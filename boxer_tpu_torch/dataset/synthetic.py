"""Synthetic training batches; numpy copy of `boxer_tpu/dataset/synthetic.py`
(same seed, same arrays), with the `iter_per_update` split in numpy.

Layout: image (B, H, W, 3) float32, mask (B, H, W) bool (True = padding),
targets {labels (B, NT) int32, boxes (B, NT, 4) normalized cxcywh, valid
(B, NT) bool [, instance_masks (B, NT, 28, 28)]}; with iter_per_update,
every array gets a leading (iter_per_update, B / iter_per_update) split.
"""

from typing import Optional

import numpy as np


def synthetic_batch(
    batch_size: int = 2,
    height: int = 128,
    width: int = 128,
    num_targets: int = 10,
    num_classes: int = 80,
    with_masks: bool = False,
    mask_size: int = 28,
    seed: int = 0,
    iter_per_update: Optional[int] = None,
):
    rng = np.random.RandomState(seed)
    image = rng.randn(batch_size, height, width, 3).astype(np.float32)
    mask = np.zeros((batch_size, height, width), bool)
    # simulate padded right/bottom regions for some samples
    for b in range(batch_size):
        if b % 2 == 1:
            mask[b, :, int(width * 0.75):] = True
            mask[b, int(height * 0.8):, :] = True

    n_valid = rng.randint(1, num_targets + 1, size=batch_size)
    labels = rng.randint(0, num_classes, size=(batch_size, num_targets))
    cxcy = rng.uniform(0.2, 0.8, size=(batch_size, num_targets, 2))
    wh = rng.uniform(0.05, 0.3, size=(batch_size, num_targets, 2))
    boxes = np.concatenate([cxcy, wh], axis=-1).astype(np.float32)
    valid = np.arange(num_targets)[None, :] < n_valid[:, None]

    targets = {"labels": labels.astype(np.int32), "boxes": boxes,
               "valid": valid}
    if with_masks:
        targets["instance_masks"] = (
            rng.rand(batch_size, num_targets, mask_size, mask_size) > 0.5
        ).astype(np.float32)

    batch = {"image": image, "mask": mask, "targets": targets}
    if iter_per_update is not None:
        assert batch_size % iter_per_update == 0
        mb = batch_size // iter_per_update

        def split(x):
            return x.reshape((iter_per_update, mb) + x.shape[1:])

        batch = {"image": split(image), "mask": split(mask),
                 "targets": {k: split(v) for k, v in targets.items()}}
    return batch
