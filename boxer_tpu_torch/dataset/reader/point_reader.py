"""Point-cloud readers; port of `boxer_tpu/dataset/reader/point_reader.py`.

Parity: reference `e2edet/dataset/reader/point_reader.py`
(PointReader/WaymoReader surfaces).
"""

import numpy as np

from boxer_tpu_torch.dataset.waymo import read_lidar_points


class PointReader:
    """Raw .bin float32 point files (kitti-style)."""

    def __init__(self, num_features: int = 4):
        self.num_features = num_features

    def __call__(self, path: str) -> np.ndarray:
        return np.fromfile(path, np.float32).reshape(-1, self.num_features)


class WaymoReader:
    """Per-frame waymo pkl (or synthetic npz) with tanh-normalized intensity."""

    def __call__(self, path: str) -> np.ndarray:
        return read_lidar_points(path)
