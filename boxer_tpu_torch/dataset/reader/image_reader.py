"""Image readers; copy of `boxer_tpu/dataset/reader/image_reader.py`.

Parity: reference `e2edet/dataset/reader/image_reader.py` (pil/cv2 backends).
"""

import numpy as np
from PIL import Image


class ImageReader:
    def __init__(self, backend: str = "pil"):
        assert backend in ("pil", "cv2")
        self.backend = backend

    def __call__(self, path: str):
        if self.backend == "pil":
            return Image.open(path).convert("RGB")
        import cv2

        img = cv2.imread(path, cv2.IMREAD_COLOR)
        return Image.fromarray(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
