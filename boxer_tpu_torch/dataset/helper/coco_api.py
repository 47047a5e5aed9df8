"""Minimal self-contained COCO annotation API (no pycocotools); copy of
`boxer_tpu/dataset/helper/coco_api.py`.

Covers what the framework needs from `pycocotools.coco.COCO`: annotation
index by image, category listing, and polygon/RLE mask materialization
(reference uses pycocotools in `dataset/helper/coco_detection.py` and
`dataset/coco.py:271-356`).
"""

import json
from collections import defaultdict
from typing import Dict, List

import numpy as np
from PIL import Image, ImageDraw

from boxer_tpu_torch.utils.rle import decode_rle


class COCO:
    def __init__(self, annotation_file: str = None, dataset: Dict = None):
        assert annotation_file or dataset
        if dataset is None:
            with open(annotation_file) as f:
                dataset = json.load(f)
        self.dataset = dataset
        self.anns: Dict[int, Dict] = {}
        self.imgs: Dict[int, Dict] = {}
        self.cats: Dict[int, Dict] = {}
        self.img_to_anns = defaultdict(list)
        self._index()

    def _index(self):
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat
        for ann in self.dataset.get("annotations", []):
            self.anns[ann["id"]] = ann
            self.img_to_anns[ann["image_id"]].append(ann)

    def get_img_ids(self) -> List[int]:
        return sorted(self.imgs.keys())

    def get_cat_ids(self) -> List[int]:
        return sorted(self.cats.keys())

    def load_anns_for_img(self, img_id: int) -> List[Dict]:
        return self.img_to_anns.get(img_id, [])

    def load_img(self, img_id: int) -> Dict:
        return self.imgs[img_id]

    def ann_to_mask(self, ann: Dict, h: int, w: int) -> np.ndarray:
        """Segmentation (polygons | RLE) -> binary (h, w) mask."""
        seg = ann["segmentation"]
        if isinstance(seg, list):
            return polygons_to_mask(seg, h, w)
        if isinstance(seg, dict):
            if isinstance(seg["counts"], list):
                from boxer_tpu_torch.utils.rle import rle_counts_to_mask

                return rle_counts_to_mask(seg["counts"], *seg["size"])
            return decode_rle(seg)
        raise ValueError(f"Unsupported segmentation type: {type(seg)}")


def polygons_to_mask(polygons: List[List[float]], h: int, w: int) -> np.ndarray:
    """Rasterize COCO polygons (flat [x0,y0,x1,y1,...] lists) to a binary
    mask. Instances may have multiple polygons; their union is taken
    (parity with reference `convert_coco_poly_to_mask`, coco.py:340-356)."""
    mask = Image.new("1", (w, h), 0)
    draw = ImageDraw.Draw(mask)
    for poly in polygons:
        if len(poly) < 6:
            continue
        draw.polygon([float(v) for v in poly], outline=1, fill=1)
    return np.asarray(mask, bool)
