"""COCO detection / instance segmentation task; copy of
`boxer_tpu/dataset/coco.py` (numpy and PIL on the host).

Parity targets: reference `e2edet/dataset/coco.py` — COCODetection task,
ConvertCocoPolysToMask (:271-356), format_for_evalai top-100 postprocessing
(:112-268), prepare_for_evaluation COCO json records (:72-109); and
`dataset/helper/collate_fn.py:66-112` (pad-to-max batch + bool mask).

Differences from the reference, as in the JAX package:
- fixed-shape batches: images padded to a *fixed* canvas (default 1344²,
  config `canvas_size`) instead of per-batch max;
- targets padded to `max_boxes` with a validity mask;
- the 28×28 GT instance-mask crops the reference extracts on-GPU per step
  (`losses.py:509-519`) are precomputed here on the host;
- category ids remapped to contiguous labels (inverse map used at eval).
"""

import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from boxer_tpu_torch.dataset.helper.coco_api import COCO
from boxer_tpu_torch.dataset.processor.processors import build_processor
from boxer_tpu_torch.utils.registry import TASK_REGISTRY


def register_task(name):
    return TASK_REGISTRY.register(name)


def _bilinear_sample_np(img: np.ndarray, x: np.ndarray, y: np.ndarray):
    """Zero-padded bilinear sample; img (H, W), x/y pixel coords arrays."""
    h, w = img.shape
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    lx = (x - x0).astype(np.float32)
    ly = (y - y0).astype(np.float32)

    def tap(xi, yi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        v = img[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]
        return np.where(valid, v, 0.0)

    return (tap(x0, y0) * (1 - lx) * (1 - ly)
            + tap(x0 + 1, y0) * lx * (1 - ly)
            + tap(x0, y0 + 1) * (1 - lx) * ly
            + tap(x0 + 1, y0 + 1) * lx * ly)


def extract_instance_masks_np(masks: np.ndarray, boxes_cxcywh: np.ndarray,
                              image_size: Tuple[int, int],
                              mask_size: int = 28) -> np.ndarray:
    """Host-side equivalent of reference `extract_grid` on GT masks
    (`losses.py:509-519` + `general.py:165-220`, align_corners=False):
    sample a mask_size² grid inside each (normalized cxcywh) box and
    binarize at 0.5.

    masks: (N, H, W) bool at padded-image scale; boxes normalized to
    image_size (h, w). Returns (N, mask_size, mask_size) float32.
    """
    n = len(boxes_cxcywh)
    h, w = image_size
    out = np.zeros((n, mask_size, mask_size), np.float32)
    if n == 0:
        return out
    idx = (0.5 + np.arange(mask_size, dtype=np.float32)) / mask_size
    gy, gx = np.meshgrid(idx, idx, indexing="ij")
    for i in range(n):
        cx, cy, bw, bh = boxes_cxcywh[i]
        x1, y1 = (cx - bw / 2) * w, (cy - bh / 2) * h
        x2, y2 = (cx + bw / 2) * w, (cy + bh / 2) * h
        xs = gx * (x2 - x1) + x1 - 0.5
        ys = gy * (y2 - y1) + y1 - 0.5
        sampled = _bilinear_sample_np(masks[i].astype(np.float32), xs, ys)
        out[i] = (sampled >= 0.5).astype(np.float32)
    return out


class ConvertCocoPolysToMask:
    """Annotation -> target dict; parity reference `coco.py:271-356`."""

    def __init__(self, return_masks: bool = False, cat_id_to_label=None):
        self.return_masks = return_masks
        self.cat_id_to_label = cat_id_to_label or {}

    def __call__(self, image, target, coco: COCO):
        w, h = image.size
        anno = [a for a in target["annotations"] if a.get("iscrowd", 0) == 0]

        boxes = np.asarray([a["bbox"] for a in anno],
                           np.float32).reshape(-1, 4)
        boxes[:, 2:] += boxes[:, :2]
        boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, w)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, h)

        classes = np.asarray(
            [self.cat_id_to_label.get(a["category_id"], a["category_id"])
             for a in anno], np.int64)

        masks = None
        if self.return_masks:
            masks = (np.stack([coco.ann_to_mask(a, h, w) for a in anno])
                     if anno else np.zeros((0, h, w), bool))

        keep = (boxes[:, 3] > boxes[:, 1]) & (boxes[:, 2] > boxes[:, 0])
        out = {
            "boxes": boxes[keep],
            "labels": classes[keep],
            "image_id": target["image_id"],
            "area": np.asarray([a["area"] for a in anno], np.float32)[keep],
            "iscrowd": np.zeros(int(keep.sum()), np.int64),
            "orig_size": np.array([h, w]),
            "size": np.array([h, w]),
        }
        if masks is not None:
            out["masks"] = masks[keep]
        return image, out


@register_task("detection")
class COCODetection:
    """COCO task: indexing, processing, fixed-shape collate, eval formatting."""

    def __init__(self, config, dataset_type: str, imdb_file: Dict,
                 data_root: Optional[str] = None):
        self.config = config
        self.dataset_type = dataset_type
        self.use_mask = bool(config.get("use_mask", False))
        self.max_boxes = int(config.get("max_boxes", 100))
        canvas = config.get("canvas_size", [1344, 1344])
        self.canvas = (int(canvas[0]), int(canvas[1]))
        self.mask_size = int(config.get("mask_size", 28))

        root = data_root or os.environ.get("E2E_DATASETS", ".")
        self.image_folder = self._abs(root, imdb_file["image_folder"])
        anno_file = self._abs(root, imdb_file["anno_file"])
        self.coco = COCO(anno_file)
        self.ids = self.coco.get_img_ids()

        # contiguous label mapping
        cats = sorted(self.coco.cats.values(), key=lambda c: c["id"])
        self.cat_id_to_label = {c["id"]: i for i, c in enumerate(cats)}
        self.label_to_cat_id = {i: c["id"] for i, c in enumerate(cats)}
        self.class_names = [c["name"] for c in cats]

        self.prepare = ConvertCocoPolysToMask(self.use_mask,
                                              self.cat_id_to_label)
        # cache_mode: the decoded RGB images kept in RAM by image id
        # (reference CocoDetection cache_mode, `helper/coco_detection.py:
        # 41-71`; build_dataloader pairs it with ShardDistributedSampler,
        # so each rank holds its own shard); the loader's worker threads
        # share it, so it is read and filled under a lock (two threads that
        # miss on one image both decode it)
        self.cache_mode = bool(config.get("cache_mode", False))
        self._image_cache = {} if self.cache_mode else None
        self._cache_lock = threading.Lock()
        procs = config.get("processors", {})
        key = ("image_train_processor" if dataset_type == "train"
               else "image_test_processor")
        self.processor = (build_processor(procs[key]) if key in procs else None)

    @staticmethod
    def _abs(root, p):
        return p if os.path.isabs(p) else os.path.join(root, p)

    def get_answer_size(self) -> int:
        return len(self.class_names)

    def __len__(self):
        return len(self.ids)

    def load(self, idx: int, rng: np.random.RandomState):
        """Returns (sample, target) after augmentation; numpy image HWC."""
        image_id = self.ids[idx]
        info = self.coco.load_img(image_id)
        path = os.path.join(self.image_folder, info["file_name"])
        img = self._cached_image(image_id)
        if img is None:
            img = Image.open(path).convert("RGB")
            if self._image_cache is not None:
                with self._cache_lock:
                    self._image_cache[image_id] = img.copy()

        if self.dataset_type == "test":
            target = {"image_id": image_id, "annotations": []}
        else:
            target = {"image_id": image_id,
                      "annotations": self.coco.load_anns_for_img(image_id)}
        img, target = self.prepare(img, target, self.coco)

        sample = {"image": img}
        if self.processor is not None:
            sample, target = self.processor(sample, target, rng)
        return sample, target

    def _cached_image(self, image_id):
        """A copy of the cached image (an augmentation may write into what
        a load returns), or None."""
        if self._image_cache is None:
            return None
        with self._cache_lock:
            img = self._image_cache.get(image_id)
        return None if img is None else img.copy()

    # ------------------------------------------------------------------
    # Fixed-shape collate (parity: `collate_fn.py:66-112`, a fixed canvas)
    # ------------------------------------------------------------------

    def collate(self, items: List[Tuple[Dict, Dict]]):
        b = len(items)
        ch, cw = self.canvas
        nt = self.max_boxes

        image = np.zeros((b, ch, cw, 3), np.float32)
        mask = np.ones((b, ch, cw), bool)
        labels = np.zeros((b, nt), np.int32)
        boxes = np.zeros((b, nt, 4), np.float32)
        valid = np.zeros((b, nt), bool)
        inst_masks = (np.zeros((b, nt, self.mask_size, self.mask_size),
                               np.float32) if self.use_mask else None)
        metas = []

        for i, (sample, target) in enumerate(items):
            img = sample["image"]
            h, w = img.shape[:2]
            assert h <= ch and w <= cw, f"image {h}x{w} exceeds canvas {ch}x{cw}"
            image[i, :h, :w] = img
            mask[i, :h, :w] = False

            n = min(len(target.get("labels", [])), nt)
            if n > 0:
                # boxes were normalized to the *unpadded* image size by the
                # normalize processor; renormalize to the canvas so masks and
                # valid-ratio logic line up.
                bx = target["boxes"][:n].astype(np.float32)
                scale = np.array([w / cw, h / ch, w / cw, h / ch], np.float32)
                boxes[i, :n] = bx * scale
                labels[i, :n] = target["labels"][:n]
                valid[i, :n] = True
                if self.use_mask and "masks" in target:
                    m = target["masks"][:n]
                    padded = np.zeros((n, ch, cw), bool)
                    mh = min(m.shape[1], ch)
                    mw = min(m.shape[2], cw)
                    padded[:, :mh, :mw] = m[:, :mh, :mw]
                    inst_masks[i, :n] = extract_instance_masks_np(
                        padded, boxes[i, :n], (ch, cw), self.mask_size)
            metas.append({
                "image_id": int(np.asarray(target["image_id"]).reshape(-1)[0]),
                "orig_size": np.asarray(target["orig_size"]),
                "size": np.asarray(target.get("size", (h, w))),
            })

        targets = {"labels": labels, "boxes": boxes, "valid": valid}
        if inst_masks is not None:
            targets["instance_masks"] = inst_masks
        return {"image": image, "mask": mask, "targets": targets,
                "meta": metas}

    # ------------------------------------------------------------------
    # Evaluation formatting (parity: `coco.py:112-268`)
    # ------------------------------------------------------------------

    def format_for_evalai(self, output: Dict[str, np.ndarray],
                          metas: List[Dict], topk: int = 100,
                          threshold: float = None,
                          return_rles: bool = False):
        """output: numpy {pred_logits (B,NQ,C), pred_boxes (B,NQ,4)
        [, pred_masks (B,NQ,s,s)]}; metas from collate. Returns
        {image_id: {scores, labels, boxes(xyxy abs), [masks|rles]}}.

        threshold mode (reference `coco.py:209-261`): keep every
        (query, class) above `threshold` instead of a fixed top-k."""
        logits = np.asarray(output["pred_logits"], np.float32)
        bboxes = np.asarray(output["pred_boxes"], np.float32)
        b, nq, c = logits.shape
        prob = 1.0 / (1.0 + np.exp(-logits))
        flat = prob.reshape(b, -1)

        results = {}
        for i in range(b):
            if threshold is not None:
                top_idx = np.flatnonzero(flat[i] > threshold)
            else:
                k = min(topk, flat.shape[1])
                top_idx = np.argpartition(-flat[i], k - 1)[:k]
            scores = flat[i][top_idx]
            q_idx = top_idx // c
            labels = top_idx % c

            oh, ow = [int(v) for v in metas[i]["orig_size"]]
            bx = bboxes[i][q_idx]
            xy = np.concatenate(
                [bx[:, :2] - bx[:, 2:] / 2, bx[:, :2] + bx[:, 2:] / 2], -1)
            # boxes are normalized to the padded canvas; orig_size scaling must
            # account for the valid-image fraction of the canvas.
            sh, sw = [int(v) for v in metas[i]["size"]]
            ch, cw = self.canvas
            fx = cw / sw * ow
            fy = ch / sh * oh
            xy = xy * np.array([fx, fy, fx, fy], np.float32)

            res = {"scores": scores, "labels": labels, "boxes": xy}

            if "pred_masks" in output and output["pred_masks"] is not None:
                masks_logits = np.asarray(output["pred_masks"][i], np.float32)
                m = 1.0 / (1.0 + np.exp(-masks_logits[q_idx]))
                pasted = _paste_masks_np(m, xy, (oh, ow))
                binary = pasted >= 0.5
                denom = np.maximum(binary.sum((-1, -2)), 1)
                mask_scores = (pasted * binary).sum((-1, -2)) / denom
                res["scores"] = scores * mask_scores
                if return_rles:
                    from boxer_tpu_torch.utils.rle import encode_mask

                    res["rles"] = [encode_mask(bm) for bm in binary]
                else:
                    res["masks"] = binary
            results[metas[i]["image_id"]] = res
        return results

    def prepare_for_evaluation(self, predictions: Dict) -> List[Dict]:
        """-> COCO result json records (parity `coco.py:72-109`). A pick of
        DETR's no-object column is left out: the JAX package raises
        KeyError on it (`ROADMAP.md` section 3)."""
        records = []
        for image_id, pred in predictions.items():
            boxes = pred["boxes"]
            xywh = np.concatenate(
                [boxes[:, :2], boxes[:, 2:] - boxes[:, :2]], -1)
            for k in range(len(boxes)):
                label = int(pred["labels"][k])
                if label not in self.label_to_cat_id:
                    # DETR's no-object column (label num_classes), which
                    # the sigmoid top-k can pick, names no category
                    continue
                rec = {
                    "image_id": int(image_id),
                    "category_id": self.label_to_cat_id[label],
                    "bbox": [round(float(v), 3) for v in xywh[k]],
                    "score": float(pred["scores"][k]),
                }
                if "rles" in pred:
                    rec["segmentation"] = pred["rles"][k]
                records.append(rec)
        return records


def _paste_masks_np(masks: np.ndarray, boxes_xyxy: np.ndarray,
                    size: Tuple[int, int]) -> np.ndarray:
    """Host-side `paste_grid` parity (`general.py:223-246`): resample each
    s×s mask into its box region of an (h, w) image."""
    n, s, _ = masks.shape
    h, w = size
    out = np.zeros((n, h, w), np.float32)
    ys = np.arange(h, dtype=np.float32) + 0.5
    xs = np.arange(w, dtype=np.float32) + 0.5
    for i in range(n):
        x1, y1, x2, y2 = boxes_xyxy[i]
        if x2 <= x1 or y2 <= y1:
            continue
        # the bilinear sample is zero wherever the grid coord falls outside
        # (-1, s), i.e. more than half a mask cell beyond the box — so only
        # the box region (padded by one cell) needs computing; everything
        # else stays the zeros above. Typically ~10x less work than the
        # full canvas per mask.
        cw, chh = (x2 - x1) / s, (y2 - y1) / s
        xa = max(0, int(np.floor(x1 - cw)))
        xb = min(w, int(np.ceil(x2 + cw)) + 1)
        ya = max(0, int(np.floor(y1 - chh)))
        yb = min(h, int(np.ceil(y2 + chh)) + 1)
        if xa >= xb or ya >= yb:
            continue
        # map image pixels into mask grid coords (align_corners=False)
        gx = (xs[xa:xb] - x1) / (x2 - x1) * s - 0.5
        gy = (ys[ya:yb] - y1) / (y2 - y1) * s - 0.5
        gxm, gym = np.meshgrid(gx, gy)
        out[i, ya:yb, xa:xb] = _bilinear_sample_np(masks[i], gxm, gym)
    return out
