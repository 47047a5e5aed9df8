"""Self-contained COCO mAP evaluator (numpy); copy of
`boxer_tpu/evaluate/coco_eval.py`.

Re-implements the `pycocotools.cocoeval.COCOeval` algorithm used by the
reference's `CocoEvaluator` (`e2edet/evaluate/coco_eval.py`): greedy
score-ordered matching per (image, category) at IoU thresholds 0.5:0.05:0.95,
crowd/ignore semantics, 101-point interpolated precision, and the standard
12-metric summary. Validated against the published definition via unit tests
(tests/test_coco_eval.py) with hand-checkable fixtures.

Distributed eval merge (reference `coco_eval.py:62-67,175-205` gathers
evalImgs over gloo): each process evaluates its shard's predictions and
`merge_gathered_results` merges the gathered shards. At one process
`CocoEvaluator.synchronize_between_processes` has nothing to gather;
gathering through torch.distributed comes with data parallelism.
"""

from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
MAX_DETS = (1, 10, 100)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
# keypoint evaluation uses maxDets=20 and no "small" range (pycocotools
# Params(iouType='keypoints'); reference passes iou_type through,
# `e2edet/evaluate/coco_eval.py:83,155-166`)
KP_MAX_DETS = (20,)
KP_AREA_RNG = {
    "all": (0.0, 1e10),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
# per-keypoint OKS falloff constants (pycocotools computeOks)
KP_SIGMAS = np.array([
    .26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62,
    1.07, 1.07, .87, .87, .89, .89]) / 10.0


def box_iou_xywh(dt: np.ndarray, gt: np.ndarray,
                 iscrowd: np.ndarray) -> np.ndarray:
    """Pairwise IoU of xywh boxes with crowd semantics (crowd gt: union =
    area(dt)); matches pycocotools `maskUtils.iou` for bbox."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]

    ix = (np.minimum(dx2[:, None], gx2[None]) -
          np.maximum(dx1[:, None], gx1[None])).clip(0)
    iy = (np.minimum(dy2[:, None], gy2[None]) -
          np.maximum(dy1[:, None], gy1[None])).clip(0)
    inter = ix * iy
    d_area = (dt[:, 2] * dt[:, 3])[:, None]
    g_area = (gt[:, 2] * gt[:, 3])[None]
    union = np.where(iscrowd[None].astype(bool), d_area,
                     d_area + g_area - inter)
    return inter / np.maximum(union, 1e-9)


def oks_matrix(dt_kps: np.ndarray, gt: List[Dict]) -> np.ndarray:
    """Pairwise object-keypoint-similarity (pycocotools computeOks).

    dt_kps: (D, K, 3) detection keypoints (x, y, score); gt: COCO keypoint
    annotations with 'keypoints' (flat 3K), 'bbox' xywh, 'area'. For gts with
    no labeled keypoint, distances are measured to the 2×-expanded gt box.
    """
    D, G = len(dt_kps), len(gt)
    if D == 0 or G == 0:
        return np.zeros((D, G))
    variances = (2 * KP_SIGMAS) ** 2
    ious = np.zeros((D, G))
    for j, g in enumerate(gt):
        gkp = np.asarray(g["keypoints"], np.float64).reshape(-1, 3)
        xg, yg, vg = gkp[:, 0], gkp[:, 1], gkp[:, 2]
        k1 = int((vg > 0).sum())
        bb = g["bbox"]
        x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
        y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
        for i in range(D):
            xd, yd = dt_kps[i, :, 0], dt_kps[i, :, 1]
            if k1 > 0:
                dx, dy = xd - xg, yd - yg
            else:
                dx = np.maximum(0, x0 - xd) + np.maximum(0, xd - x1)
                dy = np.maximum(0, y0 - yd) + np.maximum(0, yd - y1)
            e = (dx ** 2 + dy ** 2) / variances / (
                g.get("area", bb[2] * bb[3]) + np.spacing(1)) / 2
            if k1 > 0:
                e = e[vg > 0]
            ious[i, j] = np.exp(-e).sum() / e.shape[0]
    return ious


class COCOEval:
    """Evaluate detection results against a `coco_api.COCO` ground truth.

    results: list of COCO result records {image_id, category_id, bbox xywh,
    score [, segmentation rle | keypoints flat-3K]};
    iou_type: "bbox" | "segm" | "keypoints".
    """

    def __init__(self, coco_gt, iou_type: str = "bbox",
                 img_ids: Optional[List[int]] = None):
        assert iou_type in ("bbox", "segm", "keypoints")
        self.coco_gt = coco_gt
        self.iou_type = iou_type
        self.max_dets = KP_MAX_DETS if iou_type == "keypoints" else MAX_DETS
        self.area_rng = KP_AREA_RNG if iou_type == "keypoints" else AREA_RNG
        self.img_ids = sorted(img_ids or coco_gt.get_img_ids())
        self.cat_ids = coco_gt.get_cat_ids()
        self.eval_imgs: Dict = {}
        self.stats: Optional[np.ndarray] = None

        self._gts = defaultdict(list)
        for img_id in self.img_ids:
            for ann in coco_gt.load_anns_for_img(img_id):
                self._gts[(img_id, ann["category_id"])].append(ann)

    def evaluate(self, results: List[Dict]):
        dts = defaultdict(list)
        for r in results:
            dts[(r["image_id"], r["category_id"])].append(r)

        self.eval_imgs = {}
        for img_id in self.img_ids:
            for cat_id in self.cat_ids:
                gt = self._gts.get((img_id, cat_id), [])
                dt = dts.get((img_id, cat_id), [])
                if not gt and not dt:
                    continue
                self.eval_imgs[(img_id, cat_id)] = self._evaluate_img(
                    img_id, gt, dt)

    def _ious(self, dt, gt):
        if self.iou_type == "bbox":
            d = np.asarray([x["bbox"] for x in dt], np.float64).reshape(-1, 4)
            g = np.asarray([x["bbox"] for x in gt], np.float64).reshape(-1, 4)
            crowd = np.asarray([x.get("iscrowd", 0) for x in gt])
            return box_iou_xywh(d, g, crowd)
        if self.iou_type == "keypoints":
            d = np.asarray([x["keypoints"] for x in dt],
                           np.float64).reshape(len(dt), -1, 3)
            return oks_matrix(d, gt)
        from boxer_tpu_torch.utils.rle import rle_iou_matrix

        d = [x["segmentation"] for x in dt]
        g = []
        for x in gt:
            seg = x["segmentation"]
            if isinstance(seg, dict):
                g.append(seg)
            else:
                img = self.coco_gt.load_img(x["image_id"])
                from boxer_tpu_torch.dataset.helper.coco_api import polygons_to_mask
                from boxer_tpu_torch.utils.rle import encode_mask

                g.append(encode_mask(polygons_to_mask(
                    seg, img["height"], img["width"])))
        crowd = [bool(x.get("iscrowd", 0)) for x in gt]
        return rle_iou_matrix(d, g, crowd)

    def _evaluate_img(self, img_id, gt, dt):
        """Greedy matching for all iouThrs/areas at maxDet=100; returns the
        per-image eval record (mirrors pycocotools evaluateImg)."""
        max_det = max(self.max_dets)
        dt = sorted(dt, key=lambda x: -x["score"])[:max_det]

        g_area = np.asarray([g.get("area", g["bbox"][2] * g["bbox"][3])
                             for g in gt], np.float64)
        g_crowd = np.asarray([g.get("iscrowd", 0) for g in gt], bool)
        # pycocotools _prepare: explicit gt['ignore'], plus — for keypoints —
        # annotations with no labeled keypoint are ignored entirely
        g_base_ignore = np.asarray([bool(g.get("ignore", 0)) for g in gt],
                                   bool)
        if self.iou_type == "keypoints":
            nkp = [g.get("num_keypoints",
                         int((np.asarray(g["keypoints"],
                                         np.float64)[2::3] > 0).sum()))
                   for g in gt]
            g_base_ignore |= np.asarray(nkp, np.int64) == 0

        # order gts: non-ignore first per area range is handled by sort key
        ious_full = self._ious(dt, gt)  # (D, G)

        T = len(IOU_THRS)
        D = len(dt)
        G = len(gt)
        d_scores = np.asarray([d["score"] for d in dt])
        if self.iou_type == "segm":
            from boxer_tpu_torch.utils.rle import rle_area

            d_area = np.asarray(
                [rle_area(d["segmentation"]) for d in dt], np.float64)
        elif self.iou_type == "keypoints":
            # detection area = keypoint-extent box area; pycocotools
            # COCO.loadRes OVERWRITES any provided bbox area for keypoint
            # results, so the extent (incl. unlabeled (0,0) points) is
            # authoritative
            d_area = np.empty(D, np.float64)
            for i, d in enumerate(dt):
                kp = np.asarray(d["keypoints"], np.float64).reshape(-1, 3)
                d_area[i] = ((kp[:, 0].max() - kp[:, 0].min())
                             * (kp[:, 1].max() - kp[:, 1].min()))
        else:
            d_area = np.asarray([d["bbox"][2] * d["bbox"][3] for d in dt],
                                np.float64)

        record = {"img_id": img_id, "scores": d_scores, "areas": {}}
        for area_name, (a0, a1) in self.area_rng.items():
            g_ignore = (g_crowd | g_base_ignore
                        | (g_area < a0) | (g_area > a1))
            # sort gts: non-ignored first (pycocotools gtind ordering)
            g_order = np.argsort(g_ignore, kind="stable")
            ious = ious_full[:, g_order] if G else ious_full
            gi = g_ignore[g_order]

            dtm = np.full((T, D), -1, np.int64)
            gtm = np.full((T, G), -1, np.int64)
            dt_ignore = np.zeros((T, D), bool)

            for t, thr in enumerate(IOU_THRS):
                for d in range(D):
                    best = -1
                    iou = min(thr, 1 - 1e-10)
                    for g in range(G):
                        if gtm[t, g] >= 0 and not g_crowd[g_order[g]]:
                            continue
                        # stop at ignored gts if a non-ignored match found
                        if best > -1 and not gi[best] and gi[g]:
                            break
                        if ious[d, g] < iou:
                            continue
                        iou = ious[d, g]
                        best = g
                    if best == -1:
                        continue
                    dt_ignore[t, d] = gi[best]
                    dtm[t, d] = g_order[best]
                    gtm[t, best] = d

            # unmatched dts outside the area range are ignored
            out_of_range = (d_area < a0) | (d_area > a1)
            dt_ignore = dt_ignore | ((dtm == -1) & out_of_range[None])

            record["areas"][area_name] = {
                "dtm": dtm,
                "dt_ignore": dt_ignore,
                "num_gt": int((~gi).sum()),
            }
        return record

    def accumulate(self):
        """precision (T, R, K, A, M) and recall (T, K, A, M)."""
        T, R = len(IOU_THRS), len(REC_THRS)
        K, A, M = len(self.cat_ids), len(self.area_rng), len(self.max_dets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))

        for k, cat_id in enumerate(self.cat_ids):
            recs = [self.eval_imgs[(i, cat_id)] for i in self.img_ids
                    if (i, cat_id) in self.eval_imgs]
            if not recs:
                continue
            for a, area_name in enumerate(self.area_rng):
                num_gt = sum(r["areas"][area_name]["num_gt"] for r in recs)
                for m, max_det in enumerate(self.max_dets):
                    scores = np.concatenate(
                        [r["scores"][:max_det] for r in recs])
                    order = np.argsort(-scores, kind="mergesort")
                    dtm = np.concatenate(
                        [r["areas"][area_name]["dtm"][:, :max_det]
                         for r in recs], axis=1)[:, order]
                    dti = np.concatenate(
                        [r["areas"][area_name]["dt_ignore"][:, :max_det]
                         for r in recs], axis=1)[:, order]

                    tps = (dtm >= 0) & ~dti
                    fps = (dtm == -1) & ~dti
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)

                    if num_gt == 0:
                        continue
                    for t in range(T):
                        tp = tp_sum[t]
                        fp = fp_sum[t]
                        rc = tp / num_gt
                        pr = tp / np.maximum(tp + fp, 1e-9)
                        recall[t, k, a, m] = rc[-1] if len(rc) else 0.0

                        # make precision monotonically decreasing
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        q = np.zeros(R)
                        for ri, pi in enumerate(inds):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                        precision[t, :, k, a, m] = q

        self.precision = precision
        self.recall = recall

    def _summarize(self, ap: bool, iou_thr=None, area="all", max_det=100):
        a = list(self.area_rng).index(area)
        m = self.max_dets.index(max_det)
        if ap:
            s = self.precision
            if iou_thr is not None:
                s = s[np.where(np.isclose(IOU_THRS, iou_thr))[0]]
            s = s[:, :, :, a, m]
        else:
            s = self.recall
            if iou_thr is not None:
                s = s[np.where(np.isclose(IOU_THRS, iou_thr))[0]]
            s = s[:, :, a, m]
        valid = s > -1
        return float(s[valid].mean()) if valid.any() else -1.0

    def summarize(self) -> np.ndarray:
        """The standard 12 stats: AP, AP50, AP75, AP-S/M/L, AR@1/10/100,
        AR-S/M/L (keypoints: the 10-stat OKS summary at maxDet=20)."""
        if self.iou_type == "keypoints":
            md = KP_MAX_DETS[0]
            self.stats = np.array([
                self._summarize(True, max_det=md),
                self._summarize(True, iou_thr=0.5, max_det=md),
                self._summarize(True, iou_thr=0.75, max_det=md),
                self._summarize(True, area="medium", max_det=md),
                self._summarize(True, area="large", max_det=md),
                self._summarize(False, max_det=md),
                self._summarize(False, iou_thr=0.5, max_det=md),
                self._summarize(False, iou_thr=0.75, max_det=md),
                self._summarize(False, area="medium", max_det=md),
                self._summarize(False, area="large", max_det=md),
            ])
            return self.stats
        self.stats = np.array([
            self._summarize(True),
            self._summarize(True, iou_thr=0.5),
            self._summarize(True, iou_thr=0.75),
            self._summarize(True, area="small"),
            self._summarize(True, area="medium"),
            self._summarize(True, area="large"),
            self._summarize(False, max_det=1),
            self._summarize(False, max_det=10),
            self._summarize(False, max_det=100),
            self._summarize(False, area="small"),
            self._summarize(False, area="medium"),
            self._summarize(False, area="large"),
        ])
        return self.stats


def merge_gathered_results(parts, iou_types):
    """Merge per-host (img_ids, results) shards, keeping only the FIRST
    host's records for any image that appears on several hosts (sampler
    padding duplicates). Keeping every gathered record would evaluate the
    duplicate images twice and depress AP with phantom false positives
    (reference dedupes its evalImgs identically,
    `e2edet/evaluate/coco_eval.py:175-205`)."""
    seen = set()
    keep_ids: List[int] = []
    merged: Dict[str, List[Dict]] = {t: [] for t in iou_types}
    for part_ids, part_res in parts:
        fresh = [i for i in part_ids if i not in seen]
        fresh_set = set(fresh)
        seen.update(fresh)
        keep_ids.extend(fresh)
        for t in iou_types:
            merged[t].extend(r for r in part_res.get(t, [])
                             if r["image_id"] in fresh_set)
    return keep_ids, merged


class CocoEvaluator:
    """Streaming evaluator over eval batches (reference `CocoEvaluator`
    surface, `evaluate/coco_eval.py:29-67`)."""

    def __init__(self, coco_gt, iou_types=("bbox",)):
        self.coco_gt = coco_gt
        self.iou_types = tuple(iou_types)
        self.results: Dict[str, List[Dict]] = {t: [] for t in self.iou_types}
        self.img_ids: List[int] = []

    def update(self, records_per_type: Dict[str, List[Dict]],
               img_ids: List[int]):
        # sampler padding can revisit an image on the same host; keep the
        # first evaluation only (reference dedupes evalImgs the same way,
        # `evaluate/coco_eval.py:175-205`)
        seen = set(self.img_ids)
        fresh = [i for i in img_ids if i not in seen]
        fresh_set = set(fresh)
        self.img_ids.extend(fresh)
        for t in self.iou_types:
            self.results[t].extend(
                r for r in records_per_type.get(t, [])
                if r["image_id"] in fresh_set)

    def synchronize_between_processes(self):
        """Every rank's (img_ids, results) gathered onto every rank, an
        image evaluated on several ranks (the sampler pads its shards
        evenly) keeping the first rank's records (the JAX package's
        `synchronize_between_processes`)."""
        from boxer_tpu_torch.parallel.distributed import all_gather

        parts = all_gather((self.img_ids, self.results))
        if len(parts) > 1:
            self.img_ids, self.results = merge_gathered_results(
                parts, self.iou_types)

    def accumulate_and_summarize(self, verbose: bool = True) -> Dict[str, np.ndarray]:
        stats = {}
        # dedupe img ids (an image may repeat with sampler padding)
        img_ids = sorted(set(self.img_ids))
        for t in self.iou_types:
            ev = COCOEval(self.coco_gt, iou_type=t, img_ids=img_ids)
            ev.evaluate(self.results[t])
            ev.accumulate()
            stats[f"coco_eval_{t}"] = ev.summarize()
            if verbose:
                if t == "keypoints":
                    names = ["AP", "AP50", "AP75", "APm", "APl",
                             "AR", "AR50", "AR75", "ARm", "ARl"]
                else:
                    names = ["AP", "AP50", "AP75", "APs", "APm", "APl",
                             "AR1", "AR10", "AR100", "ARs", "ARm", "ARl"]
                msg = " ".join(f"{n}={v:.4f}" for n, v in
                               zip(names, stats[f"coco_eval_{t}"]))
                print(f"[{t}] {msg}")
        return stats
