"""Offline Waymo detection evaluation; port of
`boxer_tpu/evaluate/waymo_eval.py` (numpy and scipy), the same metrics for
the same records.

Parity target: reference `e2edet/evaluate/waymo_eval.py` (standalone script
consuming the trainer's results dump; reference builds a TF graph with
waymo_open_dataset metric ops). This implementation is self-contained and
reproduces the semantics of the reference's metric config
(`waymo_eval.py:117-139`):

- matcher_type TYPE_HUNGARIAN: per frame/class, a maximum-total-IoU
  assignment over detection/GT pairs with IoU >= threshold (VEHICLE 0.7,
  PEDESTRIAN/SIGN/CYCLIST 0.5) — `matching="hungarian"` (default);
  the score-ordered greedy matcher is kept as `matching="greedy"`.
- 101 score cutoffs (0.00, 0.01, ..., 0.99, 1.0): each cutoff is an
  operating point with its own matching over the detections at/above it;
  AP integrates precision over recall with each recall step capped at
  desired_recall_delta=0.05 (the official default) so sparse operating
  points cannot inflate AP. `ap_mode="cutoffs"` (default); the
  all-recall-points precision-envelope estimator remains as
  `ap_mode="envelope"`.
- difficulty re-levelling by num_points (reference `waymo_eval.py:62-71`),
  100m distance cap (:201-208), LEVEL_2 cumulative over LEVEL_1; at
  LEVEL_1, detections matched to LEVEL_2-only GTs are ignored (neither TP
  nor FP).
- box_type TYPE_3D: rotated-BEV polygon intersection x z-extent overlap
  (`iou_fn=iou3d`); `bev_iou` remains available.
- boxes of 7 or more columns, the heading last (`_box7`): the trainer's
  records carry the frames' 9-column GT boxes.

When the official `waymo_open_dataset` package is available the script can
defer to it for exact parity numbers (not installable in this environment).
Validated against hand-computed rotated-IoU / AP fixtures, including cases
where greedy and Hungarian assignments disagree
(the JAX package's tests/test_waymo_metrics.py, which
`tests/test_torch_waymo.py` runs on this port too).

Usage: python -m boxer_tpu_torch.evaluate.waymo_eval --result <save_dir>/results.pkl
"""

import argparse
import pickle
from collections import defaultdict
from typing import Dict

import numpy as np

from boxer_tpu_torch.dataset.helper.database_sampler import _bev_corners

IOU_THRESH = {1: 0.7, 2: 0.5, 3: 0.5, 4: 0.5}  # by label idx
CLASS_NAMES = {1: "VEHICLE", 2: "PEDESTRIAN", 3: "SIGN", 4: "CYCLIST"}
MAX_DISTANCE = 100.0


def bev_iou(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Rotated BEV IoU via polygon clipping (Sutherland–Hodgman).
    boxes: (N, 7) [x,y,z,l,w,h,rad]."""
    n, m = len(boxes1), len(boxes2)
    if n == 0 or m == 0:
        return np.zeros((n, m))
    c1 = _bev_corners(boxes1)
    c2 = _bev_corners(boxes2)
    a1 = boxes1[:, 3] * boxes1[:, 4]
    a2 = boxes2[:, 3] * boxes2[:, 4]
    out = np.zeros((n, m))
    for i in range(n):
        for j in range(m):
            inter = _poly_intersection_area(c1[i], c2[j])
            union = a1[i] + a2[j] - inter
            out[i, j] = inter / max(union, 1e-9)
    return out


def _signed_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))) / 2


def _poly_intersection_area(p: np.ndarray, q: np.ndarray) -> float:
    """Area of intersection of two convex polygons (N,2); orientation
    agnostic (the clipper requires CCW clip edges)."""
    if _signed_area(q) < 0:
        q = q[::-1]
    poly = [tuple(v) for v in p]
    for k in range(len(q)):
        a = q[k]
        b = q[(k + 1) % len(q)]
        # clip poly by half-plane left of a->b
        new_poly = []
        for i in range(len(poly)):
            cur = np.asarray(poly[i])
            nxt = np.asarray(poly[(i + 1) % len(poly)])
            cur_in = _left(a, b, cur) >= 0
            nxt_in = _left(a, b, nxt) >= 0
            if cur_in:
                new_poly.append(tuple(cur))
            if cur_in != nxt_in:
                new_poly.append(tuple(_seg_line_intersect(cur, nxt, a, b)))
        poly = new_poly
        if not poly:
            return 0.0
    arr = np.asarray(poly)
    x, y = arr[:, 0], arr[:, 1]
    return float(abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))) / 2)


def _left(a, b, p):
    return (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0])


def _seg_line_intersect(p1, p2, a, b):
    d1 = _left(a, b, p1)
    d2 = _left(a, b, p2)
    t = d1 / (d1 - d2 + 1e-12)
    return p1 + t * (p2 - p1)


def iou3d(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Rotated 3D IoU (box TYPE_3D): BEV polygon intersection x z-extent
    overlap over the volume union. boxes: (N, 7) [x,y,z,l,w,h,rad]."""
    n, m = len(boxes1), len(boxes2)
    if n == 0 or m == 0:
        return np.zeros((n, m))
    c1 = _bev_corners(boxes1)
    c2 = _bev_corners(boxes2)
    v1 = boxes1[:, 3] * boxes1[:, 4] * boxes1[:, 5]
    v2 = boxes2[:, 3] * boxes2[:, 4] * boxes2[:, 5]
    z1lo, z1hi = boxes1[:, 2] - boxes1[:, 5] / 2, boxes1[:, 2] + boxes1[:, 5] / 2
    z2lo, z2hi = boxes2[:, 2] - boxes2[:, 5] / 2, boxes2[:, 2] + boxes2[:, 5] / 2
    out = np.zeros((n, m))
    for i in range(n):
        for j in range(m):
            zov = min(z1hi[i], z2hi[j]) - max(z1lo[i], z2lo[j])
            if zov <= 0:
                continue
            inter = _poly_intersection_area(c1[i], c2[j]) * zov
            union = v1[i] + v2[j] - inter
            out[i, j] = inter / max(union, 1e-9)
    return out


# official operating points (reference `waymo_eval.py:134-137`)
SCORE_CUTOFFS = tuple(np.round(np.arange(0, 100) * 0.01, 2)) + (1.0,)
DESIRED_RECALL_DELTA = 0.05


def hungarian_match(ious: np.ndarray, thr: float) -> np.ndarray:
    """Maximum-total-IoU assignment over pairs with IoU >= thr
    (matcher TYPE_HUNGARIAN). Returns for each detection row the matched GT
    column or -1. A zero-weight (below-threshold) assignment is equivalent
    to leaving both unmatched, so below-threshold pairs are dropped after
    the exact linear-sum solve."""
    n, m = ious.shape
    if n == 0 or m == 0:
        return np.full(n, -1, np.int64)
    from scipy.optimize import linear_sum_assignment

    w = np.where(ious >= thr, ious, 0.0)
    ri, cj = linear_sum_assignment(-w)
    match = np.full(n, -1, np.int64)
    for i, j in zip(ri, cj):
        if ious[i, j] >= thr:
            match[i] = j
    return match


def compute_ap_cutoffs(tp_at: np.ndarray, fp_at: np.ndarray,
                       num_gt: int,
                       delta: float = DESIRED_RECALL_DELTA) -> float:
    """Official-style AP from per-cutoff TP/FP counts: precision/recall at
    each score cutoff (descending cutoff = ascending recall), integrated as
    sum(precision_i * min(recall_i - recall_{i-1}, delta)) — recall jumps
    larger than `delta` between consecutive operating points contribute at
    most `delta` (penalizes sparse operating points)."""
    if num_gt == 0:
        return 0.0
    order = np.arange(len(tp_at))[::-1]  # descending cutoff index
    recall = tp_at[order] / num_gt
    precision = tp_at[order] / np.maximum(tp_at[order] + fp_at[order], 1e-9)
    ap = 0.0
    prev_r = 0.0
    for r, p in zip(recall, precision):
        if r > prev_r:
            ap += p * min(r - prev_r, delta)
            prev_r = r
    return float(ap)


def compute_ap(scores: np.ndarray, tp: np.ndarray, num_gt: int) -> float:
    """Interpolated AP over all recall points (Waymo-style)."""
    if num_gt == 0 or len(scores) == 0:
        return 0.0
    order = np.argsort(-scores)
    tp = tp[order]
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(~tp)
    recall = cum_tp / num_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1e-9)
    # monotone precision envelope
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    # integrate over recall
    ap = 0.0
    prev_r = 0.0
    for r, p in zip(recall, precision):
        ap += (r - prev_r) * p
        prev_r = r
    return float(ap)


def relevel_difficulty(difficulty: np.ndarray,
                       num_points: np.ndarray) -> np.ndarray:
    """LEVEL_2 if annotated as 2 or <= 5 points, else LEVEL_1
    (reference `waymo_eval.py:62-71`)."""
    out = np.where((difficulty == 2) | (num_points <= 5), 2, 1)
    out = np.where(num_points == 0, 2, out)
    return out


def evaluate_results(results: Dict, iou_fn=None, matching: str = "hungarian",
                     ap_mode: str = "cutoffs") -> Dict[str, float]:
    """results: {token: {pred_boxes3d, pred_scores, pred_labels, boxes3d,
    labels, difficulty, num_points_in_gt, classes}}.

    matching: "hungarian" (official TYPE_HUNGARIAN max-total-IoU assignment,
    re-run per score cutoff) or "greedy" (score-ordered, the legacy path).
    ap_mode: "cutoffs" (official 101 score-cutoff operating points with
    recall-delta-capped integration) or "envelope" (precision envelope over
    all recall points). iou_fn defaults to `iou3d` (box TYPE_3D) for the
    official mode and `bev_iou` for the legacy greedy mode."""
    assert matching in ("hungarian", "greedy")
    assert ap_mode in ("cutoffs", "envelope")
    if iou_fn is None:
        iou_fn = iou3d if matching == "hungarian" else bev_iou
    if matching == "hungarian":
        return _evaluate_official(results, iou_fn, ap_mode)
    return _evaluate_greedy(results, iou_fn, ap_mode)


def _frame_class_iter(results):
    """Yield per-(frame, class) matched arrays after distance capping and
    difficulty re-levelling: (cls, gt_boxes, gt_levels, dt_boxes, dt_scores).
    """
    for token, rec in results.items():
        gt_boxes = np.asarray(rec.get("boxes3d") if rec.get("boxes3d") is not None
                              else np.zeros((0, 7)), np.float32)
        gt_labels = np.asarray(rec.get("labels") if rec.get("labels") is not None
                               else np.zeros((0,)), np.int64)
        difficulty = np.asarray(rec.get("difficulty") if rec.get("difficulty")
                                is not None else np.zeros(len(gt_labels)),
                                np.int64)
        num_pts = np.asarray(rec.get("num_points_in_gt") if
                             rec.get("num_points_in_gt") is not None
                             else np.full(len(gt_labels), 10), np.int64)
        levels = relevel_difficulty(difficulty, num_pts)

        dt_boxes = np.asarray(rec["pred_boxes3d"], np.float32)
        dt_scores = np.asarray(rec["pred_scores"], np.float32)
        dt_labels = np.asarray(rec["pred_labels"], np.int64)

        # distance cap (reference `waymo_eval.py:201-208`)
        if len(gt_boxes):
            keep = np.linalg.norm(gt_boxes[:, :2], axis=1) <= MAX_DISTANCE
            gt_boxes, gt_labels = gt_boxes[keep], gt_labels[keep]
            levels = levels[keep]
        if len(dt_boxes):
            keep = np.linalg.norm(dt_boxes[:, :2], axis=1) <= MAX_DISTANCE
            dt_boxes, dt_scores, dt_labels = (dt_boxes[keep], dt_scores[keep],
                                              dt_labels[keep])

        for cls in np.unique(np.concatenate([gt_labels, dt_labels])):
            if cls not in IOU_THRESH:
                continue
            g_sel = gt_labels == cls
            d_sel = dt_labels == cls
            order = np.argsort(-dt_scores[d_sel])
            yield (int(cls), _box7(gt_boxes[g_sel]), levels[g_sel],
                   _box7(dt_boxes[d_sel])[order], dt_scores[d_sel][order])


def _box7(boxes):
    """(N, 7+) boxes as (x, y, z, l, w, h, heading): the heading is the last
    column, after the velocity of the converter's 9-column boxes. (The JAX
    package takes the first 7 columns, and so vx as the heading of a
    9-column GT box.)"""
    return np.concatenate([boxes[:, :6], boxes[:, -1:]], axis=1)


def _evaluate_greedy(results, iou_fn, ap_mode) -> Dict[str, float]:
    """Legacy path: one greedy score-ordered matching per frame/class."""
    buckets = defaultdict(lambda: {"scores": [], "tp": [], "num_gt": 0})

    for cls, g_box, g_lvl, d_box, d_sc in _frame_class_iter(results):
        ious = iou_fn(d_box, g_box) if len(g_box) else \
            np.zeros((len(d_box), 0))

        matched = np.zeros(len(g_box), bool)
        thr = IOU_THRESH[cls]
        for lvl in (1, 2):
            # LEVEL_2 metrics include LEVEL_1 boxes (cumulative)
            buckets[(cls, lvl)]["num_gt"] += int((g_lvl <= lvl).sum())

        tp_flags = np.zeros(len(d_box), bool)
        match_lvl = np.zeros(len(d_box), np.int64)
        for di in range(len(d_box)):
            if ious.shape[1] == 0:
                continue
            j = int(np.argmax(np.where(matched, -1.0, ious[di])))
            if ious[di, j] >= thr and not matched[j]:
                matched[j] = True
                tp_flags[di] = True
                match_lvl[di] = g_lvl[j]
        for lvl in (1, 2):
            sel = (~tp_flags) | (match_lvl <= lvl)
            buckets[(cls, lvl)]["scores"].append(d_sc[sel])
            buckets[(cls, lvl)]["tp"].append(tp_flags[sel])

    metrics = {}
    for (cls, lvl), b in sorted(buckets.items()):
        scores = (np.concatenate(b["scores"]) if b["scores"]
                  else np.zeros((0,)))
        tp = np.concatenate(b["tp"]) if b["tp"] else np.zeros((0,), bool)
        if ap_mode == "envelope":
            ap = compute_ap(scores, tp, b["num_gt"])
        else:
            nc = len(SCORE_CUTOFFS)
            tp_at = np.zeros(nc)
            fp_at = np.zeros(nc)
            for ci, c in enumerate(SCORE_CUTOFFS):
                keep = scores >= c
                tp_at[ci] = tp[keep].sum()
                fp_at[ci] = (~tp[keep]).sum()
            ap = compute_ap_cutoffs(tp_at, fp_at, b["num_gt"])
        metrics[f"{CLASS_NAMES[cls]}_LEVEL_{lvl}_AP"] = round(ap, 4)
    return metrics


def _evaluate_official(results, iou_fn, ap_mode) -> Dict[str, float]:
    """Official semantics: per score cutoff, an independent Hungarian
    (max-total-IoU) assignment; TP/FP counts accumulated across frames per
    (class, level, cutoff); AP via recall-delta-capped integration."""
    nc = len(SCORE_CUTOFFS)
    cut = np.asarray(SCORE_CUTOFFS)
    # per (class, level): tp/fp counts per cutoff + num_gt
    buckets = defaultdict(lambda: {"tp": np.zeros(nc), "fp": np.zeros(nc),
                                   "num_gt": 0, "scores": [], "tpf": []})

    for cls, g_box, g_lvl, d_box, d_sc in _frame_class_iter(results):
        thr = IOU_THRESH[cls]
        ious = iou_fn(d_box, g_box) if len(g_box) else \
            np.zeros((len(d_box), 0))
        for lvl in (1, 2):
            buckets[(cls, lvl)]["num_gt"] += int((g_lvl <= lvl).sum())

        # detections are score-sorted; cutoff c keeps the first n(c) rows.
        # Exact reduction: a row whose max IoU is < thr can never be matched
        # (hungarian_match drops below-thr pairs after the solve, and its
        # zero-weight row removes nothing from the optimum over the rest),
        # so only FEASIBLE rows need solving — one solve per distinct
        # feasible count (<= #rows overlapping a gt + 1, typically a handful
        # per frame·class instead of up to 101).
        n_at = np.searchsorted(-d_sc, -cut, side="right")
        feasible = ((ious >= thr).any(axis=1) if ious.size
                    else np.zeros(len(d_box), bool))
        feas_idx = np.flatnonzero(feasible)
        feas_cum = np.concatenate([[0], np.cumsum(feasible)])
        sub_cache = {}

        def match_at(n):
            k = int(feas_cum[n])
            if k not in sub_cache:
                sub_cache[k] = hungarian_match(ious[feas_idx[:k]], thr)
            m = np.full(n, -1, np.int64)
            m[feas_idx[:k]] = sub_cache[k]
            return m

        envelope_match = None
        for ci in range(nc):
            n = int(n_at[ci])
            if n == 0:
                continue
            match = match_at(n)
            if n == len(d_box):
                envelope_match = match
            is_tp = match >= 0
            m_lvl = np.where(is_tp, g_lvl[np.clip(match, 0, None)]
                             if len(g_lvl) else 0, 3)
            for lvl in (1, 2):
                tp = int((is_tp & (m_lvl <= lvl)).sum())
                fp = int((~is_tp).sum())
                buckets[(cls, lvl)]["tp"][ci] += tp
                buckets[(cls, lvl)]["fp"][ci] += fp
        if ap_mode == "envelope":
            if envelope_match is None:
                envelope_match = match_at(len(d_box))
            is_tp = envelope_match >= 0
            m_lvl = np.where(is_tp, g_lvl[np.clip(envelope_match, 0, None)]
                             if len(g_lvl) else 0, 3)
            for lvl in (1, 2):
                sel = (~is_tp) | (m_lvl <= lvl)
                buckets[(cls, lvl)]["scores"].append(d_sc[sel])
                buckets[(cls, lvl)]["tpf"].append(is_tp[sel])

    metrics = {}
    for (cls, lvl), b in sorted(buckets.items()):
        if ap_mode == "envelope":
            scores = (np.concatenate(b["scores"]) if b["scores"]
                      else np.zeros((0,)))
            tp = (np.concatenate(b["tpf"]) if b["tpf"]
                  else np.zeros((0,), bool))
            ap = compute_ap(scores, tp, b["num_gt"])
        else:
            ap = compute_ap_cutoffs(b["tp"], b["fp"], b["num_gt"])
        metrics[f"{CLASS_NAMES[cls]}_LEVEL_{lvl}_AP"] = round(ap, 4)
    return metrics


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--result", required=True,
                        help="results.pkl from the trainer's test run")
    args = parser.parse_args()
    with open(args.result, "rb") as f:
        results = pickle.load(f)
    metrics = evaluate_results(results)
    for k, v in metrics.items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
