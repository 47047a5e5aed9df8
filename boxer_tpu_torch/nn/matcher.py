"""Hungarian matching on the step's device; port of `boxer_tpu/nn/matcher.py`.

An exact shortest-augmenting-path (Jonker-Volgenant style) solver with dual
potentials, run in lockstep over every problem of a step: all problems take
the same outer row loop, and the inner Dijkstra and augmenting loops run
until the last problem is done, a finished problem keeping its state (what
the JAX package's vmapped `lax.while_loop` does). Ties break as there:
`argmin` takes the first minimum, the pruning top-k the lower index.

Cost (focal labels): w_cls * (pos - neg)[q, label_t] + w_l1 * |b_q - b_t|_1
+ w_giou * (-GIoU), or with DETR's softmax labels w_cls * (-softmax[q,
label_t]) in place of the focal term; the 3D matcher takes the L1 and the axis-aligned 3D
GIoU over (cx, cy, cz, l, w, h) and adds w_rad * |rad_q - rad_t|. Only
the valid targets' rows are solved (`hungarian`); an invalid target's
column is 0, masked by every caller. Matching carries no gradient: it runs
under `torch.no_grad`.
"""

from typing import Tuple

import torch

from boxer_tpu_torch.utils.box3d_ops import (box_cxcyczlwh_to_xyxyxy,
                                             generalized_box3d_iou)
from boxer_tpu_torch.utils.box_ops import (box_cxcywh_to_xyxy,
                                           generalized_box_iou)
from boxer_tpu_torch.utils.general import top_k

BIG = 1e9


def _hungarian_batched(cost):
    """Min-cost assignment of each (n, m) problem of cost (N, n, m), n <= m.
    Returns col4row (N, n) int64: the column assigned to each row."""
    nb, n, m = cost.shape
    dev = cost.device
    cost = cost.float()
    ar = torch.arange(nb, device=dev)
    # 1-indexed over columns; column 0 is the virtual start column.
    # p[:, j] = row assigned to column j (-1 = free); u, v duals.
    u = torch.zeros(nb, n, device=dev)
    v = torch.zeros(nb, m + 1, device=dev)
    p = torch.full((nb, m + 1), -1, dtype=torch.long, device=dev)

    for i in range(n):
        p[:, 0] = i
        minv = torch.full((nb, m + 1), BIG, device=dev)
        minv[:, 0] = -BIG
        way = torch.zeros(nb, m + 1, dtype=torch.long, device=dev)
        used = torch.zeros(nb, m + 1, dtype=torch.bool, device=dev)
        j0 = torch.zeros(nb, dtype=torch.long, device=dev)

        while True:
            i0 = p[ar, j0]
            active = i0 != -1
            if not bool(active.any()):
                break
            i0 = i0.clamp(min=0)
            used_n = used.clone()
            used_n[ar, j0] = True
            cur = cost[ar, i0] - u[ar, i0][:, None] - v[:, 1:]
            cur = torch.where(used_n[:, 1:], BIG, cur)
            better = cur < minv[:, 1:]
            minv_n = minv.clone()
            minv_n[:, 1:] = torch.where(better, cur, minv[:, 1:])
            way_n = way.clone()
            way_n[:, 1:] = torch.where(better, j0[:, None], way[:, 1:])

            masked = torch.where(used_n[:, 1:], BIG, minv_n[:, 1:])
            j1 = masked.argmin(dim=1) + 1
            delta = masked[ar, j1 - 1][:, None]
            # dual update: rows of used columns += delta, their v -= delta;
            # unused columns' reduced costs shrink by delta
            # (a finished problem's last column is free: its p is -1)
            rows = torch.where(used_n & (p >= 0), p, n)
            row_mask = torch.zeros(nb, n + 1, dtype=torch.bool, device=dev)
            row_mask = row_mask.scatter_(1, rows, True)[:, :n]
            u_n = torch.where(row_mask, u + delta, u)
            v_n = torch.where(used_n, v - delta, v)
            minv_n = torch.where(used_n, minv_n, minv_n - delta)

            act = active[:, None]
            used = torch.where(act, used_n, used)
            minv = torch.where(act, minv_n, minv)
            way = torch.where(act, way_n, way)
            u = torch.where(act, u_n, u)
            v = torch.where(act, v_n, v)
            j0 = torch.where(active, j1, j0)

        # augment: walk back along `way`, shifting assignments
        while True:
            act = j0 != 0
            if not bool(act.any()):
                break
            j1 = way[ar, j0]
            p_n = p.clone()
            p_n[ar, j0] = p[ar, j1]
            p = torch.where(act[:, None], p_n, p)
            j0 = torch.where(act, j1, j0)

    # invert: col4row[r] = j such that p[j+1] == r (0-indexed real columns)
    rows = torch.where(p[:, 1:] >= 0, p[:, 1:], n)
    cols = torch.arange(m, device=dev).expand(nb, m)
    col4row = torch.zeros(nb, n + 1, dtype=torch.long, device=dev)
    return col4row.scatter_(1, rows, cols)[:, :n]


@torch.no_grad()
def hungarian(cost, row_valid):
    """Batched assignment. cost: (..., NT, NQ); row_valid: (..., NT) bool.
    Returns col4row (..., NT) int64; entries of invalid rows are arbitrary
    columns, to be masked by the caller.

    Only the valid rows are solved. The JAX package keeps a padding row in
    the problem as a row of constant zeros, which can take any column the
    valid rows leave without changing their optimum; but the solver spends
    tens of iterations on each such row, each iteration a host sync here:
    at the shipped configs' 100 padded targets, an image's 2-3 objects
    cost about 5,000 syncs a matcher call. So the valid rows are moved
    first (in their order) and the problem cut to the largest valid count
    (one host sync). The valid rows' matches are the full problem's
    unless two assignments tie exactly.

    Column pruning (exact) when NQ > 4*K for K rows: each problem is
    restricted to the union of every row's K cheapest columns. An optimal
    assignment that used a column outside row i's K best could swap to one
    of those K cheaper columns, at most K-1 of which are taken, without
    raising the total. Duplicate candidates get a BIG cost, so no column is
    assigned twice. The encoder-output match (K=20, NQ~20k) becomes a
    (20, 400) solve.
    """
    batch_shape = cost.shape[:-2]
    nt, nq = cost.shape[-2:]
    if nt > nq:
        raise ValueError(f"hungarian: {nt} target rows for {nq} query "
                         "columns; every row needs a column")
    valid = row_valid.reshape(-1, nt)
    flat = torch.where(valid[..., None], cost.reshape(-1, nt, nq).float(),
                       0.0)
    nb = flat.shape[0]
    out = torch.zeros(nb, nt, dtype=torch.long, device=cost.device)
    k = int(valid.sum(1).max()) if nb else 0
    if k:
        rows = torch.sort((~valid).to(torch.uint8), dim=1,
                          stable=True).indices[:, :k]
        sub = flat.gather(1, rows[..., None].expand(nb, k, nq))
        out.scatter_(1, rows, _solve_pruned(sub))
    return out.reshape(*batch_shape, nt)


def _solve_pruned(flat):
    """col4row (N, K) of the (N, K, NQ) problems, pruned to every row's K
    cheapest columns when NQ > 4*K (see `hungarian`)."""
    nb, k, nq = flat.shape
    if nq <= 4 * k:
        return _hungarian_batched(flat)
    _, idx = top_k(-flat, k)                              # (N, K, K)
    cand = idx.reshape(nb, k * k).sort(dim=-1).values
    dup = torch.cat([torch.zeros_like(cand[:, :1], dtype=torch.bool),
                     cand[:, 1:] == cand[:, :-1]], dim=-1)
    sub = flat.gather(2, cand[:, None, :].expand(nb, k, k * k))
    sub = torch.where(dup[:, None, :], BIG, sub)
    return cand.gather(1, _hungarian_batched(sub))


def _focal_class_cost(out_prob, tgt_labels, alpha=0.25, gamma=2.0):
    """out_prob: (B, NQ, C) sigmoid probs; tgt_labels: (B, NT) int.
    Returns (B, NQ, NT)."""
    neg = (1 - alpha) * (out_prob ** gamma) * (-torch.log(1 - out_prob + 1e-8))
    pos = alpha * ((1 - out_prob) ** gamma) * (-torch.log(out_prob + 1e-8))
    labels = tgt_labels.long().clamp(0, out_prob.shape[-1] - 1)
    idx = labels[:, None, :].expand(-1, out_prob.shape[1], -1)
    return pos.gather(2, idx) - neg.gather(2, idx)


def _softmax_class_cost(out_logits, tgt_labels):
    """DETR's class cost: minus the softmax probability of each target's
    class, (B, NQ, NT)."""
    prob = torch.softmax(out_logits, dim=-1)
    labels = tgt_labels.long().clamp(0, prob.shape[-1] - 1)
    return -prob.gather(2, labels[:, None, :].expand(-1, prob.shape[1], -1))


class HungarianMatcher:
    """2D matcher with the focal class cost, or DETR's softmax one
    (`focal_label=False`).

    __call__(outputs, targets) -> (query_idx (B, NT) int64, valid (B, NT)
    bool) where outputs = {"pred_logits" (B,NQ,C), "pred_boxes" (B,NQ,4)}
    and targets = {"labels" (B,NT), "boxes" (B,NT,4) cxcywh, "valid"
    (B,NT)}.
    """

    def __init__(self, cost_class=1.0, cost_bbox=1.0, cost_giou=1.0,
                 focal_label=True):
        self.cost_class = cost_class
        self.cost_bbox = cost_bbox
        self.cost_giou = cost_giou
        self.focal_label = focal_label

    @torch.no_grad()
    def cost_matrix(self, outputs, targets):
        logits = outputs["pred_logits"].float()
        out_bbox = outputs["pred_boxes"].float()
        tgt_bbox = targets["boxes"].float()
        cost_class = (_focal_class_cost(torch.sigmoid(logits),
                                        targets["labels"])
                      if self.focal_label
                      else _softmax_class_cost(logits, targets["labels"]))
        cost_bbox = (out_bbox[:, :, None, :] - tgt_bbox[:, None, :, :]
                     ).abs().sum(-1)
        cost_giou = -generalized_box_iou(box_cxcywh_to_xyxy(out_bbox),
                                         box_cxcywh_to_xyxy(tgt_bbox))
        return (self.cost_bbox * cost_bbox + self.cost_class * cost_class
                + self.cost_giou * cost_giou)            # (B, NQ, NT)

    def __call__(self, outputs, targets) -> Tuple[torch.Tensor, torch.Tensor]:
        c = self.cost_matrix(outputs, targets)
        valid = targets["valid"]
        return hungarian(c.transpose(-1, -2), valid), valid


class HungarianMatcher3d(HungarianMatcher):
    """3D matcher: boxes (B, N, 7) (cx, cy, cz, l, w, h, rad), the rad
    cost beside the 2D matcher's three."""

    def __init__(self, cost_class=1.0, cost_bbox=1.0, cost_giou=1.0,
                 cost_rad=1.0):
        super().__init__(cost_class, cost_bbox, cost_giou)
        self.cost_rad = cost_rad

    @torch.no_grad()
    def cost_matrix(self, outputs, targets):
        boxes = outputs["pred_boxes"].float()
        tgt = targets["boxes"].float()
        out_bbox, out_rad = boxes[..., :6], boxes[..., 6:]
        tgt_bbox, tgt_rad = tgt[..., :6], tgt[..., 6:]
        cost_class = _focal_class_cost(
            torch.sigmoid(outputs["pred_logits"].float()), targets["labels"])
        cost_bbox = (out_bbox[:, :, None, :] - tgt_bbox[:, None, :, :]
                     ).abs().sum(-1)
        cost_rad = (out_rad[:, :, None, :] - tgt_rad[:, None, :, :]
                    ).abs().sum(-1)
        cost_giou = -generalized_box3d_iou(box_cxcyczlwh_to_xyxyxy(out_bbox),
                                           box_cxcyczlwh_to_xyxyxy(tgt_bbox))
        return (self.cost_bbox * cost_bbox + self.cost_class * cost_class
                + self.cost_giou * cost_giou + self.cost_rad * cost_rad)


def build_matcher(config):
    """The matcher of a loss config's `matcher` entry (`hungarian`, with the
    focal or the softmax class cost, or `hungarian3d`)."""
    params = config["params"]
    if config["type"] == "hungarian":
        return HungarianMatcher(params["class_weight"], params["bbox_weight"],
                                params["giou_weight"],
                                focal_label=params.get("focal_label", False))
    if config["type"] == "hungarian3d":
        return HungarianMatcher3d(params["class_weight"],
                                  params["bbox_weight"], params["giou_weight"],
                                  params["rad_weight"])
    raise ValueError(f"Unknown matcher type: {config['type']}")
