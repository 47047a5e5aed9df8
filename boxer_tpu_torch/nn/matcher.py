"""Hungarian matching on the step's device; port of `boxer_tpu/nn/matcher.py`.

An exact shortest-augmenting-path (Jonker-Volgenant style) solver with dual
potentials, `ops/hungarian.py:solve_assignment` (H1): on a CUDA tensor one
kernel launch solves every problem of the call, a thread-block cluster
a problem, with no host round trip, as the JAX package's vmapped
`lax.while_loop`s run inside the one XLA program of its train step; on a
CPU tensor its plain version. Ties break as there: `argmin` takes the first
minimum, the pruning top-k the lower index.

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

from boxer_tpu_torch.ops.hungarian import BIG, solve_assignment
from boxer_tpu_torch.utils.box3d_ops import (box_cxcyczlwh_to_xyxyxy,
                                             generalized_box3d_iou)
from boxer_tpu_torch.utils.box_ops import (box_cxcywh_to_xyxy,
                                           generalized_box_iou)
from boxer_tpu_torch.utils.general import top_k
from boxer_tpu_torch.utils.timer import span


def assignment_problem(cost, row_valid):
    """The problems `hungarian` solves: (sub (N, NT, M) f32, n_rows (N,)
    int32, rows (N, NT), cand (N, M) or None). sub holds each problem's
    valid rows first, in their order (`rows` maps them back), pruned to the
    candidate columns `cand` when NQ > 4*NT; n_rows counts the valid rows.
    Shapes alone decide the sizes: nothing is read back to the host."""
    nt, nq = cost.shape[-2:]
    if nt > nq:
        raise ValueError(f"hungarian: {nt} target rows for {nq} query "
                         "columns; every row needs a column")
    valid = row_valid.reshape(-1, nt)
    flat = torch.where(valid[..., None], cost.reshape(-1, nt, nq).float(),
                       0.0)
    nb = flat.shape[0]
    cand = None
    if nq > 4 * nt:
        _, idx = top_k(-flat, nt)                             # (N, NT, NT)
        cand = idx.reshape(nb, nt * nt).sort(dim=-1).values
        dup = torch.cat([torch.zeros_like(cand[:, :1], dtype=torch.bool),
                         cand[:, 1:] == cand[:, :-1]], dim=-1)
        flat = flat.gather(2, cand[:, None, :].expand(nb, nt, nt * nt))
        flat = torch.where(dup[:, None, :], BIG, flat)
    rows = torch.sort((~valid).to(torch.uint8), dim=1, stable=True).indices
    sub = flat.gather(1, rows[..., None].expand(nb, nt, flat.shape[-1]))
    return sub, valid.sum(1, dtype=torch.int32), rows, cand


@torch.no_grad()
def hungarian(cost, row_valid):
    """Batched assignment. cost: (..., NT, NQ); row_valid: (..., NT) bool.
    Returns col4row (..., NT) int64; entries of invalid rows are arbitrary
    columns, to be masked by the caller. On a CUDA tensor it makes no host
    sync.

    Only the valid rows are solved. The JAX package keeps a padding row in
    the problem as a row of constant zeros, which can take any column the
    valid rows leave without changing their optimum, at tens of solver
    steps a row. So the valid rows are moved first, in their order, and
    the solver stops at each problem's valid count; the padded shape stays.
    The valid rows' matches are the full problem's unless two assignments
    tie exactly.

    Column pruning (exact), as the JAX package does: when NQ > 4*NT each
    problem is restricted to the union of every row's NT cheapest columns.
    An optimal assignment that used a column outside row i's NT best could
    swap to one of those NT cheaper columns, at most NT-1 of which are
    taken, without raising the total; this holds for any count of rows up
    to NT, so for the valid rows alone too. Duplicate candidates get a BIG
    cost, so no column is assigned twice. The Waymo encoder-output match
    (NT=250, NQ~205k) becomes a (250, 62,500) problem.
    """
    with span("boxer.train.matcher"):
        sub, n_rows, rows, cand = assignment_problem(cost, row_valid)
        col = solve_assignment(sub, n_rows)
        if cand is not None:
            col = cand.gather(1, col)
        out = torch.empty_like(col).scatter_(1, rows, col)
    return out.reshape(*cost.shape[:-1])


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
