"""Set-prediction losses for BoxeR-2D, BoxeR-3D and DETR; port of
`boxer_tpu/criterion/losses.py` (sigmoid focal loss, dice loss, focal
labels, DETR's softmax labels, boxes, 3D boxes, masks, the composite
Boxer2DCriterion, Boxer3DCriterion and DETRCriterion with the encoder's
binary-label loss and the per-layer aux losses, the weighted total, and
`build_loss` from a model config's `loss` node).

Fixed-shape design, as in the JAX package: targets are padded to NT boxes
with a `valid` mask, matching returns `query_idx (B, NT)`, and every loss is
a masked sum over the global `num_boxes`. Losses are computed in f32.
"""

from typing import Dict

import torch
import torch.nn.functional as F

from boxer_tpu_torch.nn.matcher import build_matcher
from boxer_tpu_torch.parallel import distributed
from boxer_tpu_torch.utils.box3d_ops import (
    box_cxcyczlwh_to_xyxyxy, elementwise_generalized_box3d_iou)
from boxer_tpu_torch.utils.box_ops import (box_cxcywh_to_xyxy,
                                           elementwise_generalized_box_iou)


def sigmoid_focal_loss(inputs, targets, num_boxes, alpha: float = 0.25,
                       gamma: float = 2.0, mask=None):
    """`mask` restricts the sum (padding)."""
    inputs = inputs.float()
    targets = targets.float()
    prob = torch.sigmoid(inputs)
    ce = F.binary_cross_entropy_with_logits(inputs, targets, reduction="none")
    p_t = prob * targets + (1 - prob) * (1 - targets)
    loss = ce * ((1 - p_t) ** gamma)
    if alpha >= 0:
        alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
        loss = alpha_t * loss
    if mask is not None:
        loss = torch.where(mask, loss, 0.0)
    return loss.sum() / num_boxes


def dice_loss(inputs, targets, num_boxes, valid=None):
    """inputs/targets (N, ...), flattened per row."""
    inputs = torch.sigmoid(inputs.float()).reshape(inputs.shape[0], -1)
    targets = targets.float().reshape(targets.shape[0], -1)
    numerator = 2 * (inputs * targets).sum(1)
    denominator = inputs.sum(-1) + targets.sum(-1)
    loss = 1 - (numerator + 1) / (denominator + 1)
    if valid is not None:
        loss = torch.where(valid, loss, 0.0)
    return loss.sum() / num_boxes


def _gather_queries(arr, query_idx):
    """arr (B, NQ, ...) gathered at query_idx (B, NT) -> (B, NT, ...)."""
    idx = query_idx.reshape(query_idx.shape + (1,) * (arr.dim() - 2))
    return arr.gather(1, idx.expand(query_idx.shape + arr.shape[2:]))


def focal_label_loss(outputs, targets, query_idx, valid, num_boxes,
                     num_classes: int, focal_alpha: float = 0.25):
    """One-hot targets over all queries; matched queries carry the GT
    class, the rest none (num_classes = no object)."""
    logits = outputs["pred_logits"].float()                # (B, NQ, C)
    b, nq, _ = logits.shape
    labels = torch.where(valid, targets["labels"].long(), num_classes)
    # invalid targets scatter into a dropped extra column
    scatter_idx = torch.where(valid, query_idx, nq)
    target_classes = torch.full((b, nq + 1), num_classes, dtype=torch.long,
                                device=logits.device)
    target_classes = target_classes.scatter(1, scatter_idx, labels)[:, :nq]
    onehot = F.one_hot(target_classes, num_classes + 1)[..., :num_classes]
    return {"loss_ce": sigmoid_focal_loss(logits, onehot, num_boxes,
                                          alpha=focal_alpha, gamma=2.0)}


def label_loss_ce(outputs, targets, query_idx, valid, num_boxes,
                  num_classes: int, eos_coef: float, iter_per_update: int = 1,
                  *, dp):
    """DETR's softmax CE over num_classes + 1 columns, the no-object
    column weighted by `eos_coef`, normalised by the summed class weights
    (over every data shard's share of the microbatch: the ranks of the dp
    axis `dp`, a `parallel.mesh.Axis`) and divided by `iter_per_update`,
    not by `num_boxes` (`boxer_tpu/criterion/losses.py:94-110`)."""
    logits = outputs["pred_logits"].float()                # (B, NQ, C+1)
    b, nq, _ = logits.shape
    labels = torch.where(valid, targets["labels"].long(), num_classes)
    scatter_idx = torch.where(valid, query_idx, nq)
    target_classes = torch.full((b, nq + 1), num_classes, dtype=torch.long,
                                device=logits.device)
    target_classes = target_classes.scatter(1, scatter_idx, labels)[:, :nq]
    nll = -torch.log_softmax(logits, dim=-1).gather(
        2, target_classes[..., None])[..., 0]
    weights = torch.where(target_classes == num_classes, eos_coef, 1.0)
    total = weights.sum()
    if dp.size > 1:
        total = distributed.all_reduce_sum(total, dp.group)
    return {"loss_ce": (nll * weights).sum() / total / iter_per_update}


def boxes_loss(outputs, targets, query_idx, valid, num_boxes):
    """Masked L1 + GIoU / num_boxes."""
    src_boxes = _gather_queries(outputs["pred_boxes"].float(), query_idx)
    tgt_boxes = targets["boxes"].float()
    l1 = (src_boxes - tgt_boxes).abs().sum(-1)
    giou = 1.0 - elementwise_generalized_box_iou(
        box_cxcywh_to_xyxy(src_boxes), box_cxcywh_to_xyxy(tgt_boxes))
    vf = valid.float()
    return {"loss_bbox": (l1 * vf).sum() / num_boxes,
            "loss_giou": (giou * vf).sum() / num_boxes}


def boxes3d_loss(outputs, targets, query_idx, valid, num_boxes):
    """Masked L1 over (cx, cy, cz, l, w, h), axis-aligned 3D GIoU and the
    rad L1, each / num_boxes."""
    src = _gather_queries(outputs["pred_boxes"].float(), query_idx)
    tgt = targets["boxes"].float()
    l1 = (src[..., :6] - tgt[..., :6]).abs().sum(-1)
    rad = (src[..., 6:] - tgt[..., 6:]).abs().sum(-1)
    giou = 1.0 - elementwise_generalized_box3d_iou(
        box_cxcyczlwh_to_xyxyxy(src[..., :6]),
        box_cxcyczlwh_to_xyxyxy(tgt[..., :6]))
    vf = valid.float()
    return {"loss_bbox": (l1 * vf).sum() / num_boxes,
            "loss_giou": (giou * vf).sum() / num_boxes,
            "loss_rad": (rad * vf).sum() / num_boxes}


def mask_loss(outputs, targets, query_idx, valid, num_boxes,
              mask_size: int = 28):
    """Focal / mask_size² + dice over the box-cropped GT masks, which the
    input pipeline provides as `instance_masks` (B, NT, s, s)."""
    src_masks = _gather_queries(outputs["pred_masks"], query_idx)
    tgt_masks = targets["instance_masks"]
    b, nt = valid.shape
    src_flat = src_masks.reshape(b * nt, -1)
    tgt_flat = tgt_masks.reshape(b * nt, -1)
    vflat = valid.reshape(b * nt)
    focal = sigmoid_focal_loss(src_flat, tgt_flat, num_boxes,
                               mask=vflat[:, None]) / (mask_size ** 2)
    dice = dice_loss(src_flat, tgt_flat, num_boxes, valid=vflat)
    return {"loss_mask": focal, "loss_dice": dice}


def match_layers(matcher, output_list, targets):
    """Match a list of per-layer output dicts in one matcher call: the
    layers are stacked into the batch dimension, so every solve runs in one
    lockstep loop. Per-layer results equal separate calls. Returns
    (query_idx list, valid list), one entry per output dict."""
    if len(output_list) == 1:
        qi, valid = matcher(output_list[0], targets)
        return [qi], [valid]
    nl = len(output_list)
    b, nt = targets["valid"].shape

    def stack(key):
        x = torch.stack([o[key].detach() for o in output_list])
        return x.reshape((nl * b,) + x.shape[2:])

    def tile(v):
        return v.repeat((nl,) + (1,) * (v.dim() - 1))

    qi, valid = matcher(
        {"pred_logits": stack("pred_logits"), "pred_boxes": stack("pred_boxes")},
        {k: tile(targets[k]) for k in ("labels", "boxes", "valid")})
    qi = qi.reshape(nl, b, nt)
    valid = valid.reshape(nl, b, nt)
    return list(qi), list(valid)


class Boxer2DCriterion:
    """The BoxeR-2D loss: focal labels + boxes (+ masks) on the final layer,
    each aux layer (`_{i}`) and the encoder head (`_enc_{i}`, binary
    labels, no masks)."""

    boxes_loss = staticmethod(boxes_loss)

    def __init__(self, num_classes, matcher, weight_dict, losses,
                 mask_size: int = 28):
        self.num_classes = num_classes
        self.matcher = matcher
        self.weight_dict = weight_dict
        self.losses = losses
        self.mask_size = mask_size

    @staticmethod
    def compute_num_boxes(targets):
        """Target count over the whole update, at least 1."""
        return targets["valid"].float().sum().clamp(min=1.0)

    def expanded_weight_dict(self, num_aux: int, num_enc: int = 0
                             ) -> Dict[str, float]:
        """The weight dict with `_i` / `_enc_i` suffixed copies."""
        out = dict(self.weight_dict)
        for i in range(num_aux):
            out.update({f"{k}_{i}": v for k, v in self.weight_dict.items()})
        for i in range(num_enc):
            out.update({f"{k}_enc_{i}": v
                        for k, v in self.weight_dict.items()})
        return out

    def _eval_losses(self, outputs, targets, query_idx, valid, num_boxes,
                     n_classes, with_masks):
        out = {}
        for loss in self.losses:
            if loss == "boxes":
                out.update(self.boxes_loss(outputs, targets, query_idx, valid,
                                           num_boxes))
            elif loss == "focal_labels":
                out.update(focal_label_loss(outputs, targets, query_idx, valid,
                                            num_boxes, n_classes))
            elif loss == "masks":
                if with_masks and "pred_masks" in outputs:
                    out.update(mask_loss(outputs, targets, query_idx, valid,
                                         num_boxes, self.mask_size))
            else:
                raise ValueError(f"Unsupported loss: {loss}")
        return out

    def __call__(self, outputs, targets, num_boxes=None):
        """outputs: the model's training dict; targets: padded {labels,
        boxes, valid[, instance_masks]}; num_boxes: the global count over
        the whole update (shared by its microbatches)."""
        if num_boxes is None:
            num_boxes = self.compute_num_boxes(targets)
        losses = {}
        if outputs.get("enc_outputs") is not None:
            bin_targets = dict(targets)
            bin_targets["labels"] = torch.zeros_like(targets["labels"])
            for i, enc_out in enumerate(outputs["enc_outputs"]):
                qi, valid = self.matcher(enc_out, bin_targets)
                l_dict = self._eval_losses(enc_out, bin_targets, qi, valid,
                                           num_boxes, 1, with_masks=False)
                losses.update({f"{k}_enc_{i}": v for k, v in l_dict.items()})

        final = {k: v for k, v in outputs.items()
                 if k not in ("aux_outputs", "enc_outputs")}
        layer_outputs = list(outputs.get("aux_outputs") or []) + [final]
        qis, valids = match_layers(self.matcher, layer_outputs, targets)
        for i, aux in enumerate(layer_outputs[:-1]):
            l_dict = self._eval_losses(aux, targets, qis[i], valids[i],
                                       num_boxes, self.num_classes,
                                       with_masks=True)
            losses.update({f"{k}_{i}": v for k, v in l_dict.items()})
        losses.update(self._eval_losses(final, targets, qis[-1], valids[-1],
                                        num_boxes, self.num_classes,
                                        with_masks=True))
        losses["_query_idx"] = qis[-1]
        losses["_valid"] = valids[-1]
        return losses


class Boxer3DCriterion(Boxer2DCriterion):
    """The BoxeR-3D loss: focal labels + 3D boxes (`boxes3d_loss`) on the
    final layer, each aux layer and the encoder head (binary labels)."""

    boxes_loss = staticmethod(boxes3d_loss)


class DETRCriterion(Boxer2DCriterion):
    """The DETR loss: softmax labels (`label_loss_ce`) + boxes on the final
    layer and each aux layer; no encoder head."""

    def __init__(self, num_classes, matcher, weight_dict, losses, eos_coef,
                 iter_per_update: int = 1, *, dp):
        super().__init__(num_classes, matcher, weight_dict, losses)
        self.eos_coef = eos_coef
        self.iter_per_update = iter_per_update
        self.dp = dp                    # the run's dp axis (`parallel/mesh.py`)

    def _eval_losses(self, outputs, targets, query_idx, valid, num_boxes,
                     n_classes, with_masks):
        out = {}
        for loss in self.losses:
            if loss == "boxes":
                out.update(boxes_loss(outputs, targets, query_idx, valid,
                                      num_boxes))
            elif loss == "labels":
                out.update(label_loss_ce(outputs, targets, query_idx, valid,
                                         num_boxes, n_classes, self.eos_coef,
                                         self.iter_per_update, dp=self.dp))
            else:
                raise ValueError(f"Unsupported detr loss: {loss}")
        return out


def build_loss(loss_config, num_classes: int, iter_per_update: int = 1,
               *, dp):
    """The criterion of a model config's `loss` node (reference `build_loss`,
    `losses.py:17-74`), with its weight dict; `iter_per_update` divides
    DETR's label loss, normalised over the dp axis `dp` (the trainer's
    layout's; `Layout().dp` at world 1)."""
    loss_type = loss_config["type"]
    params = loss_config["params"]
    weight_dict = {
        "loss_ce": params["class_loss_coef"],
        "loss_bbox": params["bbox_loss_coef"],
        "loss_giou": params["giou_loss_coef"],
    }
    matcher = build_matcher(params["matcher"])
    if loss_type == "detr":
        return DETRCriterion(num_classes, matcher, weight_dict,
                             ["boxes", "labels"], eos_coef=params["eos_coef"],
                             iter_per_update=iter_per_update, dp=dp)
    if loss_type == "boxer2d":
        losses = ["boxes", "focal_labels"]
        if params.get("use_mask"):
            weight_dict["loss_mask"] = params["mask_loss_coef"]
            weight_dict["loss_dice"] = params["dice_loss_coef"]
            losses.append("masks")
        return Boxer2DCriterion(num_classes, matcher, weight_dict, losses)
    if loss_type == "boxer3d":
        weight_dict["loss_rad"] = params["rad_loss_coef"]
        return Boxer3DCriterion(num_classes, matcher, weight_dict,
                                ["boxes", "focal_labels"])
    raise ValueError(f"Unsupported loss type: {loss_type}")


def weighted_total(losses: Dict[str, torch.Tensor],
                   weight_dict: Dict[str, float]):
    """Weighted sum of the loss terms whose base name has a weight. Returns
    (total, stats) with the unweighted terms in stats."""
    total = 0.0
    stats = {}
    for k, v in losses.items():
        if k.startswith("_"):
            continue
        w = weight_dict.get(_base_key(k))
        if w is None:
            continue
        total = total + w * v
        stats[k] = v
    return total, stats


def _base_key(key: str) -> str:
    """loss_ce_enc_0 -> loss_ce; loss_bbox_3 -> loss_bbox."""
    parts = key.split("_")
    while parts and (parts[-1].isdigit() or parts[-1] == "enc"):
        parts.pop()
    return "_".join(parts)
