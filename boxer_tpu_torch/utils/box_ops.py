"""2D box utilities; port of `boxer_tpu/utils/box_ops.py`. All broadcast
over leading dims."""

import torch


def box_cxcywh_to_xyxy(boxes):
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w,
                        cy + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(boxes):
    x0, y0, x1, y1 = boxes.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0],
                       dim=-1)


def box_area(boxes):
    """Area of xyxy boxes; shape (..., 4) -> (...,)."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1, boxes2):
    """Pairwise IoU of xyxy boxes: (..., N, 4), (..., M, 4) -> iou and union
    (..., N, M)."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / union.clamp(min=1e-9), union


def generalized_box_iou(boxes1, boxes2):
    """Pairwise GIoU of xyxy boxes; degenerate boxes are clamped, not
    asserted (padding boxes ride along in the fixed-shape pipeline)."""
    iou, union = box_iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area.clamp(min=1e-9)


def elementwise_box_iou(boxes1, boxes2):
    """IoU of aligned box pairs; both (..., 4) xyxy -> iou and union
    (...,)."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    return inter / union.clamp(min=1e-9), union


def elementwise_generalized_box_iou(boxes1, boxes2):
    """GIoU of aligned box pairs; both (..., 4) xyxy -> (...,)."""
    iou, union = elementwise_box_iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area.clamp(min=1e-9)


def masks_to_boxes(masks):
    """Bounding xyxy boxes of binary masks (N, H, W) -> (N, 4) f32; an
    empty mask gives a zero box."""
    n, h, w = masks.shape
    ys = torch.arange(h, dtype=torch.float32, device=masks.device)[None, :,
                                                                    None]
    xs = torch.arange(w, dtype=torch.float32, device=masks.device)[None,
                                                                    None, :]
    big = 1e8
    m = masks.float()
    on = m > 0
    x_min = torch.where(on, xs, big).amin(dim=(1, 2))
    x_max = torch.where(on, xs, -big).amax(dim=(1, 2)) + 1
    y_min = torch.where(on, ys, big).amin(dim=(1, 2))
    y_max = torch.where(on, ys, -big).amax(dim=(1, 2)) + 1
    boxes = torch.stack([x_min, y_min, x_max, y_max], dim=-1)
    return torch.where((m.sum(dim=(1, 2)) > 0)[:, None], boxes,
                       torch.zeros_like(boxes))
