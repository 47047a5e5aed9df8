"""3D box utilities; port of `boxer_tpu/utils/box3d_ops.py`: the parts the
BoxeR-3D matcher, losses and postprocess use, and the corner geometry
(`rotate_points_along_z`, `boxes_to_corners_3d`,
`mask_boxes_outside_range`) that `utils/geometry.py` builds on.

Boxes are (..., 6) corner boxes (x0, y0, z0, x1, y1, z1) after
`box_cxcyczlwh_to_xyxyxy`; the GIoU is axis-aligned (it ignores the
rotation, as the reference does). Pairwise variants take (..., N, 6) and
(..., M, 6) and broadcast over the leading dims.
"""

import math

import torch


def box_cxcyczlwh_to_xyxyxy(x):
    c, d = x[..., :3], x[..., 3:6]
    return torch.cat([c - 0.5 * d, c + 0.5 * d], dim=-1)


def box_vol_wo_angle(boxes):
    return ((boxes[..., 3] - boxes[..., 0]) * (boxes[..., 4] - boxes[..., 1])
            * (boxes[..., 5] - boxes[..., 2]))


def box_iou_wo_angle(boxes1, boxes2):
    """Pairwise axis-aligned 3D IoU and union, each (..., N, M)."""
    vol1, vol2 = box_vol_wo_angle(boxes1), box_vol_wo_angle(boxes2)
    ltb = torch.maximum(boxes1[..., :, None, :3], boxes2[..., None, :, :3])
    rbf = torch.minimum(boxes1[..., :, None, 3:], boxes2[..., None, :, 3:])
    lwh = (rbf - ltb).clamp(min=0.0)
    inter = lwh[..., 0] * lwh[..., 1] * lwh[..., 2]
    union = vol1[..., :, None] + vol2[..., None, :] - inter
    return inter / union.clamp(min=1e-9), union


def generalized_box3d_iou(boxes1, boxes2):
    """Pairwise axis-aligned 3D GIoU, (..., N, M)."""
    iou, union = box_iou_wo_angle(boxes1, boxes2)
    ltb = torch.minimum(boxes1[..., :, None, :3], boxes2[..., None, :, :3])
    rbf = torch.maximum(boxes1[..., :, None, 3:], boxes2[..., None, :, 3:])
    whl = (rbf - ltb).clamp(min=0.0)
    vol = whl[..., 0] * whl[..., 1] * whl[..., 2]
    return iou - (vol - union) / vol.clamp(min=1e-9)


def elementwise_generalized_box3d_iou(boxes1, boxes2):
    """GIoU of aligned pairs; both (..., 6)."""
    vol1, vol2 = box_vol_wo_angle(boxes1), box_vol_wo_angle(boxes2)
    ltb = torch.maximum(boxes1[..., :3], boxes2[..., :3])
    rbf = torch.minimum(boxes1[..., 3:], boxes2[..., 3:])
    lwh = (rbf - ltb).clamp(min=0.0)
    inter = lwh[..., 0] * lwh[..., 1] * lwh[..., 2]
    union = vol1 + vol2 - inter
    iou = inter / union.clamp(min=1e-9)
    whl = (torch.maximum(boxes1[..., 3:], boxes2[..., 3:])
           - torch.minimum(boxes1[..., :3], boxes2[..., :3])).clamp(min=0.0)
    vol = whl[..., 0] * whl[..., 1] * whl[..., 2]
    return iou - (vol - union) / vol.clamp(min=1e-9)


def limit_period(val, offset: float = 0.5, period: float = math.pi):
    """Wrap an angle into [-offset*period, (1-offset)*period)."""
    return val - torch.floor(val / period + offset) * period


def rotate_points_along_z(points, angle):
    """points (N, P, 3+F); angle (N,). Each box's points turned about z by
    its angle (the reference's `det3d/box_ops.py:67-89`)."""
    cosa, sina = torch.cos(angle), torch.sin(angle)
    zeros, ones = torch.zeros_like(angle), torch.ones_like(angle)
    rot = torch.stack([cosa, sina, zeros, -sina, cosa, zeros, zeros, zeros,
                       ones], dim=1).reshape(-1, 3, 3)
    rotated = torch.matmul(points[..., :3], rot)
    return torch.cat([rotated, points[..., 3:]], dim=-1)


def boxes_to_corners_3d(boxes3d):
    """boxes3d (N, 7) [cx, cy, cz, l, w, h, rad] -> corners (N, 8, 3), the
    bottom face's four, then the top face's."""
    template = torch.tensor(
        [[1, -1, -1], [1, 1, -1], [-1, 1, -1], [-1, -1, -1],
         [1, -1, 1], [1, 1, 1], [-1, 1, 1], [-1, -1, 1]],
        dtype=boxes3d.dtype, device=boxes3d.device) / 2.0
    corners = boxes3d[:, None, 3:6] * template[None]
    corners = rotate_points_along_z(corners, boxes3d[:, 6])
    return corners + boxes3d[:, None, :3]


def mask_boxes_outside_range(boxes, limit_range):
    """boxes (N, 7+); limit_range [x0, y0, z0, x1, y1, z1]. (N,) bool: the
    boxes whose centre lies inside the range, borders included."""
    c = boxes[:, :3]
    lo = torch.as_tensor(limit_range[:3], dtype=c.dtype, device=c.device)
    hi = torch.as_tensor(limit_range[3:6], dtype=c.dtype, device=c.device)
    return ((c >= lo) & (c <= hi)).all(-1)
