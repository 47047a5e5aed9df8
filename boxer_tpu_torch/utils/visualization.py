"""Drawing of 2D boxes and masks and of 3D boxes in bird's-eye view (PIL
and numpy, headless); the port's copy of `boxer_tpu/utils/visualization.py`
(the reference's `e2edet/utils/visualization.py` and
`e2edet/utils/det3d/visualization.py`).
"""

import colorsys
from typing import Dict, List, Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw, ImageFont


def _palette(n: int) -> List[tuple]:
    return [
        tuple(int(255 * c) for c in colorsys.hsv_to_rgb(i / max(n, 1), 0.8, 0.95))
        for i in range(n)
    ]


def draw_boxes(image: np.ndarray, boxes: np.ndarray, labels=None, scores=None,
               class_names: Optional[Sequence[str]] = None,
               score_threshold: float = 0.3, width: int = 2) -> np.ndarray:
    """image: (H, W, 3) uint8; boxes: (N, 4) xyxy absolute. Returns drawn copy."""
    img = Image.fromarray(image.astype(np.uint8)).convert("RGB")
    draw = ImageDraw.Draw(img)
    n = len(boxes)
    colors = _palette(max(int(labels.max()) + 1 if labels is not None and n else 1, 1))
    for i in range(n):
        if scores is not None and scores[i] < score_threshold:
            continue
        color = colors[int(labels[i]) % len(colors)] if labels is not None else (255, 0, 0)
        x1, y1, x2, y2 = [float(v) for v in boxes[i]]
        draw.rectangle([x1, y1, x2, y2], outline=color, width=width)
        caption = ""
        if labels is not None:
            caption = (class_names[int(labels[i])]
                       if class_names is not None else str(int(labels[i])))
        if scores is not None:
            caption += f" {scores[i]:.2f}"
        if caption:
            draw.text((x1 + 2, max(y1 - 12, 0)), caption, fill=color)
    return np.asarray(img)


def draw_masks(image: np.ndarray, masks: np.ndarray, labels=None,
               alpha: float = 0.45) -> np.ndarray:
    """image (H, W, 3) uint8; masks (N, H, W) bool. Alpha-blended overlay."""
    out = image.astype(np.float32).copy()
    n = len(masks)
    colors = _palette(max(int(labels.max()) + 1 if labels is not None and n else n, 1))
    for i in range(n):
        color = np.asarray(
            colors[int(labels[i]) % len(colors)] if labels is not None
            else colors[i % len(colors)], np.float32)
        m = masks[i].astype(bool)
        out[m] = out[m] * (1 - alpha) + color * alpha
    return out.astype(np.uint8)


def draw_bev_boxes(boxes3d: np.ndarray, pc_range, canvas_size: int = 800,
                   labels=None, scores=None, points: Optional[np.ndarray] = None,
                   gt_boxes3d: Optional[np.ndarray] = None) -> np.ndarray:
    """Bird's-eye-view plot. boxes3d (N, 7) [x,y,z,l,w,h,rad] metric;
    pc_range [x0,y0,z0,x1,y1,z1]. Returns (canvas, canvas, 3) uint8."""
    pc_range = np.asarray(pc_range, np.float32)
    img = Image.new("RGB", (canvas_size, canvas_size), (10, 10, 14))
    draw = ImageDraw.Draw(img)

    def to_px(xy):
        u = (xy[..., 0] - pc_range[0]) / (pc_range[3] - pc_range[0])
        v = (xy[..., 1] - pc_range[1]) / (pc_range[4] - pc_range[1])
        return np.stack([u * canvas_size, (1 - v) * canvas_size], -1)

    if points is not None and len(points):
        px = to_px(points[:, :2]).astype(int)
        keep = ((px >= 0) & (px < canvas_size)).all(1)
        for x, y in px[keep][::max(1, len(px) // 20000)]:
            draw.point((int(x), int(y)), fill=(60, 60, 80))

    def corners_bev(b):
        l, w, rad = b[3] / 2, b[4] / 2, b[6]
        t = np.array([[l, w], [l, -w], [-l, -w], [-l, w]])
        c, s = np.cos(rad), np.sin(rad)
        rot = np.array([[c, -s], [s, c]])
        return (t @ rot.T) + b[:2]

    if gt_boxes3d is not None:
        for b in gt_boxes3d:
            pts = to_px(corners_bev(b))
            draw.polygon([tuple(p) for p in pts], outline=(80, 220, 80))

    if boxes3d is not None:
        colors = _palette(8)
        for i, b in enumerate(boxes3d):
            if scores is not None and scores[i] < 0.3:
                continue
            color = colors[int(labels[i]) % 8] if labels is not None else (255, 80, 80)
            pts = to_px(corners_bev(b))
            draw.polygon([tuple(p) for p in pts], outline=color)
    return np.asarray(img)
