"""General tensor utilities (PyTorch port of `boxer_tpu/utils/general.py`).

Multi-level feature maps are NHWC `(B, H, W, C)` at the public functions, as
in the JAX package; level shapes are static python tuples. The bilinear
samplers follow `F.grid_sample(align_corners=False, padding_mode='zeros')`
on NHWC images; `extract_grid` returns (B, L, gs, gs, C) RoIs.
"""

import math
from typing import List, Sequence, Tuple

import torch

Shapes = Tuple[Tuple[int, int], ...]


def inverse_sigmoid(x, eps: float = 1e-5):
    x = x.clamp(0.0, 1.0)
    x1 = x.clamp(min=eps)
    x2 = (1.0 - x).clamp(min=eps)
    return torch.log(x1 / x2)


def get_proposal_pos_embed(proposals, hidden_dim: int):
    """Sine embedding of normalized box coordinates.

    proposals: (..., K); returns (..., hidden_dim) where hidden_dim % K == 0.
    """
    k = proposals.shape[-1]
    assert hidden_dim % k == 0
    num_pos_feats = hidden_dim // k
    temperature = 10000.0
    scale = 2.0 * math.pi

    dim_t = torch.arange(num_pos_feats, dtype=torch.float32,
                         device=proposals.device)
    dim_t = temperature ** (2.0 * torch.floor(dim_t / 2.0) / num_pos_feats)
    pos = proposals[..., None] * scale / dim_t            # (..., K, F)
    pos = torch.stack([pos[..., 0::2].sin(), pos[..., 1::2].cos()], dim=-1)
    return pos.reshape(*pos.shape[:-3], hidden_dim).to(proposals.dtype)


def flatten_with_shape(tensor_list: Sequence[torch.Tensor], mask_list):
    """[(B,Hi,Wi,C)] -> (B, S, C); masks [(B,Hi,Wi)] -> (B, S); static shapes."""
    shapes: Shapes = tuple((t.shape[1], t.shape[2]) for t in tensor_list)
    flat = torch.cat(
        [t.reshape(t.shape[0], -1, t.shape[-1]) for t in tensor_list], dim=1)
    if mask_list is not None and mask_list[0] is not None:
        mask = torch.cat([m.reshape(m.shape[0], -1) for m in mask_list], dim=1)
    else:
        mask = None
    return flat, mask, shapes


def level_sizes(shapes: Shapes) -> List[int]:
    return [h * w for h, w in shapes]


def level_start_index(shapes: Shapes) -> List[int]:
    starts, acc = [], 0
    for h, w in shapes:
        starts.append(acc)
        acc += h * w
    return starts


def split_with_shape(flat, mask, shapes: Shapes):
    """(B, S, C) -> [(B, Hi*Wi, C)]; masks (B, S) -> [(B, Hi*Wi)]; either
    may be None."""
    sizes = level_sizes(shapes)
    tensors = None if flat is None else list(torch.split(flat, sizes, dim=1))
    masks = None if mask is None else list(torch.split(mask, sizes, dim=1))
    return tensors, masks


def view_with_shape(flat, mask, shapes: Shapes):
    """(B, S, C) -> [(B, Hi, Wi, C)]; masks (B, S) -> [(B, Hi, Wi)]."""
    tensors, masks = split_with_shape(flat, mask, shapes)
    if tensors is not None:
        tensors = [t.reshape(t.shape[0], h, w, t.shape[-1])
                   for t, (h, w) in zip(tensors, shapes)]
    if masks is not None:
        masks = [m.reshape(m.shape[0], h, w)
                 for m, (h, w) in zip(masks, shapes)]
    return tensors, masks


def grid_sample_nhwc(img, grid):
    """Bilinear samples with `F.grid_sample(align_corners=False,
    padding_mode='zeros')` semantics. img: (B, H, W, C); grid: (B, ..., 2)
    in [-1, 1], last dim (x, y). Returns (B, ..., C)."""
    b, h, w, c = img.shape
    g = grid.reshape(b, -1, 2)
    x = (g[..., 0] + 1.0) * (w / 2.0) - 0.5
    y = (g[..., 1] + 1.0) * (h / 2.0) - 0.5
    return _bilinear_gather(img, x, y).reshape(*grid.shape[:-1], c)


def bilinear_sample_norm01(img, loc):
    """Samples at locations in [0, 1] with the sampling kernels' convention
    `x = loc_x * W - 0.5`, zeros outside. img: (B, H, W, C); loc: (B, ...,
    2). Returns (B, ..., C)."""
    b, h, w, c = img.shape
    g = loc.reshape(b, -1, 2)
    return _bilinear_gather(img, g[..., 0] * w - 0.5,
                            g[..., 1] * h - 0.5).reshape(*loc.shape[:-1], c)


def _bilinear_gather(img, x, y):
    """Zero-padded bilinear gather. img (B, H, W, C); x, y (B, N) pixel
    coordinates. Returns (B, N, C)."""
    b, h, w, c = img.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    lx = (x - x0).to(img.dtype)[..., None]
    ly = (y - y0).to(img.dtype)[..., None]
    x0i, y0i = x0.long(), y0.long()
    flat = img.reshape(b, h * w, c)

    def tap(xi, yi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return torch.where(valid[..., None], vals, 0.0)

    top = tap(x0i, y0i) * (1.0 - lx) + tap(x0i + 1, y0i) * lx
    bot = tap(x0i, y0i + 1) * (1.0 - lx) + tap(x0i + 1, y0i + 1) * lx
    return top * (1.0 - ly) + bot * ly


def extract_grid(x, x_mask, boxes, grid_size: int = 15,
                 align_corners: bool = False, roi_align: bool = False):
    """A grid_size x grid_size RoI sampled from each box. x: (B, H, W, C);
    x_mask: (B, H, W) bool padding mask or None; boxes: (B, L, 4)
    normalized cxcywh. Returns (B, L, grid_size, grid_size, C); with
    roi_align, the max of each 2x2 block of a twice-as-fine grid."""
    from boxer_tpu_torch.utils.box_ops import box_cxcywh_to_xyxy

    b, l = boxes.shape[:2]
    gs = grid_size * 2 if roi_align else grid_size
    indices = torch.arange(gs, dtype=torch.float32, device=x.device)
    if align_corners:
        step = 1.0 / (gs - 1)
    else:
        indices, step = indices + 0.5, 1.0 / gs
    gy, gx = torch.meshgrid(indices, indices, indexing="ij")
    grid_indices = torch.stack([gx, gy], dim=-1)              # (gs, gs, 2)

    boxes = box_cxcywh_to_xyxy(boxes)
    if x_mask is not None:
        not_mask = ~x_mask
        size_h = not_mask[:, :, 0].sum(dim=1).float()
        size_w = not_mask[:, 0, :].sum(dim=1).float()
        h, w = x.shape[1:3]
        ratio = torch.stack([size_w / w, size_h / h, size_w / w, size_h / h],
                            dim=-1)
        boxes = boxes * ratio[:, None, :]
    b1 = boxes[..., None, None, :2]                            # (B, L, 1, 1, 2)
    b2 = boxes[..., None, None, 2:]
    grid = (grid_indices * step * (b2 - b1) + b1) * 2.0 - 1.0
    out = grid_sample_nhwc(x, grid)                            # (B, L, gs, gs, C)
    if roi_align:
        out = out.reshape(b, l, grid_size, 2, grid_size, 2, -1)
        out = out.amax(dim=5).amax(dim=3)
    return out


def paste_grid(seg_mask, boxes, x_size: Tuple[int, int]):
    """Per-query masks pasted back into the image. seg_mask: (L, s, s);
    boxes: (L, 4) xyxy in pixels; x_size: (H, W). Returns (L, H, W)."""
    l = boxes.shape[0]
    h, w = x_size
    x1, y1, x2, y2 = (boxes[:, i][:, None, None] for i in range(4))
    img_x = torch.arange(w, dtype=torch.float32,
                         device=boxes.device)[None, None, :] + 0.5
    img_y = torch.arange(h, dtype=torch.float32,
                         device=boxes.device)[None, :, None] + 0.5
    gx = (img_x - x1) / (x2 - x1).clamp(min=1e-6) * 2.0 - 1.0
    gy = (img_y - y1) / (y2 - y1).clamp(min=1e-6) * 2.0 - 1.0
    grid = torch.stack([gx.expand(l, h, w), gy.expand(l, h, w)], dim=-1)
    return grid_sample_nhwc(seg_mask[..., None], grid)[..., 0]


def top_k(x, k: int):
    """Top-k over the last axis, ties broken by the lower index (the
    `jax.lax.top_k` rule; `torch.topk` promises no order among ties).
    Returns (values, int64 indices), both sorted by descending value."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]
