"""General tensor utilities. Multi-level feature maps are NHWC `(B, H, W,
C)`; level shapes are static python tuples. The bilinear sampler is
`F.grid_sample(align_corners=False, padding_mode='zeros')`'s on NHWC
images, at the sampling ops' locations in [0, 1].
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


def level_start_index(shapes: Shapes) -> List[int]:
    starts, acc = [], 0
    for h, w in shapes:
        starts.append(acc)
        acc += h * w
    return starts


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


def top_k(x, k: int):
    """Top-k over the last axis, ties broken by the lower index (the
    `jax.lax.top_k` rule; `torch.topk` promises no order among ties).
    Returns (values, int64 indices), both sorted by descending value."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]
