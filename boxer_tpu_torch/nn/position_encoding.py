"""Position encodings (sine / box-sine); port of
`boxer_tpu/nn/position_encoding.py`. Pure functions over NHWC-shaped
features: only `x.shape[:3]` and the padding mask are read."""

import math
from typing import Optional

import torch

from boxer_tpu_torch.utils.general import get_proposal_pos_embed

EPS = 1e-6


def _embeds(x, mask):
    """Mask-aware cumulative pixel coordinates (y_embed, x_embed) and the
    valid extents (size_h, size_w), all f32."""
    b, h, w = x.shape[:3]
    if mask is not None:
        not_mask = (~mask).float()
        y_embed = not_mask.cumsum(dim=1)
        x_embed = not_mask.cumsum(dim=2)
        size_h = not_mask[:, :, 0].sum(dim=-1)
        size_w = not_mask[:, 0, :].sum(dim=-1)
    else:
        dev = x.device
        y_embed = torch.arange(1, h + 1, dtype=torch.float32,
                               device=dev)[None, :, None].expand(b, h, w)
        x_embed = torch.arange(1, w + 1, dtype=torch.float32,
                               device=dev)[None, None, :].expand(b, h, w)
        size_h = torch.full((b,), float(h), device=dev)
        size_w = torch.full((b,), float(w), device=dev)
    return y_embed, x_embed, size_h, size_w


def box_windows(x, mask: Optional[torch.Tensor], ref_size: int):
    """Per-pixel reference boxes (B, H, W, 4) normalized cxcywh f32: the
    pixel centre within the valid (unpadded) extent, and ref_size / that
    extent as the size. Shared by `fixed_box_embedding` and the
    transformer's `create_ref_windows_2d`."""
    b, h, w = x.shape[:3]
    y_embed, x_embed, size_h, size_w = _embeds(x, mask)
    cy = (y_embed - 0.5) / (y_embed[:, -1:, :] + EPS)
    cx = (x_embed - 0.5) / (x_embed[:, :, -1:] + EPS)
    size = torch.stack([ref_size / size_w, ref_size / size_h], dim=-1)
    return torch.cat([torch.stack([cx, cy], dim=-1),
                      size[:, None, None, :].expand(b, h, w, 2)], dim=-1)


def fixed_position_embedding(x, mask: Optional[torch.Tensor],
                             num_pos_feats: int):
    """DETR sine embedding of the normalized pixel centre. x: (B, H, W, C);
    mask: (B, H, W) bool (True = padding) or None. Returns
    (B, H, W, 2*num_pos_feats) f32, x channels first."""
    b, h, w = x.shape[:3]
    scale = 2.0 * math.pi
    y_embed, x_embed, _, _ = _embeds(x, mask)
    y_embed = (y_embed - 0.5) / (y_embed[:, -1:, :] + EPS) * scale
    x_embed = (x_embed - 0.5) / (x_embed[:, :, -1:] + EPS) * scale

    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=x.device)
    dim_t = 10000.0 ** (2.0 * torch.floor(dim_t / 2.0) / num_pos_feats)
    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()],
                        dim=-1).reshape(b, h, w, num_pos_feats)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()],
                        dim=-1).reshape(b, h, w, num_pos_feats)
    return torch.cat([pos_x, pos_y], dim=-1)


def fixed_box_embedding(x, mask: Optional[torch.Tensor], hidden_dim: int,
                        ref_size: int = 4):
    """Box-shaped PE: the sine embedding of each pixel's reference-box
    centre plus that of its size (two 2-variable embeddings summed, as the
    reference does). Returns (B, H, W, hidden_dim) f32."""
    win = box_windows(x, mask, ref_size)
    return (get_proposal_pos_embed(win[..., :2], hidden_dim)
            + get_proposal_pos_embed(win[..., 2:], hidden_dim))


def build_position_encoding(kind: str, hidden_dim: int):
    """`fn(x, mask, ref_size)` for the config's encoding kind."""
    if kind == "fixed":
        n = hidden_dim // 2

        def fn(x, mask, ref_size=None):
            return fixed_position_embedding(x, mask, n)

        return fn
    if kind == "fixed_box":

        def fn(x, mask, ref_size=4):
            return fixed_box_embedding(x, mask, hidden_dim, ref_size)

        return fn
    raise ValueError(f"Unknown position encoding type: {kind}")
