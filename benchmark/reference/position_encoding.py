"""Box-shaped sine position encodings. Pure functions over NHWC-shaped
features: only `x.shape[:3]` and the padding mask are read."""

from typing import Optional

import torch

from .general import get_proposal_pos_embed

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


def fixed_box_embedding(x, mask: Optional[torch.Tensor], hidden_dim: int,
                        ref_size: int = 4):
    """Box-shaped PE: the sine embedding of each pixel's reference-box
    centre plus that of its size (two 2-variable embeddings summed, as the
    reference does). Returns (B, H, W, hidden_dim) f32."""
    win = box_windows(x, mask, ref_size)
    return (get_proposal_pos_embed(win[..., :2], hidden_dim)
            + get_proposal_pos_embed(win[..., 2:], hidden_dim))
