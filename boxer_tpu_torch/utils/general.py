"""General tensor utilities (PyTorch port of `boxer_tpu/utils/general.py`).

Multi-level feature maps are NHWC `(B, H, W, C)` at the public functions, as
in the JAX package; level shapes are static python tuples.
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


def top_k(x, k: int):
    """Top-k over the last axis, ties broken by the lower index (the
    `jax.lax.top_k` rule; `torch.topk` promises no order among ties).
    Returns (values, int64 indices), both sorted by descending value."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]
