"""On-device COCO detection / instance-segmentation postprocess; port of
`boxer_tpu/evaluate/postprocess.py`: top-k over (query x class) sigmoid
scores, box rescale to pixels, mask paste as two batched matmuls with
bilinear tent matrices, and mask-score rescoring. All in f32."""

from typing import Optional, Tuple

import torch

from boxer_tpu_torch.utils.general import top_k


def _tent_matrix(starts, ends, out_size: int, in_size: int):
    """(N, out_size, in_size) matrix R with R @ mask = the mask resampled
    into the pixel range [start, end) of an out_size axis, exactly the
    align_corners=False zero-padded grid_sample of `paste_grid`:
    R[n, i, j] = max(0, 1 - |v_i(n) - j|),
    v_i = ((i + 0.5) - start) / (end - start) * in_size - 0.5."""
    dev = starts.device
    i = torch.arange(out_size, dtype=torch.float32, device=dev)[None, :, None]
    j = torch.arange(in_size, dtype=torch.float32, device=dev)[None, None, :]
    span = (ends - starts).clamp(min=1e-6)[:, None, None]
    v = ((i + 0.5) - starts[:, None, None]) / span * in_size - 0.5
    return (1.0 - (v - j).abs()).clamp(min=0.0)


def paste_masks_mxu(masks, boxes_xy, canvas_hw: Tuple[int, int]):
    """Paste (N, s, s) masks into (N, H, W) canvases at xyxy pixel boxes."""
    h, w = canvas_hw
    s = masks.shape[-1]
    ry = _tent_matrix(boxes_xy[:, 1], boxes_xy[:, 3], h, s)        # (N,H,s)
    rx = _tent_matrix(boxes_xy[:, 0], boxes_xy[:, 2], w, s)        # (N,W,s)
    tmp = torch.bmm(ry, masks.float())                             # (N,H,s)
    return torch.bmm(tmp, rx.transpose(1, 2))                      # (N,H,W)


def select_topk(logits, boxes, *, canvas_hw: Tuple[int, int],
                topk: int = 100, scale: Optional[torch.Tensor] = None):
    """Top-k (query, class) selection + box rescale. Returns (scores (B,K),
    labels (B,K), q (B,K) query indices, boxes (B,K,4) xyxy pixels)."""
    prob = torch.sigmoid(logits.float())
    b, nq, c = prob.shape
    scores, idx = top_k(prob.reshape(b, nq * c), min(topk, nq * c))
    q = idx // c
    labels = idx % c
    bx = torch.gather(boxes.float(), 1, q[..., None].expand(-1, -1, 4))
    xy = torch.cat([bx[..., :2] - bx[..., 2:] * 0.5,
                    bx[..., :2] + bx[..., 2:] * 0.5], dim=-1)
    h, w = canvas_hw
    if scale is None:
        scale = torch.tensor([w, h, w, h], dtype=torch.float32,
                             device=xy.device)
    return scores, labels, q, xy * scale


def paste_and_rescore(scores, mask_logits, boxes_xy,
                      canvas_hw: Tuple[int, int]):
    """Paste selected-query mask logits (B, K, s, s) at the xyxy pixel boxes
    and rescore. Returns (scores (B,K), masks (B,K,H,W) bool)."""
    m = torch.sigmoid(mask_logits.float())
    pasted = torch.stack([paste_masks_mxu(mm, bb, canvas_hw)
                          for mm, bb in zip(m, boxes_xy)])
    binary = pasted >= 0.5
    denom = binary.sum(dim=(-1, -2)).float().clamp(min=1.0)
    mask_scores = (pasted * binary).sum(dim=(-1, -2)) / denom
    return scores * mask_scores, binary


def coco_postprocess(logits, boxes, mask_logits=None, *,
                     canvas_hw: Tuple[int, int], topk: int = 100,
                     scale: Optional[torch.Tensor] = None):
    """logits (B, NQ, C) raw class logits; boxes (B, NQ, 4) normalized
    cxcywh; mask_logits (B, NQ, s, s) or None. Returns scores (B, K), labels
    (B, K), boxes (B, K, 4) xyxy pixels and, with mask_logits, masks
    (B, K, H, W) bool with mask-rescored scores."""
    scores, labels, q, xy = select_topk(logits, boxes, canvas_hw=canvas_hw,
                                        topk=topk, scale=scale)
    out = {"scores": scores, "labels": labels, "boxes": xy}
    if mask_logits is not None:
        s = mask_logits.shape[-1]
        m_sel = torch.gather(mask_logits, 1,
                             q[:, :, None, None].expand(-1, -1, s, s))
        out["scores"], out["masks"] = paste_and_rescore(scores, m_sel, xy,
                                                        canvas_hw)
    return out
