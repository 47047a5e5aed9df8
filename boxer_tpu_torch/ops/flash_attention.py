"""Online-softmax attention forward (K3).

PyTorch port of `boxer_tpu/ops/pallas/flash_attention.py`. `flash_attention`
launches the CUDA kernel (`boxer_tpu_torch/csrc/flash_attention.cu`) on CUDA
tensors and runs `flash_attention_plain` on CPU tensors.
"""

import math
from typing import Optional

import torch

from boxer_tpu_torch.ops import _build

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def flash_attention_plain(q, k, v, mask=None, sm_scale=None):
    """softmax(q kᵀ * scale + mask) v in f32; output in q's dtype."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
    if mask is not None:
        s = s + mask[:, None, :].float()
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def flash_attention(q, k, v, mask: Optional[torch.Tensor] = None,
                    sm_scale: Optional[float] = None):
    """q: (BH, Lq, D); k, v: (BH, Lkv, D); mask: (BH, Lkv) additive f32
    (0 = attend, NEG_INF = masked) or None. Returns (BH, Lq, D) in q's dtype.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask, sm_scale)
    if not q.is_cuda:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    bh, lq, d = q.shape
    lkv = k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if d != 32:
        raise ValueError(f"flash_attention: head dim {d} (the kernel takes 32)")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attention: dtype {q.dtype}")
    for t, shp in ((k, (bh, lkv, d)), (v, (bh, lkv, d))):
        if tuple(t.shape) != shp or t.dtype != q.dtype:
            raise ValueError("flash_attention: k/v shape or dtype mismatch")
    if mask is not None and (tuple(mask.shape) != (bh, lkv)
                             or mask.dtype != torch.float32):
        raise ValueError("flash_attention: mask must be (BH, Lkv) f32")
    for t in (q, k, v) + ((mask,) if mask is not None else ()):
        if t.device != q.device:
            raise ValueError("flash_attention: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError("flash_attention: tensors must be contiguous")
    out = torch.empty_like(q)
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_fwd(
            q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            mask.data_ptr() if mask is not None else None, out.data_ptr(),
            int(q.dtype == torch.bfloat16), bh, lq, lkv, d, float(sm_scale),
            stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
