"""BoxTransformer (2D), the segm inference forward: the encoder, the
proposals, the decoder, and the deferred top-k mask decode.

Module names follow the port's state dict (`transformer.encoder.layers.{i}`,
`transformer.encoder.enc_linear.{0,1}`, `transformer.decoder.layers.{i}.
{self_attn,multihead_attn}`). The encoder proposal head (`enc_detector`)
sits at the top of the model, so the transformer takes it as an argument.
"""

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .attention import BoxAttention, InstanceAttention
from .dense_attention import MultiHeadAttention
from .follow import Follow, take_topk
from .general import (flatten_with_shape, get_proposal_pos_embed,
                      inverse_sigmoid, top_k)
from .position_encoding import box_windows
from .postprocess import paste_and_rescore, select_topk
from .predictor import NEG_INF

Shapes = Tuple[Tuple[int, int], ...]
LN_EPS = 1e-6       # flax LayerNorm's epsilon


def create_ref_windows_2d(tensor_list, mask_list, ref_size: int):
    """Per-pixel reference boxes across levels, (B, S, 4) normalized cxcywh
    f32. tensor_list: NHWC features; mask_list: (B, H, W) bool or None."""
    wins = [box_windows(t, None if mask_list is None else mask_list[i],
                        ref_size) for i, t in enumerate(tensor_list)]
    return torch.cat([w.reshape(w.shape[0], -1, 4) for w in wins], dim=1)


def create_valid_ratios(mask_list):
    """(B, L, 2) per-level [ratio_w, ratio_h] f32; None without masks."""
    if mask_list is None or mask_list[0] is None:
        return None
    ratios = []
    for mask in mask_list:
        not_mask = ~mask
        h, w = mask.shape[1:3]
        size_h = not_mask[:, :, 0].sum(dim=-1).float()
        size_w = not_mask[:, 0, :].sum(dim=-1).float()
        ratios.append(torch.stack([size_w / w, size_h / h], dim=-1))
    return torch.stack(ratios, dim=1)


def _ffn(layer, x):
    return layer.linear2(F.relu(layer.linear1(x)))


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, nlevel: int,
                 dim_feedforward: int):
        super().__init__()
        self.self_attn = BoxAttention(d_model, nlevel, nhead)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, src, pos, v_shape: Shapes, src_mask, valid_ratios,
                ref_windows):
        q = src if pos is None else src + pos
        src2 = self.self_attn(q, src, v_shape, src_mask, valid_ratios,
                              ref_windows)
        src = self.norm1(src + src2)
        return self.norm2(src + _ffn(self, src))


class DecoderLayer(nn.Module):
    """Decoder layer of a segm model (instance attention). With emit_roi
    it returns, beside its output, the raw RoI and the residual carriers
    that `decode_roi` finishes on the selected queries."""

    def __init__(self, d_model: int, nhead: int, nlevel: int,
                 dim_feedforward: int, residual_mode: str = "v1"):
        super().__init__()
        assert residual_mode in ("v1", "v2")
        self.residual_mode = residual_mode
        self.self_attn = MultiHeadAttention(d_model, nhead)
        self.multihead_attn = InstanceAttention(d_model, nlevel, nhead,
                                                kernel_size=14)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)

    def forward(self, tgt, query_pos, memory, v_shape: Shapes, memory_mask,
                valid_ratios, ref_windows, emit_roi: bool = False):
        q = k = tgt if query_pos is None else tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(q, k, tgt))
        q2 = tgt if query_pos is None else tgt + query_pos
        tgt2, roi = self.multihead_attn(q2, memory, v_shape, memory_mask,
                                        valid_ratios, ref_windows,
                                        emit_roi=emit_roi)
        tgt = self.norm2(tgt + tgt2)
        tgt_norm2 = tgt
        tgt = self.norm3(tgt + _ffn(self, tgt))
        return tgt, (roi, tgt_norm2, tgt) if emit_roi else None

    def decode_roi(self, mask_out_sel, tgt_norm2_sel, tgt_final_sel):
        """RoI tail on a selected-query subset: mask_out_sel (B, K, k, k,
        H*Ch) raw RoI rows; tgt_norm2_sel / tgt_final_sel (B, K, C) the same
        layer's post-norm2 / final outputs at those queries."""
        roi = self.multihead_attn.project_roi(mask_out_sel)
        roi = self.norm2(tgt_norm2_sel[:, :, None, None, :] + roi)
        if self.residual_mode == "v1":
            roi = roi + _ffn(self, roi)
        else:
            roi = tgt_final_sel[:, :, None, None, :] + roi
        return self.norm3(roi)


class _Encoder(nn.Module):
    def __init__(self, d_model, nhead, nlevel, dim_feedforward, num_layers):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, nhead, nlevel, dim_feedforward)
            for _ in range(num_layers))
        self.enc_linear = nn.Sequential(nn.Linear(d_model, d_model),
                                        nn.LayerNorm(d_model, eps=LN_EPS))


class _Decoder(nn.Module):
    def __init__(self, d_model, nhead, nlevel, dim_feedforward, num_layers,
                 residual_mode):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, nhead, nlevel, dim_feedforward,
                         residual_mode) for _ in range(num_layers))


class BoxTransformer(Follow, nn.Module):
    def __init__(self, d_model: int = 256, nhead: int = 8, nlevel: int = 4,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 1024, num_queries: int = 300,
                 ref_size: int = 4, residual_mode: str = "v1"):
        super().__init__()
        self.d_model, self.num_queries = d_model, num_queries
        self.ref_size = ref_size
        self.forced, self.seen = {}, {}
        self.encoder = _Encoder(d_model, nhead, nlevel, dim_feedforward,
                                num_encoder_layers)
        self.decoder = _Decoder(d_model, nhead, nlevel, dim_feedforward,
                                num_decoder_layers, residual_mode)

    def _get_enc_proposals(self, enc_detector, output, src_mask, ref_windows):
        """Top-num_queries proposal selection. Returns (decoder embed,
        decoder ref windows f32, decoder pos)."""
        valid = ((ref_windows[..., :2] > 0.01)
                 & (ref_windows[..., :2] < 0.99)).all(-1)
        mask = ~valid if src_mask is None else src_mask | ~valid
        out_logits = enc_detector.class_embed(output)[..., 0].float()
        out_logits = out_logits.masked_fill(mask, NEG_INF)
        _, indexes = top_k(out_logits, self.num_queries)         # (B, nq)
        indexes = self.follow("proposals", indexes, out_logits)

        def gather(arr):
            return torch.gather(
                arr, 1, indexes[..., None].expand(-1, -1, arr.shape[-1]))

        output_embed = gather(output)
        out_embed = self.encoder.enc_linear(output_embed)
        tmp_ref = enc_detector.bbox_embed(output_embed).float()
        out_ref_windows = torch.sigmoid(tmp_ref + inverse_sigmoid(
            gather(ref_windows)))
        pos = get_proposal_pos_embed(out_ref_windows[..., :2], self.d_model)
        size = get_proposal_pos_embed(out_ref_windows[..., 2:], self.d_model)
        return out_embed, out_ref_windows, (pos + size).to(output.dtype)

    def _decode_topk_masks(self, detector, last_layer, deferred, tgt,
                           dec_ref_windows, postprocess: dict):
        """Deferred mask decode: logits/boxes on all queries, top-k
        selection, then the RoI tail, mask head and paste on the selected
        queries only."""
        mask_out_raw, tgt_norm2, tgt_final = deferred
        logits, boxes = detector(tgt, dec_ref_windows)           # (B, NQ, ·)
        scores, labels, q, xy = select_topk(
            logits, boxes, canvas_hw=postprocess["canvas_hw"],
            topk=postprocess.get("topk", 100))
        q, labels = self.follow("topk", (q, labels), logits)
        scores, xy = take_topk(logits, boxes, q, labels,
                               postprocess["canvas_hw"])

        def gather_q(x):
            idx = q.reshape(q.shape + (1,) * (x.dim() - 2))
            return torch.gather(x, 1, idx.expand(q.shape + x.shape[2:]))

        roi = last_layer.decode_roi(gather_q(mask_out_raw), gather_q(tgt_norm2),
                                    gather_q(tgt_final))
        # mask_v1: the class channel at the argmax of the FULL class row
        top = gather_q(logits).argmax(dim=-1)                    # (B, K)
        top = self.follow("mask_class", top, gather_q(logits))
        mask_logits = detector.mask_embed(roi[None], select=top.reshape(-1))[0]
        self.seen["mask_logits"] = mask_logits
        scores, masks = paste_and_rescore(scores, mask_logits, xy,
                                          postprocess["canvas_hw"])
        return {"scores": scores, "labels": labels, "boxes": xy,
                "masks": masks}

    def forward(self, srcs: Sequence[torch.Tensor], masks, pos_list,
                enc_detector, detector, postprocess: dict):
        """srcs: list of (B, Hi, Wi, C); masks: list of (B, Hi, Wi) bool or
        None; pos_list: list of (B, Hi, Wi, C). Returns {scores, labels,
        boxes, masks} of the deferred top-k mask decode."""
        if masks is not None and masks[0] is None:
            masks = None
        src_ref_windows = create_ref_windows_2d(srcs, masks, self.ref_size)
        valid_ratios = create_valid_ratios(masks)
        src, src_mask, v_shape = flatten_with_shape(srcs, masks)
        output = src
        src_pos = torch.cat([p.reshape(p.shape[0], -1, p.shape[-1])
                             for p in pos_list], dim=1)
        for layer in self.encoder.layers:
            output = layer(output, src_pos, v_shape, src_mask, valid_ratios,
                           src_ref_windows)

        tgt, dec_ref_windows, dec_pos = self._get_enc_proposals(
            enc_detector, output, src_mask, src_ref_windows)
        layers = self.decoder.layers
        for i, layer in enumerate(layers):
            tgt, deferred = layer(tgt, dec_pos, output, v_shape, src_mask,
                                  valid_ratios, dec_ref_windows,
                                  emit_roi=i == len(layers) - 1)
        return self._decode_topk_masks(detector, layers[-1], deferred, tgt,
                                       dec_ref_windows, postprocess)
