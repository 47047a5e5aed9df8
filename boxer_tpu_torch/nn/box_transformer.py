"""BoxTransformer (2D), inference and training; port of
`boxer_tpu/nn/box_transformer.py`.

Module names follow the reference e2edet state_dict
(`transformer.encoder.layers.{i}`, `transformer.encoder.enc_linear.{0,1}`,
`transformer.decoder.layers.{i}.{self_attn,multihead_attn}`); the encoder is
an `nn.ModuleList` where the JAX package scans one layer. The encoder
proposal head (`enc_detector`) sits at the top of the reference model, so
the transformer takes it as an argument instead of owning it.

Dropout: the JAX package's sites (`boxer_tpu/nn/box_transformer.py:125-131`
in the encoder layer, `:180-200` in the decoder layer, and the decoder's
self-attention probabilities), each drawn from the train step's dropout
key (`nn/dropout.py`); without a key (eval, inference) none is drawn.

Remat (`remat`, on by default, as JAX's `:261-264`): in training each
encoder layer, and each decoder layer of a segm model, runs under
`torch.utils.checkpoint` (non-reentrant) with a selective policy: its
`context_fn` keeps the sampling outputs (`ops/box_attention.py:
keeping_samples`, JAX's `save_only_these_names("box_attn_sample"[,
"instance_attn_sample"])`, `:401-405`, `:450-453`) and everything else is
recomputed in the backward. The recompute replays the layer's dropout
masks (they are a function of the key) and does not launch K2 again; the
decoder's K3 runs again, as JAX's flash attention does under its remat.

Tensor parallel (`parallel/sharding.py:shard_model`): each layer's
attention runs this rank's heads and its FFN this rank's hidden features
(`linear1` column-, `linear2` row-parallel). Sequence parallel (`seq_shard`,
JAX's `:386-392`, `:421-422`): with the sp axis set (`sp`), the encoder
runs this rank's slice of the flattened tokens (padded to a multiple of
sp; the pad never reaches a value table, a proposal or a loss), each box
attention gathering its projected value over sp, and its output is
gathered at the exit; proposals, the decoder and the heads run on the
whole sequence on every sp rank. Under remat the recompute gathers the
value again.
"""

import functools
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from boxer_tpu_torch.evaluate.postprocess import paste_and_rescore, select_topk
from boxer_tpu_torch.nn.attention import BoxAttention, InstanceAttention
from boxer_tpu_torch.nn.dense_attention import PallasMultiHeadAttention
from boxer_tpu_torch.nn.dropout import Dropout
from boxer_tpu_torch.nn.position_encoding import box_windows
from boxer_tpu_torch.nn.predictor import NEG_INF
from boxer_tpu_torch.ops.box_attention import keeping_samples
from boxer_tpu_torch.parallel.collectives import (RowLinear, Tokens,
                                                  feed_forward, gather_tokens,
                                                  slice_tokens)
from boxer_tpu_torch.utils.general import (flatten_with_shape,
                                           get_proposal_pos_embed,
                                           inverse_sigmoid, top_k)

Shapes = Tuple[Tuple[int, int], ...]
LN_EPS = 1e-6       # flax LayerNorm's epsilon


def remat(fn, *args, **kwargs):
    """fn(*args, **kwargs) under non-reentrant checkpoint, the sampling
    outputs of its forward kept for its recompute."""
    kept = []
    return checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (keeping_samples(kept, False),
                            keeping_samples(kept, True)),
        **kwargs)


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


class EncoderLayer(nn.Module):
    tp = None

    def __init__(self, d_model: int, nhead: int, nlevel: int,
                 dim_feedforward: int, dropout: float = 0.0):
        super().__init__()
        self.self_attn = BoxAttention(d_model, nlevel, nhead)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = RowLinear(dim_feedforward, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dropout = Dropout(dropout)

    def forward(self, src, pos, v_shape: Shapes, src_mask, valid_ratios,
                ref_windows, fold=None, key=None, tokens=None):
        """tokens: src, pos, src_mask and ref_windows hold this rank's
        slice of the token axis (sequence parallel)."""
        parts = () if tokens is None else ((1, tokens.start, tokens.n),)
        drop = functools.partial(self.dropout, key=key, parts=parts)
        q = src if pos is None else src + pos
        src2, _ = self.self_attn(q, src, v_shape, src_mask, valid_ratios,
                                 ref_windows, fold=fold, tokens=tokens)
        src = self.norm1(src + drop(src2, index=0))
        src2 = feed_forward(self, src, key, 1, parts)
        return self.norm2(src + drop(src2, index=2))


class DecoderLayer(nn.Module):
    """Decoder layer. emit_roi: False (no RoI), True (full RoI) or "defer"
    (the raw RoI and the residual carriers are returned, and `decode_roi`
    runs the RoI tail on a selected-query subset). train=True takes box
    attention's training path (not folded); instance attention takes its
    differentiable path wherever autograd needs a gradient."""
    tp = None

    def __init__(self, d_model: int, nhead: int, nlevel: int,
                 dim_feedforward: int, use_mask: bool,
                 residual_mode: str = "v1", dropout: float = 0.0):
        super().__init__()
        assert residual_mode in ("v1", "v2")
        self.use_mask, self.residual_mode = use_mask, residual_mode
        self.self_attn = PallasMultiHeadAttention(d_model, nhead, dropout)
        self.multihead_attn = (
            InstanceAttention(d_model, nlevel, nhead, kernel_size=14)
            if use_mask else BoxAttention(d_model, nlevel, nhead))
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = RowLinear(dim_feedforward, d_model)
        self.dropout = Dropout(dropout)

    def _ffn(self, x, key=None, index: int = 0):
        """linear2(drop(relu(linear1(x)))), draw `index` inside."""
        return feed_forward(self, x, key, index)

    def forward(self, tgt, query_pos, memory, v_shape: Shapes, memory_mask,
                valid_ratios, ref_windows, emit_roi=False, train: bool = False,
                key=None):
        defer = emit_roi == "defer"
        drop = functools.partial(self.dropout, key=key)
        q = k = tgt if query_pos is None else tgt + query_pos
        tgt = self.norm1(tgt + drop(self.self_attn(q, k, tgt,
                                                   dropout_key=key), index=0))

        roi = None
        q2 = tgt if query_pos is None else tgt + query_pos
        if self.use_mask:
            tgt2, roi, _ = self.multihead_attn(
                q2, memory, v_shape, memory_mask, valid_ratios, ref_windows,
                emit_roi=bool(emit_roi), raw_roi=defer)
        else:
            tgt2, _ = self.multihead_attn(
                q2, memory, v_shape, memory_mask, valid_ratios, ref_windows,
                fold=None if train else True)

        tgt = self.norm2(tgt + drop(tgt2, index=1))
        tgt_norm2 = tgt
        if roi is not None and not defer:
            roi = self.norm2(tgt[:, :, None, None, :] + drop(roi, index=2))
        tgt = self.norm3(tgt + drop(self._ffn(tgt, key, 3), index=4))
        if roi is not None and not defer:
            if self.residual_mode == "v1":
                roi = roi + drop(self._ffn(roi, key, 5), index=6)
            else:
                roi = tgt[:, :, None, None, :] + drop(roi, index=7)
            roi = self.norm3(roi)
        if defer:
            return tgt, (roi, tgt_norm2, tgt)
        return tgt, roi

    def decode_roi(self, mask_out_sel, tgt_norm2_sel, tgt_final_sel):
        """RoI tail on a selected-query subset: mask_out_sel (B, K, k, k,
        H*Ch) raw RoI rows; tgt_norm2_sel / tgt_final_sel (B, K, C) the same
        layer's post-norm2 / final outputs at those queries. Per-query ops
        only, so the result equals the full RoI path gathered at the subset."""
        roi = self.multihead_attn.project_roi(mask_out_sel)
        roi = self.norm2(tgt_norm2_sel[:, :, None, None, :] + roi)
        if self.residual_mode == "v1":
            roi = roi + self._ffn(roi)
        else:
            roi = tgt_final_sel[:, :, None, None, :] + roi
        return self.norm3(roi)


class _Encoder(nn.Module):
    def __init__(self, d_model, nhead, nlevel, dim_feedforward, num_layers,
                 dropout):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, nhead, nlevel, dim_feedforward, dropout)
            for _ in range(num_layers))
        self.enc_linear = nn.Sequential(nn.Linear(d_model, d_model),
                                        nn.LayerNorm(d_model, eps=LN_EPS))


class _Decoder(nn.Module):
    def __init__(self, d_model, nhead, nlevel, dim_feedforward, num_layers,
                 use_mask, residual_mode, dropout):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, nhead, nlevel, dim_feedforward, use_mask,
                         residual_mode, dropout) for _ in range(num_layers))


class BoxTransformer(nn.Module):
    def __init__(self, d_model: int = 256, nhead: int = 8, nlevel: int = 4,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 1024, num_queries: int = 300,
                 use_mask: bool = False, ref_size: int = 4,
                 residual_mode: str = "v1", dropout: float = 0.0,
                 remat: bool = True, seq_shard: bool = False):
        super().__init__()
        self.d_model, self.num_queries = d_model, num_queries
        self.use_mask, self.ref_size = use_mask, ref_size
        self.remat = remat
        # the sp axis (`parallel/sharding.py:shard_model`); a model built
        # with seq_shard refuses to run without one
        self.seq_shard, self.sp = seq_shard, None
        self.encoder = _Encoder(d_model, nhead, nlevel, dim_feedforward,
                                num_encoder_layers, dropout)
        self.decoder = _Decoder(d_model, nhead, nlevel, dim_feedforward,
                                num_decoder_layers, use_mask, residual_mode,
                                dropout)

    def _get_enc_proposals(self, enc_detector, output, src_mask, ref_windows):
        """Top-num_queries proposal selection. Returns (decoder embed,
        decoder ref windows f32, decoder pos, selected token indices). The
        decoder embed's input and the ref windows carry no gradient, as the
        JAX package's `stop_gradient`s rule."""
        valid = ((ref_windows[..., :2] > 0.01)
                 & (ref_windows[..., :2] < 0.99)).all(-1)
        mask = ~valid if src_mask is None else src_mask | ~valid
        out_logits = enc_detector.class_embed(output)[..., 0].float()
        out_logits = out_logits.masked_fill(mask, NEG_INF)
        _, indexes = top_k(out_logits, self.num_queries)         # (B, nq)

        def gather(arr):
            return torch.gather(
                arr, 1, indexes[..., None].expand(-1, -1, arr.shape[-1]))

        output_embed = gather(output)
        out_embed = self.encoder.enc_linear(output_embed.detach())
        tmp_ref = enc_detector.bbox_embed(output_embed).float()
        out_ref_windows = torch.sigmoid(tmp_ref + inverse_sigmoid(
            gather(ref_windows))).detach()
        pos = get_proposal_pos_embed(out_ref_windows[..., :2], self.d_model)
        size = get_proposal_pos_embed(out_ref_windows[..., 2:], self.d_model)
        return out_embed, out_ref_windows, (pos + size).to(output.dtype), indexes

    @staticmethod
    def _compute_enc_outputs(enc_detector, src_embed, src_ref_windows,
                             src_mask):
        """Encoder auxiliary head over all source tokens (training only):
        masked and border tokens get NEG_INF logits and zero boxes."""
        valid = ((src_ref_windows[..., :2] > 0.01)
                 & (src_ref_windows[..., :2] < 0.99)).all(-1)
        mask = ~valid if src_mask is None else src_mask | ~valid
        src_embed = src_embed.masked_fill(mask[..., None], 0.0)
        src_ref = src_ref_windows.masked_fill(mask[..., None], 0.0)
        enc_out = enc_detector(src_embed[None], src_ref[None],
                               x_mask=mask[None])
        return [{"pred_logits": enc_out["pred_logits"],
                 "pred_boxes": enc_out["pred_boxes"]}]

    def _decode_topk_masks(self, detector, last_layer, deferred, tgt,
                           dec_ref_windows, postprocess: dict):
        """Deferred mask decode: logits/boxes on all queries, top-k
        selection, then the RoI tail, mask head and paste on the selected
        queries only."""
        mask_out_raw, tgt_norm2, tgt_final = deferred
        det_out = detector(tgt[None], dec_ref_windows, roi=None,
                           defer_mask=True)
        logits = det_out["pred_logits"]                          # (B, NQ, C)
        scores, labels, q, xy = select_topk(
            logits, det_out["pred_boxes"], canvas_hw=postprocess["canvas_hw"],
            topk=postprocess.get("topk", 100), scale=postprocess.get("scale"))

        def gather_q(x):
            idx = q.reshape(q.shape + (1,) * (x.dim() - 2))
            return torch.gather(x, 1, idx.expand(q.shape + x.shape[2:]))

        roi = last_layer.decode_roi(gather_q(mask_out_raw), gather_q(tgt_norm2),
                                    gather_q(tgt_final))
        # mask_v1: the class channel at the argmax of the FULL class row
        top = gather_q(logits).argmax(dim=-1)                    # (B, K)
        mask_logits = detector.mask_embed(roi[None], select=top.reshape(-1))[0]
        scores, masks = paste_and_rescore(scores, mask_logits, xy,
                                          postprocess["canvas_hw"])
        return {"scores": scores, "labels": labels, "boxes": xy,
                "masks": masks}

    def forward(self, srcs: Sequence[torch.Tensor], masks, pos_list,
                enc_detector, detector=None,
                postprocess: Optional[dict] = None, inference: bool = True,
                dropout_key=None):
        """srcs: list of (B, Hi, Wi, C); masks: list of (B, Hi, Wi) bool or
        None; pos_list: list of (B, Hi, Wi, C).

        Returns (hs (nl, B, NQ, C), roi (nl, B, NQ, k, k, C) or None,
        dec_ref_windows, encoder output, src_ref_windows, src_mask, v_shape,
        enc_outputs); nl = 1 and enc_outputs None with inference=True.
        inference=False is the training path: differentiable sampling, a
        RoI from every decoder layer, every layer's output and the encoder
        head's outputs. With `postprocess` and use_mask (inference only),
        the deferred top-k mask decode's {scores, labels, boxes, masks}
        instead. `dropout_key` (training only) draws the dropout sites;
        with `remat`, training rematerialises the encoder layers and a segm
        model's decoder layers.
        """
        defer_mask = postprocess is not None and self.use_mask
        assert not defer_mask or detector is not None
        assert postprocess is None or inference, \
            "postprocess is an inference-only fast path"
        train = not inference
        if masks is not None and masks[0] is None:
            masks = None

        src_ref_windows = create_ref_windows_2d(srcs, masks, self.ref_size)
        valid_ratios = create_valid_ratios(masks)
        src, src_mask, v_shape = flatten_with_shape(srcs, masks)
        src_pos = torch.cat([p.reshape(p.shape[0], -1, p.shape[-1])
                             for p in pos_list], dim=1)

        # JAX remats the encoder whenever it trains, the decoder only with
        # use_mask (`boxer_tpu/nn/box_transformer.py:394-412`, `:439-453`)
        enc_remat = self.remat and train and torch.is_grad_enabled()
        dec_remat = enc_remat and self.use_mask
        tokens = None
        enc_in = (src, src_pos, src_mask, src_ref_windows)
        if self.seq_shard:
            if self.sp is None:
                raise RuntimeError(
                    "a model built with seq_shard runs only on a layout "
                    "with sp > 1: shard it first (parallel/sharding.py:"
                    "shard_model); it does not run unsharded")
            tokens = Tokens(self.sp, src.shape[1])
            # pad tokens: masked, mid-canvas windows; dropped at the gathers
            enc_in = tuple(None if t is None else slice_tokens(
                t, tokens, pad_value=pad) for t, pad in zip(
                    enc_in, (0.0, 0.0, True, 0.5)))
        output, enc_pos, enc_mask, enc_ref = enc_in
        for layer in self.encoder.layers:
            args = (output, enc_pos, v_shape, enc_mask, valid_ratios,
                    enc_ref)
            kw = dict(fold=True if inference else None, key=dropout_key,
                      tokens=tokens)
            output = remat(layer, *args, **kw) if enc_remat else layer(
                *args, **kw)
        if tokens is not None:
            output = gather_tokens(output, tokens)

        tgt, dec_ref_windows, dec_pos, _ = self._get_enc_proposals(
            enc_detector, output, src_mask, src_ref_windows)

        layers = self.decoder.layers
        inter, inter_roi = [], []
        deferred = None
        for i, layer in enumerate(layers):
            emit_roi = self.use_mask and (train or i == len(layers) - 1)
            if emit_roi and defer_mask:
                emit_roi = "defer"
            args = (tgt, dec_pos, output, v_shape, src_mask, valid_ratios,
                    dec_ref_windows, emit_roi, train)
            tgt, roi = (remat(layer, *args, key=dropout_key) if dec_remat
                        else layer(*args, key=dropout_key))
            if emit_roi == "defer":
                deferred, roi = roi, None
            inter.append(tgt)
            inter_roi.append(roi)

        if defer_mask:
            return self._decode_topk_masks(detector, layers[-1], deferred, tgt,
                                           dec_ref_windows, postprocess)
        if inference:
            inter, inter_roi = inter[-1:], inter_roi[-1:]
        hs = torch.stack(inter)
        roi = torch.stack(inter_roi) if self.use_mask else None
        enc_outputs = (self._compute_enc_outputs(enc_detector, output,
                                                 src_ref_windows, src_mask)
                       if train else None)
        return (hs, roi, dec_ref_windows, output, src_ref_windows, src_mask,
                v_shape, enc_outputs)
