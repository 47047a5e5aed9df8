"""Multi-scale box attention / instance attention sampling ops.

PyTorch port of `boxer_tpu/ops/box_attention.py`: the quad-table layout
(`_build_quad_tables`), `box_attention_qminor` (the fused inference path,
the per-tap and the folded differentiable paths) and the dual-output
`instance_attention_qminor`, plus the reference-contract wrappers:

  box_attention(value (B,S,H,Ch), shapes ((H1,W1),...), loc (B,Lq,H,L,P,2),
                weight (B,Lq,H,L,P)) -> (B, Lq, H*Ch)

  instance_attention(value, shapes, loc (...,P=k*k,2), spatial_w (B,Lq,H,L,P),
                     level_w (B,Lq,H,L,P)) -> (out (B,Lq,H*Ch),
                                               mask_out (B,Lq,k,k,H*Ch))

Sampling convention: locations normalized to [0,1]; pixel coords
`x = loc_x * W - 0.5` with zero padding outside, i.e. `F.grid_sample(...,
align_corners=False)` at grid `2*loc - 1`. Each level is packed into a quad
table whose row holds a pixel's 2x2 neighbourhood of the zero-bordered
level, so one row carries all four bilinear corners and a tap is valid as a
whole when its top-left corner lies in [-1, W-1] x [-1, H-1].

Taps are folded p-major: row order (p, b, h, lq), M = B*H*LQ.
`box_attention_qminor` has the JAX package's three `fold` modes:

- fold=True, the inference path, outside autograd: the P-sum and the corner
  combine run in one kernel per level, `quad_sample_reduce_raw` (K1, corner
  weights formed in the kernel, P <= 8) or `quad_sample_reduce_w4` (K2,
  precomputed corner weights, P > 8), or `quad_sample_reduce_mmajor` (K8,
  taps in (m, p) order, every P) when `COMBINE_IMPL` is "mmajor";
- fold=False, the per-tap path at any P: the levels go through
  `QuadSample`, an autograd Function over K2 whose backward scatters each
  level's table cotangent and forms its corner weights' cotangent in one
  launch of K5 (box attention) or K6 (instance attention);
- fold=None (the default) folds, differentiably, when P >
  `FOLD_TAP_THRESHOLD` and otherwise runs per tap. The folded path gathers
  all P*M quad rows of a level with `TakeRows` (backward K7b), combines the
  corners in f32, casts the taps to the value dtype and tree-reduces them
  over P in that dtype (`_reduce_pmajor`), as
  `_box_attention_qminor_folded(fused=False)` does.

`instance_attention_qminor` takes both of its sums in one launch of K4
(`ops/instance_sample.py`) when autograd needs no gradient of the call (the
inference, test and val forwards), and through `QuadSample` (K2 forward, K6
backward) when it does.

The corner weights are formed in torch, so autograd carries their cotangent
back to the sampling grid and the attention weights. `floor` has zero
gradient, so d frac / d x = 1, as in JAX.

The sampling outputs, `QuadSample`'s (box attention's per-tap levels
summed and cast to the value dtype, or one instance-attention level's
taps), are the JAX package's `checkpoint_name`s (`boxer_tpu/nn/attention.py:
208,333`): inside `keeping_samples` they are kept in the forward and
handed back in remat's recompute, which then launches no K2
(`nn/box_transformer.py:remat`).

`set_box_attention_impl("analytic_vjp")` (JAX's switch, module state;
"xla", the default, is the autograd path above) sends every
`box_attention_qminor` call, `fold=True` included, through
`AnalyticBoxAttention`, the port of `_box_attention_vjp`
(`boxer_tpu/ops/box_attention.py:792`): its forward is K2 a level up to
`FOLD_TAP_THRESHOLD` taps and the folded gather above, its hand-written
backward one launch of K5 a level, which gives the table's cotangent (kept
in f32 through the quad-table transpose) and the four corner dots that the
sampling grid's and the attention weights' cotangents are formed from.

Two module constants read the JAX package's environment variables once, at
import: `FOLD_TAP_THRESHOLD` (`BOXER_FOLD_THRESHOLD`, default 8) and
`COMBINE_IMPL` (`BOXER_COMBINE`, "pmajor" or "mmajor"; the JAX package's
"slices" is an XLA formulation with no kernel, and the fused path raises
on it).
"""

import contextlib
import os
import threading
from typing import Tuple

import torch
import torch.nn.functional as F

from boxer_tpu_torch.ops.combine_reduce import (corner_weights, pmajor_taps,
                                                quad_sample_reduce_mmajor,
                                                quad_sample_reduce_raw,
                                                quad_sample_reduce_w4,
                                                tap_rows)
from boxer_tpu_torch.ops.instance_sample import (instance_sample_reduce,
                                                 instance_sample_reduce_plain)
from boxer_tpu_torch.ops.scatter_accum import (
    scatter_add_rows_pmajor, scatter_add_rows_weighted_dw4)
from boxer_tpu_torch.utils.general import level_start_index

Shapes = Tuple[Tuple[int, int], ...]

# taps per output up to which the raw-weight mode (K1) is used; above it the
# corner weights are precomputed (K2), as in the JAX package
ONEPASS_MAX_P = 8
# taps per level above which fold=None takes the folded path
# (`_FOLD_TAP_THRESHOLD`, boxer_tpu/ops/box_attention.py:612-617)
FOLD_TAP_THRESHOLD = int(os.environ.get("BOXER_FOLD_THRESHOLD", "8"))
# the fused inference combine: "pmajor" (K1/K2) or "mmajor" (K8)
COMBINE_IMPL = os.environ.get("BOXER_COMBINE", "pmajor")


def _build_quad_tables(value, shapes: Shapes):
    """Pack each level's 2x2 pixel neighbourhoods into 4*Ch-wide rows.

    value: (B, S, H, Ch). Returns one table per level, (BH*(Hl+1)*(Wl+1),
    4*Ch), row r = [V[y,x], V[y,x+1], V[y+1,x], V[y+1,x+1]] of the
    zero-border-padded level, with BH slices of (Hl+1)*(Wl+1) rows.
    """
    b, s, nh, ch = value.shape
    bh = b * nh
    starts = level_start_index(shapes)
    v = value.permute(0, 2, 1, 3).reshape(bh, s, ch)
    tables = []
    for li, (hl, wl) in enumerate(shapes):
        lvl = v[:, starts[li]:starts[li] + hl * wl].reshape(bh, hl, wl, ch)
        lvl = F.pad(lvl, (0, 0, 1, 1, 1, 1))
        q = torch.cat([lvl[:, :-1, :-1], lvl[:, :-1, 1:],
                       lvl[:, 1:, :-1], lvl[:, 1:, 1:]], dim=-1)
        tables.append(q.reshape(bh * (hl + 1) * (wl + 1), 4 * ch))
    return tables


_kept = threading.local()


@contextlib.contextmanager
def keeping_samples(outputs: list, replay: bool):
    """Inside, `QuadSample`'s forward appends its output to `outputs`, or,
    with replay, hands them back in order instead of launching K2: remat's
    forward and recompute (`nn/box_transformer.py:remat`)."""
    prev = getattr(_kept, "state", None)
    _kept.state = (outputs, replay)
    try:
        yield
    finally:
        _kept.state = prev


def _kept_or_run(run):
    """A sampling output: run() and, inside `keeping_samples`, keep it, or
    hand back the kept one in the recompute instead of running."""
    outputs, replay = getattr(_kept, "state", None) or (None, False)
    if replay:
        return outputs.pop(0)
    out = run()
    if outputs is not None:
        outputs.append(out.detach())
    return out


def _box_levels(tables, idx, w4, dtype):
    """Box attention's per-tap levels: sum over the levels of K2(table,
    idx, w4), in f32, cast to `dtype`. Returns (M, ch)."""
    out = torch.zeros((idx[0].shape[1], tables[0].shape[1] // 4),
                      dtype=torch.float32, device=tables[0].device)
    for table, ix, w in zip(tables, idx, w4):
        out = out + quad_sample_reduce_w4(table, ix, w)
    return out.to(dtype)


def _instance_level(table, idx, w4):
    """One instance-attention level's taps, K2 with the P taps unsummed:
    (P*M, ch) f32 in p-major order."""
    p, m = idx.shape
    return quad_sample_reduce_w4(table, idx.reshape(1, p * m),
                                 w4.transpose(0, 1).reshape(1, 4, p * m))


class QuadSample(torch.autograd.Function):
    """`sample(table, idx, w4)`: the corner combine of quad-table rows, the
    port of `_sample_taps_vjp` (`boxer_tpu/ops/box_attention.py:221`).

    `apply(per_tap, dtype, table_0, idx_0, w4_0, table_1, ...)`, for each
    level table (R, 4*ch), idx (P, M) int32, w4 (P, 4, M) f32. With
    per_tap=False returns sum_levels sum_p sum_c w4[p, c, m] *
    table[idx[p, m], c] -> (M, ch) in `dtype`, summed in f32 (box
    attention); with per_tap=True, of one level, the P taps unsummed ->
    (P*M, ch) f32 in p-major order (instance attention). Its output is the
    sampling output that remat keeps (`keeping_samples`), as the JAX
    package's `checkpoint_name`s. The forward is K2 a level; the backward is one
    launch a level of K5 (g shared by the P taps) or K6 (g per tap) that
    returns d_table, cast to the table's dtype, and d_w4[p, c, m] =
    <table[idx[p, m], c], g[row]> (the JAX package computes d_w4 in XLA
    beside its scatter), each only when autograd asks for it. The same
    Function runs on both devices; only the kernel wrapper inside
    dispatches.
    """

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, per_tap: bool, dtype, *levels):
        ctx.save_for_backward(*levels)
        ctx.per_tap = per_tap
        return _kept_or_run(lambda: _instance_level(*levels) if per_tap
                            else _box_levels(levels[0::3], levels[1::3],
                                             levels[2::3], dtype))

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        levels = ctx.saved_tensors
        g = g.float().contiguous()
        grads = [None, None]
        for li in range(0, len(levels), 3):
            table, idx, w4 = levels[li:li + 3]
            d_table, d_w4 = scatter_add_rows_weighted_dw4(
                idx, g, w4, table, ctx.per_tap,
                want_table=ctx.needs_input_grad[2 + li],
                want_dw4=ctx.needs_input_grad[4 + li])
            if d_table is not None:
                d_table = d_table.to(table.dtype)
            grads += [d_table, None, d_w4]
        return tuple(grads)


class TakeRows(torch.autograd.Function):
    """`take(table, idx)` = `table[idx]`, (P*M, 4*ch) in idx's p-major
    order: the port of `_take_rows_vjp` (`boxer_tpu/ops/box_attention.py:
    147`). The forward is a plain gather, as the JAX package's `jnp.take`
    in XLA; the backward scatters the row cotangent into a zeroed table with
    K7b and casts it to the table's dtype."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows, ctx.dtype = table.shape[0], table.dtype
        return table[idx.reshape(-1).long()]

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        d_table = scatter_add_rows_pmajor(idx, g.contiguous(), ctx.rows)
        return d_table.to(ctx.dtype), None


def _smallest_factor(n: int) -> int:
    for f in range(2, int(n ** 0.5) + 1):
        if n % f == 0:
            return f
    return n


def _reduce_pmajor(x, n: int, m: int):
    """Sum a (n*m, ch) p-major tensor over its n leading blocks -> (m, ch),
    in x's dtype, by the JAX package's tree of factor-f row slices."""
    while n > 1:
        f = 2 if n % 2 == 0 else _smallest_factor(n)
        blk = n // f
        x = sum(x[i * blk * m:(i + 1) * blk * m] for i in range(f))
        n = blk
    return x


def _fused_level(table, idx, lx, ly, w_tap):
    """fold=True: one combine kernel for the level's (P, M) taps, outside
    autograd. Returns (M, ch) f32."""
    if COMBINE_IMPL not in ("pmajor", "mmajor"):
        raise ValueError(f"COMBINE_IMPL {COMBINE_IMPL!r}: the port has "
                         "'pmajor' and 'mmajor'")
    if COMBINE_IMPL == "mmajor":
        return quad_sample_reduce_mmajor(
            table, *(t.t().contiguous() for t in (idx, lx, ly, w_tap)))
    if idx.shape[0] <= ONEPASS_MAX_P:
        return quad_sample_reduce_raw(table, idx, lx, ly, w_tap)
    return quad_sample_reduce_w4(table, idx, corner_weights(lx, ly, w_tap))


def _folded_level(table, idx, lx, ly, w_tap, dtype):
    """The differentiable folded path of one level: `TakeRows`, the corner
    combine in f32, the taps cast to `dtype` and reduced over P in it.
    Returns (M, ch) f32."""
    p, m = idx.shape
    ch = table.shape[1] // 4
    vals = TakeRows.apply(table, idx)                      # (P*M, 4*ch)
    w4 = corner_weights(lx, ly, w_tap)                     # (P, 4, M)
    taps = sum(vals[:, c * ch:(c + 1) * ch].float() * w4[:, c].reshape(-1, 1)
               for c in range(4)).to(dtype)
    return _reduce_pmajor(taps, p, m).float()


def _level_taps(shapes: Shapes, gx, gy, attn_weight, bh: int):
    """Per level of `shapes`, the taps of (B, H, L, P, LQ) inputs as (P, M)
    tensors: quad-table rows idx, fractions lx, ly, validity (f32) and the
    tap weight w_tap = valid * attn_weight."""
    _, _, nl, npt, lq = gx.shape
    gx, gy, aw = (pmajor_taps(t, bh, nl, npt, lq)
                  for t in (gx, gy, attn_weight))
    for li, (hl, wl) in enumerate(shapes):
        idx, lx, ly, valid = tap_rows(gx[li], gy[li], hl, wl)
        w_tap = torch.where(valid, aw[li], 0.0)
        yield tuple(t.reshape(npt, bh * lq)
                    for t in (idx, lx, ly, valid.float(), w_tap))


_BOX_ATTN_IMPL = {"default": "xla"}


def set_box_attention_impl(name: str):
    """Select the box-attention backward: "xla" (the default: autograd
    through `QuadSample` or `TakeRows`, the JAX package's name for XLA AD)
    or "analytic_vjp" (`AnalyticBoxAttention`'s hand-written backward, kept
    for pinning numerics). Module state, as in the JAX package."""
    if name not in ("xla", "analytic_vjp"):
        raise ValueError(f"box attention impl {name!r}: 'xla' or "
                         "'analytic_vjp'")
    _BOX_ATTN_IMPL["default"] = name


def get_box_attention_impl() -> str:
    return _BOX_ATTN_IMPL["default"]


def box_attention_dispatch(value, shapes: Shapes, sampling_loc, attn_weight):
    """Reference-layout entry point (the modules call the qminor op)."""
    return box_attention(value, shapes, sampling_loc, attn_weight)


class AnalyticBoxAttention(torch.autograd.Function):
    """Box attention with the JAX package's analytic backward
    (`_box_attention_vjp`, `boxer_tpu/ops/box_attention.py:792-914`).

    `apply(shapes, value (B,S,H,Ch), gx, gy, attn_weight (B,H,L,P,LQ))` ->
    (B, H, LQ, Ch) in value.dtype. The forward is JAX's `f`: K2 a level,
    summed in f32 (`_box_levels`), up to `FOLD_TAP_THRESHOLD` taps, and the
    folded gather and P-reduce in the value dtype (`_folded_level`) above;
    its output is a sampling output that remat keeps (`keeping_samples`).
    The backward, for each level, launches K5 once on the raw-layout
    cotangent g (M, Ch) shared by the P taps: d_table[idx] += [w_c * g]_c
    and the corner dots s_c = <table[idx]_c, g>; from the dots it forms

      d_aw  = valid * sum_c cw_c(lx, ly) * s_c
      d_gx  = w_tap * (-(1-ly) s0 + (1-ly) s1 - ly s2 + ly s3) * W
      d_gy  = w_tap * (-(1-lx) s0 - lx s1 + (1-lx) s2 + lx s3) * H

    (floor's straight-through derivative), and d_value from the dense
    transpose of the quad-table build, in f32 until one cast to the value's
    dtype at the end.
    """

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, shapes, value, gx, gy, attn_weight):
        ctx.shapes = shapes
        ctx.save_for_backward(value, gx, gy, attn_weight)
        return _kept_or_run(lambda: _analytic_forward(shapes, value, gx, gy,
                                                      attn_weight))

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        value, gx, gy, attn_weight = ctx.saved_tensors
        shapes = ctx.shapes
        b, s, nh, ch = value.shape
        bh, (nl, npt, lq) = b * nh, gx.shape[2:]
        g = g.float().reshape(bh * lq, ch).contiguous()
        d_levels, d_gx, d_gy, d_aw = [], [], [], []
        for table, (hl, wl), (idx, lx, ly, valid, w_tap) in zip(
                _build_quad_tables(value, shapes), shapes,
                _level_taps(shapes, gx, gy, attn_weight, bh)):
            d_table, dots = scatter_add_rows_weighted_dw4(
                idx, g, corner_weights(lx, ly, w_tap), table, per_tap=False,
                want_table=ctx.needs_input_grad[1])
            s0, s1, s2, s3 = dots.unbind(1)                    # (P, M) each
            d_aw.append(valid * ((1 - lx) * (1 - ly) * s0 + lx * (1 - ly) * s1
                                 + (1 - lx) * ly * s2 + lx * ly * s3))
            d_gx.append(w_tap * (-(1 - ly) * s0 + (1 - ly) * s1 - ly * s2
                                 + ly * s3) * wl)
            d_gy.append(w_tap * (-(1 - lx) * s0 - lx * s1 + (1 - lx) * s2
                                 + lx * s3) * hl)
            if d_table is not None:
                d_levels.append(_quad_table_transpose(d_table, bh, hl, wl))

        def raw(levels, like):
            """L x (P, BH*LQ) -> like's (B, H, L, P, LQ) and dtype."""
            return (torch.stack(levels).reshape(nl, npt, bh, lq)
                    .permute(2, 0, 1, 3).reshape(like.shape).to(like.dtype))

        d_value = None
        if d_levels:
            d_value = (torch.cat(d_levels, dim=1).reshape(b, nh, s, ch)
                       .permute(0, 2, 1, 3).to(value.dtype))
        return (None, d_value, raw(d_gx, gx), raw(d_gy, gy),
                raw(d_aw, attn_weight))


def _analytic_forward(shapes: Shapes, value, gx, gy, attn_weight):
    """`AnalyticBoxAttention`'s forward: (B, H, LQ, Ch) in value.dtype."""
    b, s, nh, ch = value.shape
    npt, lq = gx.shape[3:]
    tables = _build_quad_tables(value, shapes)
    levels = list(_level_taps(shapes, gx, gy, attn_weight, b * nh))
    if npt > FOLD_TAP_THRESHOLD:
        out = sum(_folded_level(table, idx, lx, ly, w_tap, value.dtype)
                  for table, (idx, lx, ly, _, w_tap) in zip(tables, levels))
    else:
        out = _box_levels(tables, [lv[0] for lv in levels],
                          [corner_weights(*lv[1:3], lv[4]) for lv in levels],
                          value.dtype)
    return out.to(value.dtype).reshape(b, nh, lq, ch)


def _quad_table_transpose(d_table, bh: int, hl: int, wl: int):
    """The transpose of one level's quad-table build: (BH*(hl+1)*(wl+1),
    4*Ch) table cotangent -> (BH, hl*wl, Ch) value cotangent, in its
    dtype."""
    ch = d_table.shape[1] // 4
    dq = d_table.reshape(bh, hl + 1, wl + 1, 4 * ch)
    d_pad = d_table.new_zeros((bh, hl + 2, wl + 2, ch))
    for c, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        d_pad[:, dy:dy + hl + 1, dx:dx + wl + 1] += dq[..., c * ch:(c + 1) * ch]
    return d_pad[:, 1:hl + 1, 1:wl + 1].reshape(bh, hl * wl, ch)


def _merge_heads(raw):
    """(B, H, LQ, C) -> (B, LQ, H*C)."""
    b, nh, lq, ch = raw.shape
    return raw.permute(0, 2, 1, 3).reshape(b, lq, nh * ch)


def box_attention_qminor(value, shapes: Shapes, gx, gy, attn_weight,
                         raw: bool = False, fold=None):
    """Box attention, query-minor inputs.

    value:       (B, S, H, Ch)
    gx, gy:      (B, H, L, P, LQ) normalized [0,1] sample coordinates
    attn_weight: (B, H, L, P, LQ), softmax-normalized over (L, P)
    returns      (B, LQ, H*Ch), or (B, H, LQ, Ch) when raw=True, in
                 value.dtype; accumulation is f32.
    fold=True is the inference path (K1/K2 or K8, no autograd through
    them); fold=False the differentiable per-tap path (`QuadSample`: K2,
    K5); fold=None the differentiable folded path (`TakeRows`: K7b) when P >
    FOLD_TAP_THRESHOLD, else the per-tap one, as in the JAX package.
    """
    assert gx.shape[2] == len(shapes)
    if _BOX_ATTN_IMPL["default"] == "analytic_vjp":
        out = AnalyticBoxAttention.apply(tuple(map(tuple, shapes)), value, gx,
                                         gy, attn_weight)
        return out if raw else _merge_heads(out)
    b, s, nh, ch = value.shape
    npt, lq = gx.shape[3:]
    fused = fold is True
    if fold is None:
        fold = npt > FOLD_TAP_THRESHOLD

    tables = _build_quad_tables(value, shapes)
    out = torch.zeros((b * nh * lq, ch), dtype=torch.float32,
                      device=value.device)
    per_tap = []
    for table, (idx, lx, ly, _, w_tap) in zip(
            tables, _level_taps(shapes, gx, gy, attn_weight, b * nh)):
        if fused:
            out = out + _fused_level(table, idx, lx, ly, w_tap)
        elif fold:
            out = out + _folded_level(table, idx, lx, ly, w_tap, value.dtype)
        else:
            per_tap += [table, idx, corner_weights(lx, ly, w_tap)]
    if per_tap:
        out = QuadSample.apply(False, value.dtype, *per_tap)
    out = out.to(value.dtype).reshape(b, nh, lq, ch)
    return out if raw else _merge_heads(out)


def box_attention(value, shapes: Shapes, sampling_loc, attn_weight):
    """Reference-contract wrapper.

    value:        (B, S, H, Ch)
    sampling_loc: (B, Lq, H, L, P, 2) in [0,1]
    attn_weight:  (B, Lq, H, L, P), softmax-normalized over (L, P)
    returns       (B, Lq, H*Ch) in value.dtype
    """
    gx = torch.movedim(sampling_loc[..., 0], 1, -1)      # (B, H, L, P, LQ)
    gy = torch.movedim(sampling_loc[..., 1], 1, -1)
    aw = torch.movedim(attn_weight, 1, -1)
    return box_attention_qminor(value, shapes, gx, gy, aw)


def _quad_sample_taps(table, idx, bw4):
    """One level's per-tap samples through `QuadSample` (K2 forward, K6
    backward): (P, M, ch) f32, differentiable."""
    npt, m = idx.shape
    return QuadSample.apply(True, None, table, idx, bw4).reshape(npt, m, -1)


def instance_attention_qminor(value, shapes: Shapes, gx, gy, spatial_weight,
                              level_weight, kernel_size: int,
                              raw: bool = False):
    """Instance attention, query-minor inputs: one sampling pass, two sums.

      out[b,h,q]    = sum_{l,p} spatial_w * sample(l, p)
      mask[b,q,p,h] = sum_l     level_w   * sample(l, p)

    gx/gy/spatial_weight/level_weight: (B, H, L, P=k*k, LQ).
    Returns (out (B,LQ,H*Ch) — or (B,H,LQ,Ch) when raw=True — and mask_out
    (B,LQ,k,k,H*Ch)), in value.dtype. When autograd needs a gradient of the
    call (grad mode on and an input that requires one: training, and
    remat's forward and recompute), the per-tap samples go through
    `QuadSample` (K2, K6) and both sums are taken in torch; otherwise (the
    inference and test forwards, and the val forward, whose decoder layers
    sample with train=True under no_grad) one launch of K4
    (`instance_sample_reduce`) gives both, or its plain version on the CPU.
    The JAX package runs this op in XLA with no Pallas kernel.
    """
    assert gx.shape[3] == kernel_size * kernel_size
    tables = _build_quad_tables(value, shapes)
    inputs = (gx, gy, spatial_weight, level_weight)
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (value, *inputs))
    if needs_grad:
        out, mask_out = instance_sample_reduce_plain(
            tables, shapes, *inputs, kernel_size, sample=_quad_sample_taps)
    else:
        out, mask_out = instance_sample_reduce(
            tables, shapes, *(t.float().contiguous() for t in inputs),
            kernel_size)
    if raw:
        return out, mask_out
    return _merge_heads(out), mask_out


def instance_attention(value, shapes: Shapes, sampling_loc, spatial_weight,
                       level_weight, kernel_size: int):
    """Reference-contract wrapper.

    value:          (B, S, H, Ch)
    sampling_loc:   (B, Lq, H, L, P=k*k, 2)
    spatial_weight: (B, Lq, H, L, P) — softmax over (L*P)
    level_weight:   (B, Lq, H, L, P) — softmax over L
    returns (out (B,Lq,H*Ch), mask_out (B,Lq,k,k,H*Ch))
    """
    gx = torch.movedim(sampling_loc[..., 0], 1, -1)
    gy = torch.movedim(sampling_loc[..., 1], 1, -1)
    sw = torch.movedim(spatial_weight, 1, -1)
    lw = torch.movedim(level_weight, 1, -1)
    return instance_attention_qminor(value, shapes, gx, gy, sw, lw,
                                     kernel_size)
