"""K9, box attention's one-launch inference sampling
(`ops/box_sample.py`), and the route of `box_attention_qminor(fold=True)`.

The plain version, which reads each tap's 2x2 corners straight from the
value, is held against the route it replaces (the quad tables of
`_build_quad_tables`, the taps of `_level_taps` and `quad_sample_reduce_plain`
a level, summed over the levels in f32) and the op against the JAX package's
`box_attention_qminor(fold=True)`. Inputs come from one numpy seed
(`box_case`): taps whose top-left corner lies at -2, -1, W-1 and W (each mid
cell and on the cell's edge, where a fused multiply-add would move floor),
at +-1e6, and uniform over [-0.2, 1.2]. Both sides sum in f32 in another
order, so f32 outputs agree within rel err 1e-5; with a bf16 value both
round their sums to bf16, one step of which is up to 2^-7 of an element:
1e-2. A tiny BoxeR-2D's inference forward sends every fold=True call to K9
and builds quad tables only for K4's call.

The cases that need a card (marker `gpu`) hold the kernel against its plain
version and skip without one; jax is imported only inside the JAX case, so
on a card without jax they run with `python -m pytest --noconftest -p
no:cacheprovider -m gpu tests/test_torch_box_sample.py`.
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget)
import importlib

import numpy as np
import pytest
import torch

from boxer_tpu_torch.ops import box_sample
from boxer_tpu_torch.ops.box_sample import (box_sample_reduce,
                                            box_sample_reduce_plain)
from boxer_tpu_torch.ops.combine_reduce import quad_sample_reduce_plain
from test_torch_kernels import RTOL, SEGM_SHAPES, _rel_err, cuda  # noqa: F401

tb = importlib.import_module("boxer_tpu_torch.ops.box_attention")

# odd level sizes, a 1-pixel-wide level among them
ODD_SHAPES = ((7, 9), (5, 3), (3, 4), (1, 2))
TOLS = {torch.float32: RTOL, torch.bfloat16: 1e-2}


def box_case(b, nh, npt, shapes, lq, seed):
    """value (B, S, H, 32) and gx, gy, attn_weight (B, H, L, P, LQ), numpy
    f32. Per coordinate, one in four each: a top-left corner at -2, -1,
    n-1 or n (mid cell, or on the cell's edge (x0 + 0.5) / n); +-1e6;
    uniform over [-0.2, 1.2]; the rest on the level's cell edges."""
    rs = np.random.RandomState(seed)
    size = (b, nh, len(shapes), npt, lq)
    value = rs.randn(b, sum(h * w for h, w in shapes), nh, 32).astype(
        np.float32)

    def coords(axis):
        pick = rs.randint(0, 4, size)
        out = rs.uniform(-0.2, 1.2, size)
        out[pick == 1] = rs.choice([-1e6, 1e6], int((pick == 1).sum()))
        for li, hw in enumerate(shapes):
            n = hw[axis]
            lv = out[:, :, li]
            corner = rs.choice([-2, -1, n - 1, n], lv.shape)
            frac = np.where(rs.rand(*lv.shape) < 0.5, 0.0,
                            rs.uniform(0.05, 0.95, lv.shape))
            edge = (corner + 0.5 + frac) / n
            lv[pick[:, :, li] == 2] = edge[pick[:, :, li] == 2]
            cells = (np.arange(-1, n + 1) + 0.5) / n
            on = pick[:, :, li] == 3
            lv[on] = rs.choice(cells, int(on.sum()))
        return out.astype(np.float32)

    gx, gy = coords(1), coords(0)
    aw = rs.rand(*size).astype(np.float32)
    return value, gx, gy, aw


def box_inputs(case, device, dtype=torch.float32):
    value, *grids = case
    return (torch.from_numpy(value).to(device, dtype),
            *(torch.from_numpy(a).to(device) for a in grids))


def quad_table_route(value, shapes, gx, gy, aw):
    """The route K9 replaces, in plain versions: quad tables, each level's
    taps, `quad_sample_reduce_plain` a level, summed in f32. Returns
    (B, H, LQ, Ch) in the value's dtype."""
    b, _, nh, ch = value.shape
    lq = gx.shape[-1]
    out = sum(quad_sample_reduce_plain(table, idx, lx=lx, ly=ly, wt=w_tap)
              for table, (idx, lx, ly, _, w_tap) in zip(
                  tb._build_quad_tables(value, shapes),
                  tb._level_taps(shapes, gx, gy, aw, b * nh)))
    return out.to(value.dtype).reshape(b, nh, lq, ch)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nh", [4, 8])
@pytest.mark.parametrize("npt", [1, 4, 9, 196])
def test_plain_matches_quad_table_route(npt, nh, dtype):
    """The plain version against the quad-table route at P 1, 4, 9 and 196,
    H 4 and 8, odd level sizes, LQ 13, taps at and just past every
    border and at +-1e6."""
    case = box_case(2, nh, npt, ODD_SHAPES, 13, seed=npt + nh)
    value, gx, gy, aw = box_inputs(case, "cpu", dtype)
    got = box_sample_reduce_plain(value, ODD_SHAPES, gx, gy, aw)
    want = quad_table_route(value, ODD_SHAPES, gx, gy, aw)
    assert got.shape == (2, 13, nh, 32) and got.dtype == dtype
    assert got.is_contiguous()
    assert float(want.abs().max()) > 0
    assert _rel_err(got.permute(0, 2, 1, 3).float().numpy(),
                    want.float().numpy()) <= TOLS[dtype]


@pytest.mark.parametrize("raw", [True, False])
@pytest.mark.parametrize("npt", [4, 196])
def test_fold_true_matches_jax(npt, raw):
    """`box_attention_qminor(fold=True)` against the JAX package's, f32,
    both layouts; raw=True is the (B, H, LQ, Ch) view of K9's (B, LQ, H,
    Ch) output."""
    jb = importlib.import_module("boxer_tpu.ops.box_attention")
    import jax.numpy as jnp

    case = box_case(2, 4, npt, ODD_SHAPES, 11, seed=20 + npt)
    value, gx, gy, aw = box_inputs(case, "cpu")
    got = tb.box_attention_qminor(value, ODD_SHAPES, gx, gy, aw, raw=raw,
                                  fold=True)
    want = jb.box_attention_qminor(jnp.asarray(case[0]), ODD_SHAPES,
                                   *(jnp.asarray(a) for a in case[1:]),
                                   raw=raw, fold=True)
    assert tuple(got.shape) == want.shape
    if raw:
        assert got.permute(0, 2, 1, 3).is_contiguous()
    assert float(np.abs(np.asarray(want)).max()) > 0
    assert _rel_err(got.numpy(), np.asarray(want)) <= RTOL


@pytest.mark.parametrize("use_mask", [True, False], ids=["segm", "det"])
def test_inference_forward_routes_fold_true_to_k9(monkeypatch, use_mask):
    """A tiny BoxeR-2D's inference forward on the CPU: every box-attention
    call (the encoder layers, and the decoder layers but a segm model's
    last) goes to K9's wrapper; quad tables are built once, for K4's call
    in a segm model's last decoder layer, and never in detection;
    `_level_taps` is never called."""
    from test_torch_boxer2d import POST, TINY, _inputs

    from boxer_tpu_torch.models.boxer2d import BoxeR2D

    calls = {"k9": 0, "tables": 0, "taps": 0}
    wrapped = {"k9": ("box_sample_reduce", tb.box_sample_reduce),
               "tables": ("_build_quad_tables", tb._build_quad_tables),
               "taps": ("_level_taps", tb._level_taps)}

    def counting(key, fn):
        def run(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return run

    for key, (name, fn) in wrapped.items():
        monkeypatch.setattr(tb, name, counting(key, fn))
    model = BoxeR2D(**TINY, use_mask=use_mask).init_weights(3).eval()
    image, mask = (torch.from_numpy(a) for a in _inputs(True))
    with torch.no_grad():
        out = model(image, mask, postprocess=POST)
    assert out["boxes"].shape[-1] == 4
    assert calls == {"k9": TINY["enc_layers"] + TINY["dec_layers"]
                     - use_mask, "tables": int(use_mask), "taps": 0}


def test_wrapper_raises_on_unsupported_arguments():
    """K9 takes Ch 32, a bf16 or f32 contiguous value, 1 to 8 levels that
    tile its tokens, f32 grids of one shape; anything else raises before a
    launch, and so does a device other than CUDA (meta here)."""
    value, gx, gy, aw = box_inputs(box_case(1, 2, 4, ODD_SHAPES, 5, seed=9),
                                   "meta")
    before = box_sample.box_sample_reduce.launches
    bad = [
        ((value[..., :16], ODD_SHAPES, gx, gy, aw), ValueError, "value must"),
        ((value, ODD_SHAPES[:3], gx, gy, aw), ValueError, "levels"),
        ((value, ODD_SHAPES[:3] + ((2, 2),), gx, gy, aw), ValueError,
         "do not tile"),
        ((value, ODD_SHAPES, gx.double(), gy, aw), ValueError, "must be f32"),
        ((value, ODD_SHAPES, gx, gy, aw[..., :4]), ValueError, "must be f32"),
        ((value.half(), ODD_SHAPES, gx, gy, aw), TypeError, "dtype"),
        ((value, ODD_SHAPES, gx, gy, aw), ValueError, "device"),
    ]
    for args, error, match in bad:
        with pytest.raises(error, match=match):
            box_sample.box_sample_reduce(*args)
    assert box_sample.box_sample_reduce.launches == before


def test_cpu_call_takes_the_plain_version():
    """A CPU call runs the plain version and launches nothing."""
    value, gx, gy, aw = box_inputs(box_case(1, 2, 4, ODD_SHAPES, 5, seed=10),
                                   "cpu")
    before = box_sample_reduce.launches
    got = box_sample_reduce(value, ODD_SHAPES, gx, gy, aw)
    want = box_sample_reduce_plain(value, ODD_SHAPES, gx, gy, aw)
    assert box_sample_reduce.launches == before
    assert torch.equal(got, want)


# (B, H, LQ, shapes) on the card: ragged output counts (B*H*LQ not a multiple
# of a block's outputs), and the segm decoder's levels
CARD_CASES = [(2, 8, 37, ODD_SHAPES), (1, 3, 301, ODD_SHAPES),
              (2, 8, 300, SEGM_SHAPES)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,nh,lq,shapes", CARD_CASES)
@pytest.mark.parametrize("npt", [1, 4, 9, 196])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda, b, nh, lq, shapes, npt, dtype):
    """K9 against its plain version on the card, at ragged M and P 1, 4, 9
    and 196 (one warp an output up to 16 taps, then 2, 4 or 8 warps);
    `.launches` rises by one a call; two launches are bitwise equal."""
    case = box_case(b, nh, npt, shapes, lq, seed=40 + npt + lq)
    value, gx, gy, aw = box_inputs(case, cuda, dtype)
    before = box_sample_reduce.launches
    got = box_sample_reduce(value, shapes, gx, gy, aw)
    again = box_sample_reduce(value, shapes, gx, gy, aw)
    want = box_sample_reduce_plain(value, shapes, gx, gy, aw)
    torch.cuda.synchronize()
    assert box_sample_reduce.launches == before + 2
    assert got.shape == (b, lq, nh, 32) and got.dtype == dtype
    assert torch.equal(got, again)
    assert float(want.float().abs().max()) > 0
    assert _rel_err(got.float().cpu().numpy(),
                    want.float().cpu().numpy()) <= TOLS[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("npt", [4, 196])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_op_layouts_on_card(cuda, npt, dtype):
    """`box_attention_qminor(fold=True)` on the card, one launch a call:
    raw=True is the (B, H, LQ, Ch) view of K9's (B, LQ, H, Ch) output (so
    the head merge is a view), raw=False its (B, LQ, H*Ch) reshape; an
    attention weight in the module's own layout (query axis outermost, a
    strided view) gives the contiguous one's output bitwise."""
    b, nh, lq = 2, 8, 37
    value, gx, gy, aw = box_inputs(
        box_case(b, nh, npt, SEGM_SHAPES, lq, seed=60 + npt), cuda, dtype)
    strided = aw.permute(0, 4, 1, 2, 3).contiguous().permute(0, 2, 3, 4, 1)
    assert not strided.is_contiguous()
    before = box_sample_reduce.launches
    raw = tb.box_attention_qminor(value, SEGM_SHAPES, gx, gy, aw, raw=True,
                                  fold=True)
    merged = tb.box_attention_qminor(value, SEGM_SHAPES, gx, gy, strided,
                                     fold=True)
    want = box_sample_reduce_plain(value, SEGM_SHAPES, gx, gy, aw)
    torch.cuda.synchronize()
    assert box_sample_reduce.launches == before + 2
    assert raw.shape == (b, nh, lq, 32)
    assert raw.permute(0, 2, 1, 3).is_contiguous()
    assert merged.shape == (b, lq, nh * 32) and merged.is_contiguous()
    assert torch.equal(raw.permute(0, 2, 1, 3).reshape(b, lq, -1), merged)
    assert _rel_err(merged.float().cpu().numpy(),
                    want.reshape(b, lq, -1).float().cpu().numpy()) \
        <= TOLS[dtype]
