"""The port's modules (boxer_tpu_torch) against the JAX package's, on the
same weights.

JAX variables are made from a numpy seed at the shapes `eval_shape` reports
(no flax init run), pushed through the port's converter
(`boxer_tpu_torch.utils.weights`) and loaded with a strict
`load_state_dict`, so a leaf the converter drops or a tensor it leaves
unfilled fails the test. Everything runs in f32 on the CPU; the port's
kernels take their plain versions here. Tolerance: rel err <= 1e-4 (f32
sums taken in another order, through a few layers).
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget)
import importlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from boxer_tpu_torch.utils.weights import jax_to_torch_state

RTOL = 1e-4


def _rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(1e-6, np.abs(b).max())


def random_variables(jax_module, seed, *args, **kwargs):
    """Seeded numpy weights for `jax_module` at its init shapes: kernels
    N(0, 1/fan_in), biases and norm scales around 0 and 1, positive
    FrozenBN variances. Nothing is zero, so no logits tie."""
    shapes = jax.eval_shape(
        lambda: jax_module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rs = np.random.RandomState(seed)

    def leaf(path, sds):
        coll, name = path[0].key, path[-1].key
        shape = sds.shape
        if coll == "constants":
            if name == "running_var":
                x = rs.uniform(0.5, 1.5, shape)
            elif name == "weight":
                x = 1.0 + 0.1 * rs.randn(*shape)
            else:
                x = 0.1 * rs.randn(*shape)
        elif name == "scale":
            x = 1.0 + 0.1 * rs.randn(*shape)
        elif name == "bias":
            x = 0.1 * rs.randn(*shape)
        else:
            fan_in = shape[-2] * (shape[0] * shape[1] if len(shape) == 4 else 1)
            x = rs.randn(*shape) / math.sqrt(fan_in)
        return np.asarray(x, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, dict(shapes))


def load_submodule(port, variables, jax_path, torch_prefix):
    """Load a JAX submodule's variables into the port module through the
    whole-model converter: `jax_path` is where the submodule sits in the JAX
    BoxeR2D tree, `torch_prefix` its key prefix in the port's."""
    def nest(tree):
        for k in reversed(jax_path):
            tree = {k: tree}
        return tree

    arrays, _ = jax_to_torch_state({c: nest(t) for c, t in variables.items()})
    assert all(k.startswith(torch_prefix) for k in arrays), sorted(arrays)
    port.load_state_dict({k[len(torch_prefix):]: torch.from_numpy(v)
                          for k, v in arrays.items()}, strict=True)
    return port.eval()


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


SHAPES = ((6, 7), (3, 4))


def _attn_inputs(seed, d_model=64, lq=5, n_level=2):
    rs = np.random.RandomState(seed)
    s = sum(h * w for h, w in SHAPES[:n_level])
    query = rs.randn(1, lq, d_model).astype(np.float32)
    value = rs.randn(1, s, d_model).astype(np.float32)
    v_mask = rs.rand(1, s) < 0.2
    ratios = rs.uniform(0.6, 1.0, (1, n_level, 2)).astype(np.float32)
    ref = np.concatenate([rs.uniform(0.1, 0.9, (1, lq, 2)),
                          rs.uniform(0.1, 0.5, (1, lq, 2))],
                         -1).astype(np.float32)
    return query, value, v_mask, ratios, ref


def test_small_functions_match():
    from boxer_tpu.nn import attention as ja, resnet as jr
    from boxer_tpu.nn import box_transformer as jt
    from boxer_tpu.nn import position_encoding as jp
    from boxer_tpu.utils import general as jg
    from boxer_tpu_torch.nn import attention as ta, resnet as tr
    from boxer_tpu_torch.nn import box_transformer as tt
    from boxer_tpu_torch.nn import position_encoding as tp
    from boxer_tpu_torch.utils import general as tg

    rs = np.random.RandomState(0)
    x = rs.uniform(-0.1, 1.1, (3, 5, 4)).astype(np.float32)
    assert _rel_err(tg.inverse_sigmoid(_t(x)), jg.inverse_sigmoid(_j(x))) <= RTOL
    assert _rel_err(tg.get_proposal_pos_embed(_t(x), 32),
                    jg.get_proposal_pos_embed(_j(x), 32)) <= RTOL
    for k in (2, 3, 14):      # 1 ulp: jnp.linspace rounds its own way
        np.testing.assert_allclose(ta.make_kernel_indices(k).numpy(),
                                   np.asarray(ja.make_kernel_indices(k)),
                                   rtol=1e-6, atol=0)
    mask = rs.rand(2, 37, 53) < 0.3
    for size in ((5, 7), (19, 27), (37, 53)):
        np.testing.assert_array_equal(
            tr.interpolate_mask_nearest(_t(mask), size).numpy(),
            np.asarray(jr.interpolate_mask_nearest(_j(mask), size)))
    feats = [np.zeros((2, h, w, 3), np.float32) for h, w in SHAPES]
    masks = [np.zeros((2, h, w), bool) for h, w in SHAPES]
    for m in masks:
        m[1, :, -2:] = True
    for ms in (None, masks):
        want = jt.create_ref_windows_2d([_j(f) for f in feats],
                                        ms and [_j(m) for m in ms], 4)
        got = tt.create_ref_windows_2d([_t(f) for f in feats],
                                       ms and [_t(m) for m in ms], 4)
        assert _rel_err(got, want) <= RTOL
    assert _rel_err(tt.create_valid_ratios([_t(m) for m in masks]),
                    jt.create_valid_ratios([_j(m) for m in masks])) <= RTOL
    x = np.zeros((2, 37, 53, 3), np.float32)
    for kind in ("fixed", "fixed_box"):
        for m in (None, mask):
            want = jp.build_position_encoding(kind, 32)(_j(x), _j(m), 4)
            got = tp.build_position_encoding(kind, 32)(_t(x), _t(m), 4)
            assert got.shape == want.shape == (2, 37, 53, 32)
            assert _rel_err(got, want) <= RTOL


def _edge_locations(rs, lq, nh, nl, npt):
    """Sampling locations on, just inside and past the level borders."""
    vals = np.array([-0.3, -0.05, 0.0, 1e-3, 0.37, 0.5, 0.999, 1.0, 1.05, 1.3],
                    np.float32)
    return rs.choice(vals, size=(1, lq, nh, nl, npt, 2)).astype(np.float32)


def test_sampling_ops_on_edge_taps():
    """box_attention / instance_attention contract wrappers, hidden 32."""
    import importlib

    # `boxer_tpu.ops` re-exports a function of the module's name
    jb = importlib.import_module("boxer_tpu.ops.box_attention")
    tb = importlib.import_module("boxer_tpu_torch.ops.box_attention")

    rs = np.random.RandomState(1)
    nh, ch, lq, k = 1, 32, 40, 2
    s = sum(h * w for h, w in SHAPES)
    value = rs.randn(1, s, nh, ch).astype(np.float32)
    loc = _edge_locations(rs, lq, nh, len(SHAPES), k * k)
    w = rs.rand(1, lq, nh, len(SHAPES), k * k).astype(np.float32)
    lw = rs.rand(1, lq, nh, len(SHAPES), k * k).astype(np.float32)

    want = jb.box_attention(_j(value), SHAPES, _j(loc), _j(w))
    got = tb.box_attention(_t(value), SHAPES, _t(loc), _t(w))
    assert got.shape == (1, lq, nh * ch)
    assert _rel_err(got, want) <= RTOL

    want = jb.instance_attention(_j(value), SHAPES, _j(loc), _j(w), _j(lw), k)
    got = tb.instance_attention(_t(value), SHAPES, _t(loc), _t(w), _t(lw), k)
    for g, wa in zip(got, want):
        assert g.shape == wa.shape
        assert _rel_err(g, wa) <= RTOL


def test_box_attention_module_folded():
    from boxer_tpu.nn.attention import BoxAttention as JBox
    from boxer_tpu_torch.nn.attention import BoxAttention

    query, value, v_mask, ratios, ref = _attn_inputs(2)
    jm = JBox(64, 2, 2)
    args = (_j(query), _j(value), SHAPES, _j(v_mask), _j(ratios), _j(ref))
    v = random_variables(jm, 3, *args, fold_taps=True)
    want = jm.apply(v, *args, fold_taps=True)
    tm = load_submodule(BoxAttention(64, 2, 2), v,
                        ("transformer", "decoder_layer0", "cross_attn"),
                        "transformer.decoder.layers.0.multihead_attn.")
    with torch.no_grad():
        got = tm(_t(query), _t(value), SHAPES, _t(v_mask), _t(ratios), _t(ref))
    for g, wa in zip(got, want):
        assert _rel_err(g, wa) <= RTOL


@pytest.mark.parametrize("mode", ["inference", "raw_roi"])
def test_instance_attention_module(mode):
    from boxer_tpu.nn.attention import InstanceAttention as JInst
    from boxer_tpu_torch.nn.attention import InstanceAttention

    query, value, v_mask, ratios, ref = _attn_inputs(4)
    jm = JInst(64, 2, 2, kernel_size=14)
    args = (_j(query), _j(value), SHAPES, _j(v_mask), _j(ratios), _j(ref))
    train = mode == "raw_roi"
    v = random_variables(jm, 5, *args, train=train, raw_roi=train)
    want = jm.apply(v, *args, train=train, raw_roi=train)
    tm = load_submodule(InstanceAttention(64, 2, 2, kernel_size=14), v,
                        ("transformer", "decoder_layer0", "cross_attn"),
                        "transformer.decoder.layers.0.multihead_attn.")
    with torch.no_grad():
        got = tm(_t(query), _t(value), SHAPES, _t(v_mask), _t(ratios),
                 _t(ref), emit_roi=train, raw_roi=train)
    assert _rel_err(got[0], want[0]) <= RTOL
    if train:
        assert got[1].shape == (1, 5, 14, 14, 64)
        assert _rel_err(got[1], want[1]) <= RTOL
    else:
        assert got[1] is None and want[1] is None
    for g, wa in zip(got[2], want[2]):
        assert _rel_err(g, wa) <= RTOL


@pytest.mark.parametrize("residual_mode", ["v1", "v2"])
def test_decoder_layer_defer_and_decode_roi(residual_mode):
    from boxer_tpu.nn.box_transformer import DecoderLayer as JDec
    from boxer_tpu_torch.nn.box_transformer import DecoderLayer

    rs = np.random.RandomState(6)
    _, memory, m_mask, ratios, ref = _attn_inputs(6, lq=7)
    tgt = rs.randn(1, 7, 64).astype(np.float32)
    pos = rs.randn(1, 7, 64).astype(np.float32)
    sel = np.array([[5, 0, 3]])
    jm = JDec(64, 2, 2, 128, 0.0, True, residual_mode)
    args = (_j(tgt), _j(pos), _j(memory), SHAPES, _j(m_mask), _j(ratios),
            _j(ref), False, "defer")
    v = random_variables(jm, 7, *args)
    w_tgt, w_def = jm.apply(v, *args)
    w_roi = jm.apply(v, *(x[:, sel[0]] for x in w_def),
                     method=JDec.decode_roi)

    tm = load_submodule(DecoderLayer(64, 2, 2, 128, True, residual_mode), v,
                        ("transformer", "decoder_layer0"),
                        "transformer.decoder.layers.0.")
    with torch.no_grad():
        g_tgt, g_def = tm(_t(tgt), _t(pos), _t(memory), SHAPES, _t(m_mask),
                          _t(ratios), _t(ref), emit_roi="defer")
        g_roi = tm.decode_roi(*(x[:, sel[0]] for x in g_def))
    assert _rel_err(g_tgt, w_tgt) <= RTOL
    for g, wa in zip(g_def, w_def):
        assert _rel_err(g, wa) <= RTOL
    assert g_roi.shape == (1, 3, 14, 14, 64)
    assert _rel_err(g_roi, w_roi) <= RTOL


def test_r10_backbone_with_padding_mask():
    from boxer_tpu.nn.resnet import BackBone as JBack
    from boxer_tpu_torch.nn.resnet import BackBone

    rs = np.random.RandomState(8)
    image = rs.randn(2, 64, 96, 3).astype(np.float32)
    mask = np.zeros((2, 64, 96), bool)
    mask[1, 40:, :] = True
    mask[1, :, 70:] = True
    jm = JBack(arch="resnet10", hidden_dim=32)
    v = random_variables(jm, 9, _j(image), _j(mask))
    w_outs, w_pos = jm.apply(v, _j(image), _j(mask))
    tm = load_submodule(BackBone("resnet10", hidden_dim=32), v,
                        ("backbone",), "backbone.")
    with torch.no_grad():
        g_outs, g_pos = tm(_t(image), _t(mask))
    assert len(g_outs) == len(w_outs) == 3
    for (gf, gm), (wf, wm), gp, wp in zip(g_outs, w_outs, g_pos, w_pos):
        assert gf.shape == wf.shape
        assert _rel_err(gf, wf) <= RTOL
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
        assert _rel_err(gp, wp) <= RTOL


def test_segment_mlp_conv_transpose():
    """The mask head; a missing kernel flip in the converter mirrors every
    2x2 output block and fails here."""
    from boxer_tpu.nn.predictor import SegmentMLP as JSeg
    from boxer_tpu_torch.nn.predictor import SegmentMLP

    rs = np.random.RandomState(10)
    x = rs.randn(1, 1, 6, 7, 7, 32).astype(np.float32)
    select = np.array([4, 0, 2, 2, 1, 3])
    jm = JSeg(32, 5, 2)
    v = random_variables(jm, 11, _j(x))
    tm = load_submodule(SegmentMLP(32, 32, 5, 2), v,
                        ("detector", "mask_embed"), "detector.mask_embed.")
    for sel in (None, select):
        want = jm.apply(v, _j(x), select=_j(sel))
        with torch.no_grad():
            got = tm(_t(x), select=_t(sel))
        assert got.shape == want.shape
        assert _rel_err(got, want) <= RTOL


def test_coco_postprocess():
    from boxer_tpu.evaluate.postprocess import coco_postprocess as jpost
    from boxer_tpu_torch.evaluate.postprocess import coco_postprocess

    rs = np.random.RandomState(12)
    logits = rs.randn(2, 20, 5).astype(np.float32)
    boxes = np.concatenate([rs.uniform(0.2, 0.8, (2, 20, 2)),
                            rs.uniform(0.1, 0.5, (2, 20, 2))],
                           -1).astype(np.float32)
    mask_logits = rs.randn(2, 20, 7, 7).astype(np.float32) * 3
    kw = dict(canvas_hw=(30, 40), topk=10)
    want = jpost(_j(logits), _j(boxes), _j(mask_logits), **kw)
    got = coco_postprocess(_t(logits), _t(boxes), _t(mask_logits), **kw)
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(want["labels"]))
    for key in ("scores", "boxes"):
        assert _rel_err(got[key], want[key]) <= RTOL
    assert np.mean(got["masks"].numpy() != np.asarray(want["masks"])) < 1e-3
