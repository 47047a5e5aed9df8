"""The port's keyed dropout (`boxer_tpu_torch/nn/dropout.py`) against the
JAX package's dropout sites, and the key's own properties, on the CPU.

- Every dropout site of a layer against JAX at p = 0.1, f32: in the test
  (never in the packages) `jax.random.bernoulli`, which flax's `Dropout`
  and its attention's probability dropout both call, is replaced by masks
  drawn with numpy from a seed in call order; the port takes the same
  masks, in its own call order, through `dropout.supplied_masks`. Held
  at the layer level: JAX's scanned encoder traces one layer for all of
  them, so masks injected into a whole JAX model would repeat from layer
  to layer. The BoxeR-2D encoder layer, the decoder layer in segm (RoI
  residual modes v1 and v2) and detection, the BoxeR-3D encoder and
  decoder layers, and DETR's post- and pre-norm encoder and decoder layers
  (with a padding mask, in torch's meaning at the layer), each output
  within rel err 1e-5 (max abs difference over the output's max abs: a
  pre-norm output reaches 8), and as many draws of the same sizes on both
  sides.
  At dropout > 0 the JAX decoders take flax's `MultiHeadDotProductAttention`
  (its (C, H, D) kernels load through the weight bridge).
- The key: the same key draws bitwise the same masks; another rank,
  microbatch or update draws others; the drop rate lies within 4 sigma of
  p and every survivor is x / (1 - p); the attention mask is one (Lq, Lk)
  draw shared over the batch and the heads; dropout 0, or a train forward
  without a key, leaves the outputs and gradients bitwise as they were;
  at dropout > 0 training without a key raises.
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_modules import (SHAPES, _attn_inputs, _j, _rel_err, _t,
                                load_submodule, random_variables)

from boxer_tpu_torch.nn import dropout
from boxer_tpu_torch.nn.dropout import DropoutKey

P = 0.1
KEY = DropoutKey(seed=7, update=3)


class Masks:
    """`jax.random.bernoulli` in JAX's call order from a numpy seed; the
    port's seam replays the draws in its own call order."""

    def __init__(self, seed):
        self.rs = np.random.RandomState(seed)
        self.drawn, self.replayed = [], 0

    def bernoulli(self, key, p=0.5, shape=None):
        mask = self.rs.rand(*shape) < p
        self.drawn.append(mask)
        return jnp.asarray(mask)

    def supply(self, site, shape):
        mask = self.drawn[self.replayed]
        self.replayed += 1
        assert mask.size == int(np.prod(shape)), (site, mask.shape, shape)
        return torch.from_numpy(mask.reshape(shape))


def _hold(monkeypatch, jax_fn, port_fn):
    """jax_fn() and port_fn() (lists of outputs) on the same masks: each
    output within rel err 1e-5 (max abs difference over the output's max
    abs). Returns the draws' shapes."""
    masks = Masks(0)
    monkeypatch.setattr(jax.random, "bernoulli", masks.bernoulli)
    want = jax_fn()
    with dropout.supplied_masks(masks.supply), torch.no_grad():
        got = port_fn()
    assert masks.replayed == len(masks.drawn) > 2
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel_err(g, w) <= 1e-5
    return [m.shape for m in masks.drawn]


def _rng():
    return {"dropout": jax.random.PRNGKey(0)}


def test_encoder_layer_sites_match_jax(monkeypatch):
    from boxer_tpu.nn.box_transformer import EncoderLayer as JEnc
    from boxer_tpu_torch.nn.box_transformer import EncoderLayer

    s = sum(h * w for h, w in SHAPES)
    src, _, mask, ratios, _ = _attn_inputs(0)
    rs = np.random.RandomState(1)
    src = rs.randn(1, s, 64).astype(np.float32)
    pos = rs.randn(1, s, 64).astype(np.float32)
    ref = np.concatenate([rs.uniform(0.1, 0.9, (1, s, 2)),
                          rs.uniform(0.1, 0.5, (1, s, 2))],
                         -1).astype(np.float32)
    mask = rs.rand(1, s) < 0.2
    jm = JEnc(64, 2, 2, 128, P, SHAPES, deterministic=False)
    args = (_j(src), _j(pos), _j(mask), _j(ratios), _j(ref))
    v = random_variables(jm, 2, *args)
    tm = load_submodule(EncoderLayer(64, 2, 2, 128, P), v,
                        ("transformer", "encoder_layer0"),
                        "transformer.encoder.layers.0.")
    shapes = _hold(monkeypatch,
                   lambda: [jm.apply(v, *args, rngs=_rng())[0]],
                   lambda: [tm(_t(src), _t(pos), SHAPES, _t(mask),
                               _t(ratios), _t(ref), key=KEY)])
    assert len(shapes) == 3


@pytest.mark.parametrize("use_mask,residual_mode", [
    (True, "v1"), (True, "v2"), (False, "v1")],
    ids=["segm-v1", "segm-v2", "det"])
def test_decoder_layer_sites_match_jax(monkeypatch, use_mask, residual_mode):
    """The self-attention's probabilities, the residuals, the FFN and, in
    segm, the RoI's residuals and FFN."""
    from boxer_tpu.nn.box_transformer import DecoderLayer as JDec
    from boxer_tpu_torch.nn.box_transformer import DecoderLayer

    _, memory, m_mask, ratios, ref = _attn_inputs(6, lq=7)
    rs = np.random.RandomState(6)
    tgt = rs.randn(1, 7, 64).astype(np.float32)
    pos = rs.randn(1, 7, 64).astype(np.float32)
    jm = JDec(64, 2, 2, 128, P, use_mask, residual_mode)
    args = (_j(tgt), _j(pos), _j(memory), SHAPES, _j(m_mask), _j(ratios),
            _j(ref), True, use_mask)
    v = random_variables(jm, 7, *args)
    assert "query" in v["params"]["self_attn"]      # flax's attention
    tm = load_submodule(
        DecoderLayer(64, 2, 2, 128, use_mask, residual_mode, P), v,
        ("transformer", "decoder_layer0"), "transformer.decoder.layers.0.")

    def port():
        out, roi = tm(_t(tgt), _t(pos), _t(memory), SHAPES, _t(m_mask),
                      _t(ratios), _t(ref), emit_roi=use_mask, train=True,
                      key=KEY)
        return [out] + ([roi] if use_mask else [])

    shapes = _hold(monkeypatch, lambda: [
        x for x in jm.apply(v, *args, rngs=_rng()) if x is not None], port)
    assert shapes[0] == (1, 1, 7, 7)       # one mask over batch and heads
    assert len(shapes) == {"v1": 8, "v2": 7}[residual_mode] if use_mask \
        else len(shapes) == 5


def _box3d_inputs(seed, lq, nh=8, per_head=False):
    rs = np.random.RandomState(seed)
    s = sum(h * w for h, w in SHAPES)
    shape = (1, lq, nh) if per_head else (1, lq)
    ref = np.concatenate([rs.uniform(0.1, 0.9, shape + (2,)),
                          rs.uniform(0.1, 0.5, shape + (2,)),
                          rs.rand(*shape, 1)], -1).astype(np.float32)
    return (rs.randn(1, lq, 64).astype(np.float32),
            rs.randn(1, lq, 64).astype(np.float32),
            rs.randn(1, s, 64).astype(np.float32), ref)


def test_box3d_layer_sites_match_jax(monkeypatch):
    from test_torch_boxer3d import _spread

    from boxer_tpu.nn.box3d_transformer import (
        Box3dDecoderLayer as JDec, Box3dEncoderLayer as JEnc)
    from boxer_tpu_torch.nn.box3d_transformer import (Box3dDecoderLayer,
                                                      Box3dEncoderLayer)

    s = sum(h * w for h, w in SHAPES)
    src, pos, _, ref = _box3d_inputs(0, s, per_head=True)
    je = JEnc(64, 8, 2, 128, P)
    eargs = (_j(src), _j(pos), SHAPES, _j(ref), True)
    ve = _spread(random_variables(je, 1, *eargs))
    te = load_submodule(Box3dEncoderLayer(64, 8, 2, 128, P), ve,
                        ("transformer", "encoder_layer0"),
                        "transformer.encoder.layers.0.")
    shapes = _hold(monkeypatch, lambda: [je.apply(ve, *eargs, rngs=_rng())],
                   lambda: [te(_t(src), _t(pos), SHAPES, _t(ref), key=KEY)])
    assert len(shapes) == 3

    tgt, qpos, memory, ref = _box3d_inputs(2, 9)
    jd = JDec(64, 8, 2, 128, P)
    dargs = (_j(tgt), _j(qpos), _j(memory), SHAPES, _j(ref), True)
    vd = _spread(random_variables(jd, 3, *dargs))
    td = load_submodule(Box3dDecoderLayer(64, 8, 2, 128, P), vd,
                        ("transformer", "decoder_layer0"),
                        "transformer.decoder.layers.0.")
    shapes = _hold(monkeypatch, lambda: [jd.apply(vd, *dargs, rngs=_rng())],
                   lambda: [td(_t(tgt), _t(qpos), _t(memory), SHAPES,
                               _t(ref), key=KEY)])
    assert shapes[0] == (1, 1, 9, 9) and len(shapes) == 5


@pytest.mark.parametrize("normalize_before", [False, True],
                         ids=["post-norm", "pre-norm"])
def test_detr_layer_sites_match_jax(monkeypatch, normalize_before):
    """DETR's layers with a padding mask (True = padded, the meaning a
    JAX layer takes; its `Transformer` is what turns it round) and the
    self- and cross-attention probabilities."""
    from boxer_tpu.nn.transformer import (
        TransformerDecoderLayer as JDec, TransformerEncoderLayer as JEnc)
    from boxer_tpu_torch.nn.transformer import (TransformerDecoderLayer,
                                                TransformerEncoderLayer)

    rs = np.random.RandomState(4)
    src, pos = (rs.randn(2, 10, 32).astype(np.float32) for _ in range(2))
    pad = np.zeros((2, 10), bool)
    pad[1, 7:] = True
    je = JEnc(32, 4, 64, P, normalize_before)
    eargs = (_j(src), _j(pos), _j(pad), True)
    ve = random_variables(je, 5, *eargs)
    te = load_submodule(TransformerEncoderLayer(32, 4, 64, P,
                                                normalize_before), ve,
                        ("transformer", "encoder_layer0"),
                        "transformer.encoder.layers.0.")
    shapes = _hold(monkeypatch, lambda: [je.apply(ve, *eargs, rngs=_rng())],
                   lambda: [te(_t(src), _t(pos), _t(pad), key=KEY)])
    assert shapes[0] == (1, 1, 10, 10) and len(shapes) == 4

    tgt, qpos = (rs.randn(2, 6, 32).astype(np.float32) for _ in range(2))
    jd = JDec(32, 4, 64, P, normalize_before)
    dargs = (_j(tgt), _j(src), _j(qpos), _j(pos), _j(pad), True)
    vd = random_variables(jd, 6, *dargs)
    td = load_submodule(TransformerDecoderLayer(32, 4, 64, P,
                                                normalize_before), vd,
                        ("transformer", "decoder_layer0"),
                        "transformer.decoder.layers.0.")
    shapes = _hold(monkeypatch, lambda: [jd.apply(vd, *dargs, rngs=_rng())],
                   lambda: [td(_t(tgt), _t(src), _t(qpos), _t(pos),
                               _t(pad), key=KEY)])
    assert shapes[:3] == [(1, 1, 6, 6), (2, 6, 32), (1, 1, 6, 10)]
    assert len(shapes) == 6


# ---------------------------------------------------------------------------
# the key


def _site(rate=P, name="transformer.encoder.layers.0.dropout"):
    d = dropout.Dropout(rate)
    d.site = name
    return d


def test_same_key_same_masks_other_keys_others():
    from dataclasses import replace

    d = _site()
    x = torch.ones(4096)
    base = d(x, KEY)
    assert torch.equal(base, d(x, DropoutKey(seed=7, update=3)))
    others = [d(x, replace(KEY, **kw)) for kw in (
        {"rank": 1, "world": 2}, {"microbatch": 1}, {"update": 4},
        {"seed": 8})]
    others += [d(x, KEY, index=1), _site(name="other")(x, KEY)]
    for o in others:
        assert not torch.equal(o, base)
    # the rank and the world size both enter the key
    assert not torch.equal(d(x, replace(KEY, world=2)), base)


def test_drop_rate_and_survivor_scale():
    n = 200_000
    x = torch.ones(n)
    out = _site()(x, KEY)
    dropped = float((out == 0).float().mean())
    assert abs(dropped - P) <= 4 * (P * (1 - P) / n) ** 0.5
    assert torch.equal(out[out != 0],
                       torch.full_like(out[out != 0], 1.0) / (1.0 - P))
    assert torch.equal(_site(0.0)(x, KEY), x)        # rate 0 draws nothing
    assert torch.equal(_site()(x, None), x)          # nor does no key


def test_attention_mask_is_shared_over_batch_and_heads():
    """One (Lq, Lk) draw; the probabilities of every batch element and
    head are multiplied by the same keep / keep_prob."""
    import math

    from boxer_tpu_torch.nn.dense_attention import MultiHeadAttention

    from boxer_tpu_torch.nn.init import reset_default_

    torch.manual_seed(0)
    attn = MultiHeadAttention(32, 4, P)
    reset_default_(attn, torch.Generator().manual_seed(0))
    dropout.name_sites(attn)
    q, k = torch.randn(3, 5, 32), torch.randn(3, 7, 32)
    drawn = []
    keep = torch.rand((5, 7), generator=KEY.generator("dropout:0", "cpu")
                      ) < 1 - P
    with torch.no_grad():
        got = attn(q, k, k, dropout_key=KEY)
        with dropout.supplied_masks(
                lambda site, shape: drawn.append((site, shape)) or keep):
            assert torch.equal(attn(q, k, k, dropout_key=KEY), got)
        assert drawn == [("dropout:0", (5, 7))]
        wq, wk, wv = attn.in_proj_weight.chunk(3)
        bq, bk, bv = attn.in_proj_bias.chunk(3)
        heads = [(x @ w.T + b).reshape(3, -1, 4, 8).transpose(1, 2)
                 for x, w, b in ((q, wq, bq), (k, wk, bk), (k, wv, bv))]
        p = torch.softmax(heads[0] @ heads[1].transpose(-1, -2)
                          / math.sqrt(8), dim=-1)
        p = p * (keep.float() / (1 - P))                 # (B, H, Lq, Lk)
        want = attn.out_proj((p @ heads[2]).transpose(1, 2).reshape(3, 5, 32))
    assert (got - want).abs().max() <= 1e-5


def test_dropout_zero_and_no_key_leave_the_step_bitwise():
    """At dropout 0 a key changes nothing; at dropout 0.1 the eval forward
    equals the dropout-0 model's; training at 0.1 without a key raises."""
    from test_torch_boxer2d import TINY, _inputs

    from boxer_tpu_torch.models.boxer2d import BoxeR2D

    image, mask = (torch.from_numpy(a) for a in _inputs(True))

    def grads(model, key):
        out = model(image, mask, train=True, inference=False,
                    dropout_key=key)
        loss = out["pred_logits"].sum() + out["pred_boxes"].sum()
        model.zero_grad()
        loss.backward()
        return [out["pred_logits"]] + [p.grad.clone() for p in
                                       model.parameters()
                                       if p.grad is not None]

    plain = BoxeR2D(**TINY, use_mask=True).init_weights(1)
    a, b = grads(plain, None), grads(plain, KEY)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))

    dropped = BoxeR2D(**TINY, use_mask=True, dropout=P)
    dropped.load_state_dict(plain.state_dict())
    with torch.no_grad():
        want = plain(image, mask)
        got = dropped(image, mask, dropout_key=KEY)
    assert all(torch.equal(got[k], want[k]) for k in ("pred_logits",
                                                       "pred_boxes"))
    assert not torch.equal(grads(dropped, KEY)[0], a[0])
    with pytest.raises(ValueError, match="dropout_key"):
        dropped(image, mask, train=True, inference=False)
