"""The analytic box-attention backward (`set_box_attention_impl(
"analytic_vjp")`, `ops/box_attention.py:AnalyticBoxAttention`) against the
JAX package's (`_box_attention_vjp`) under the same switch, on the CPU,
where K2 and K5 run their plain versions.

- Op level, `box_attention_qminor(raw=True)` with a seeded cotangent, P in
  {4, 16} (the per-tap forward and the folded one): f32 gradients of
  value, gx, gy and the attention weights at rtol 1e-3 / atol 1e-5
  (`tests/test_box_attention.py:277-279`); bf16 inputs within 0.05 of the
  JAX gradient's max (`:363-365`); f32 against the port's default backward
  (rel 1e-5); `fold=True` under the switch takes the analytic Function too.
- The switch: a bad name raises and leaves it; every test that sets it
  restores it in a `finally`, also after a raise inside the op.
- Remat on against off under the switch (the tiny model of
  `tests/test_torch_train.py`): loss terms equal, gradients within 1e-6,
  the analytic forward's K2 and backward's K5 called as often either way.
- One tiny r10 detection train step with the switch on in both packages:
  loss terms rel 1e-4, the pre-clip gradients' worst leaf 2e-3 (the
  `ROADMAP.md` starting tolerance is 2.2e-3).

The JAX side of the op cases is one jitted `jax.grad` a case, traced once
under the switch in a module-scoped fixture.
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget)
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_modules import _rel_err, _t
from test_torch_remat import _step
from test_torch_train import TINY, _train_step_matches_jax

jb = importlib.import_module("boxer_tpu.ops.box_attention")
tb = importlib.import_module("boxer_tpu_torch.ops.box_attention")

SHAPES = ((6, 7), (3, 4), (5, 2))
CASES = [(4, "float32"), (16, "float32"), (4, "bfloat16"), (16, "bfloat16")]


def _inputs(npt, seed=0, b=2, nh=2, ch=32, lq=30):
    """value (B, S, H, 32), gx, gy (on, inside and past the level borders),
    attention weights (B, H, L, P, LQ) and a cotangent (B, H, LQ, 32)."""
    rs = np.random.RandomState(seed + npt)
    s = sum(h * w for h, w in SHAPES)
    shape = (b, nh, len(SHAPES), npt, lq)
    value = rs.randn(b, s, nh, ch).astype(np.float32)
    gx, gy = rs.uniform(-0.1, 1.1, (2, *shape)).astype(np.float32)
    aw = rs.rand(*shape).astype(np.float32)
    cot = rs.randn(b, nh, lq, ch).astype(np.float32)
    return value, gx, gy, aw, cot


@pytest.fixture(scope="module")
def jax_analytic():
    """{case: (JAX's output, its 4 gradients)} under the analytic switch."""
    want = {}
    jb.set_box_attention_impl("analytic_vjp")
    try:
        for npt, dtype in CASES:
            value, gx, gy, aw, cot = _inputs(npt)
            args = [jnp.asarray(a, dtype) for a in (value, gx, gy, aw)]

            def loss(v, x, y, a):
                out = jb.box_attention_qminor(v, SHAPES, x, y, a, raw=True)
                return (out.astype(jnp.float32) * cot).sum()

            out = jb.box_attention_qminor(args[0], SHAPES, *args[1:],
                                          raw=True)
            grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(*args)
            want[(npt, dtype)] = (np.asarray(out, np.float32),
                                  [np.asarray(g, np.float32) for g in grads])
    finally:
        jb.set_box_attention_impl("xla")
    return want


def _port(npt, dtype, impl, fold=None):
    """The port's output and gradients (as f32 numpy) under `impl`, and the
    name of the output's autograd node."""
    value, gx, gy, aw, cot = _inputs(npt)
    ts = [_t(a).to(getattr(torch, dtype)).requires_grad_()
          for a in (value, gx, gy, aw)]
    tb.set_box_attention_impl(impl)
    try:
        out = tb.box_attention_qminor(ts[0], SHAPES, *ts[1:], raw=True,
                                      fold=fold)
        (out.float() * _t(cot)).sum().backward()
    finally:
        tb.set_box_attention_impl("xla")
    return (out.detach().float().numpy(), [t.grad.float().numpy() for t in ts],
            type(out.grad_fn).__name__)


@pytest.mark.parametrize("npt,dtype", CASES)
def test_analytic_grads_match_jax(jax_analytic, npt, dtype):
    want_out, want = jax_analytic[(npt, dtype)]
    out, got, node = _port(npt, dtype, "analytic_vjp")
    assert node == "AnalyticBoxAttentionBackward"
    names = ("value", "gx", "gy", "attn_weight")
    if dtype == "float32":
        assert _rel_err(out, want_out) <= 1e-5
        for name, g, w in zip(names, got, want):
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-5,
                                       err_msg=name)
    else:
        for name, g, w in zip(names, got, want):
            err = np.abs(g - w).max()
            assert err <= 0.05 * max(np.abs(w).max(), 1e-6), (name, err)


@pytest.mark.parametrize("npt", [4, 16])
def test_analytic_grads_match_the_default_backward(npt):
    out_a, got, _ = _port(npt, "float32", "analytic_vjp")
    out_d, want, _ = _port(npt, "float32", "xla")
    assert _rel_err(out_a, out_d) <= 1e-6
    for name, g, w in zip(("value", "gx", "gy", "attn_weight"), got, want):
        assert _rel_err(g, w) <= 1e-5, name


def test_fold_true_takes_the_analytic_function(jax_analytic):
    """JAX checks the switch before `fold`: the inference flag runs the
    analytic forward and backward too."""
    want_out, want = jax_analytic[(4, "float32")]
    out, got, node = _port(4, "float32", "analytic_vjp", fold=True)
    assert node == "AnalyticBoxAttentionBackward"
    assert _rel_err(out, want_out) <= 1e-5
    for name, g, w in zip(("value", "gx", "gy", "attn_weight"), got, want):
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-5, err_msg=name)


def test_switch_is_checked_and_restored():
    assert tb.get_box_attention_impl() == "xla"
    with pytest.raises(ValueError):
        tb.set_box_attention_impl("pallas")
    assert tb.get_box_attention_impl() == "xla"
    value, gx, gy, aw, _ = _inputs(4)
    tb.set_box_attention_impl("analytic_vjp")
    try:
        assert tb.get_box_attention_impl() == "analytic_vjp"
        with pytest.raises(AssertionError):          # one level too few
            tb.box_attention_qminor(_t(value), SHAPES[:2], _t(gx), _t(gy),
                                    _t(aw))
    finally:
        tb.set_box_attention_impl("xla")
    assert tb.get_box_attention_impl() == "xla"
    from boxer_tpu_torch import ops

    assert ops.set_box_attention_impl is tb.set_box_attention_impl
    assert ops.box_attention is tb.box_attention


@pytest.mark.parametrize("use_mask", [True, False], ids=["segm", "det"])
def test_remat_under_the_switch(monkeypatch, use_mask):
    tb.set_box_attention_impl("analytic_vjp")
    try:
        on, n_on = _step(monkeypatch, use_mask, 0.0, remat=True)
        off, n_off = _step(monkeypatch, use_mask, 0.0, remat=False)
    finally:
        tb.set_box_attention_impl("xla")
    losses = [k for k in off if k.startswith("loss_")]
    assert losses and all(on[k] == off[k] for k in losses)
    worst = max(float((on["_grads"][n] - g).abs().max())
                for n, g in off["_grads"].items() if g is not None)
    assert worst <= 1e-6, worst
    # every box-attention level: one K2 forward and one K5 backward either
    # way (segm: the encoder's; the decoder's instance attention keeps its
    # own op, K2 and K6 a level)
    levels = 4 * (TINY["enc_layers"] + TINY["dec_layers"])
    assert n_on["quad_sample_reduce_w4"] == n_off["quad_sample_reduce_w4"]
    assert n_off["quad_sample_reduce_w4"] == levels
    assert n_on["scatter_add_rows_weighted_dw4"] == n_off[
        "scatter_add_rows_weighted_dw4"] == levels


def test_train_step_under_the_switch_matches_jax(monkeypatch):
    """Detection, so every box-attention level of the encoder and the
    decoder takes the analytic Function on both sides."""
    calls = []
    forward = tb._analytic_forward
    monkeypatch.setattr(tb, "_analytic_forward",
                        lambda *a: calls.append(1) or forward(*a))
    jb.set_box_attention_impl("analytic_vjp")
    tb.set_box_attention_impl("analytic_vjp")
    try:
        _train_step_matches_jax(use_mask=False)
    finally:
        jb.set_box_attention_impl("xla")
        tb.set_box_attention_impl("xla")
    assert len(calls) == TINY["enc_layers"] + TINY["dec_layers"]
