"""K4's plain version (`ops/instance_sample.py:instance_sample_reduce_plain`)
against the JAX package's `instance_attention_qminor`, and the dispatch of
the port's `instance_attention_qminor` between K4 and `QuadSample`.

Inputs come from one numpy seed (`test_torch_kernels.instance_case`: taps
on, just inside and past the level borders and on the cells' edges). Both
sides sum in f32 in another order: rel err <= 1e-5; with a bf16 value both
round their outputs to bf16: 1e-2. The dispatch sends every call that
needs no gradient to K4 (the val forward's decoder layers sample with
train=True under no_grad), and a tiny segm model's eval step launches it
once a decoder layer. The kernel against this plain version is in
`tests/test_torch_kernels.py`; the one case here that needs a card (marker
`gpu`) holds the op's K4 path against its `QuadSample` path, and jax is
imported only inside the JAX cases, so on a card without jax it runs with
`python -m pytest --noconftest -p no:cacheprovider -m gpu
tests/test_torch_instance_sample.py`.
"""

import importlib

import numpy as np
import pytest
import torch

from boxer_tpu_torch.ops import instance_sample
from boxer_tpu_torch.ops.combine_reduce import quad_sample_reduce_w4
from boxer_tpu_torch.ops.instance_sample import instance_sample_reduce_plain
from test_torch_kernels import (INSTANCE_SHAPES, RTOL, _rel_err, cuda,
                                instance_case, instance_inputs)

tb = importlib.import_module("boxer_tpu_torch.ops.box_attention")

LQ = 7


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("k", [2, 14])
@pytest.mark.parametrize("nh", [1, 2])
@pytest.mark.parametrize("b", [1, 2])
def test_plain_matches_jax(b, nh, k, dtype, rtol):
    import jax.numpy as jnp

    jb = importlib.import_module("boxer_tpu.ops.box_attention")
    case = instance_case(b, nh, k, INSTANCE_SHAPES, LQ, seed=b + 4 * nh + k)
    tables, taps = instance_inputs(case, INSTANCE_SHAPES, "cpu", dtype)
    got = instance_sample_reduce_plain(tables, INSTANCE_SHAPES, *taps, k)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jb.instance_attention_qminor(
        jnp.asarray(case[0], jdtype), INSTANCE_SHAPES,
        *(jnp.asarray(a) for a in case[1:]), k, raw=True)
    for g, w in zip(got, want):
        assert g.dtype == dtype and tuple(g.shape) == w.shape
        assert float(np.abs(np.asarray(w, np.float32)).max()) > 0
        assert _rel_err(g.float().numpy(), np.asarray(w, np.float32)) <= rtol


def _call(case, k, requires_grad):
    ts = [torch.from_numpy(a).requires_grad_(requires_grad) for a in case]
    outs = tb.instance_attention_qminor(ts[0], INSTANCE_SHAPES, *ts[1:], k,
                                        raw=True)
    return ts, outs


def _quad_sample_path(ts, k):
    """The op's differentiable path on the tensors `ts` (value, gx, gy,
    spatial_w, level_w): `QuadSample` a level, both sums in torch."""
    tables = tb._build_quad_tables(ts[0], INSTANCE_SHAPES)
    return instance_sample_reduce_plain(tables, INSTANCE_SHAPES, *ts[1:], k,
                                        sample=tb._quad_sample_taps)


def test_gradient_needing_call_takes_quad_sample():
    """Grad mode on and inputs that require grad: outputs with a grad_fn,
    and every input's gradient equal to the `QuadSample` path's."""
    case = instance_case(2, 2, 14, INSTANCE_SHAPES, LQ, seed=60)
    rs = np.random.RandomState(61)
    cot = [torch.from_numpy(rs.randn(*s).astype(np.float32))
           for s in ((2, 2, LQ, 32), (2, LQ, 14, 14, 64))]
    grads = []
    for op in (lambda ts: tb.instance_attention_qminor(
            ts[0], INSTANCE_SHAPES, *ts[1:], 14, raw=True),
            lambda ts: _quad_sample_path(ts, 14)):
        ts = [torch.from_numpy(a).requires_grad_() for a in case]
        outs = op(ts)
        assert all(o.grad_fn is not None for o in outs)
        sum((o * c).sum() for o, c in zip(outs, cot)).backward()
        grads.append([t.grad for t in ts])
    for g, w in zip(*grads):
        assert float(w.abs().max()) > 0
        assert torch.equal(g, w)


@pytest.mark.parametrize("k", [2, 14])
@pytest.mark.parametrize("grad_mode,requires_grad,k4", [
    (False, False, True), (False, True, True), (True, False, True),
    (True, True, False)])
def test_dispatch(monkeypatch, grad_mode, requires_grad, k4, k):
    """K4's wrapper runs exactly when autograd needs no gradient of the
    call (grad mode off, or no input that requires one); its outputs equal
    the `QuadSample` path's."""
    calls = []
    wrapper = tb.instance_sample_reduce

    def counted(*args):
        calls.append(args)
        return wrapper(*args)

    monkeypatch.setattr(tb, "instance_sample_reduce", counted)
    case = instance_case(1, 2, k, INSTANCE_SHAPES, LQ, seed=70)
    with torch.set_grad_enabled(grad_mode):
        _, got = _call(case, k, requires_grad)
    assert len(calls) == int(k4)
    assert all((o.grad_fn is None) == (k4 or not grad_mode or
                                       not requires_grad) for o in got)
    with torch.no_grad():
        want = _quad_sample_path([torch.from_numpy(a) for a in case], k)
    for g, w in zip(got, want):
        assert _rel_err(g.detach().numpy(), w.numpy()) <= 1e-5


def _tensors(tree):
    """The tensors of a model's output, depth first, in key order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def test_eval_step_takes_k4_once_a_decoder_layer(monkeypatch):
    """A tiny segm model's eval step (train=False, inference=False under
    no_grad: every decoder layer samples its RoI with train=True) calls K4's
    wrapper once a decoder layer and never `QuadSample`; its outputs equal
    those of the same forward with grad mode on, which takes `QuadSample`
    in every layer, within 1e-5."""
    from test_torch_boxer2d import TINY, _inputs

    from boxer_tpu_torch.models.boxer2d import BoxeR2D
    from boxer_tpu_torch.parallel.steps import (TrainState, apply_model,
                                                make_eval_step)

    calls, samples = [], []
    wrapper, sample = tb.instance_sample_reduce, tb._quad_sample_taps

    def counted(*args):
        calls.append(args)
        return wrapper(*args)

    def sampled(*args):
        samples.append(args)
        return sample(*args)

    monkeypatch.setattr(tb, "instance_sample_reduce", counted)
    monkeypatch.setattr(tb, "_quad_sample_taps", sampled)
    model = BoxeR2D(**TINY, use_mask=True).init_weights(3)
    image, mask = (torch.from_numpy(a) for a in _inputs(True))
    batch = {"image": image, "mask": mask}
    got = make_eval_step(torch.float32)(TrainState(model, None), batch)
    assert len(calls) == TINY["dec_layers"] and not samples
    want = apply_model(model, batch, train=False, inference=False)
    assert len(calls) == TINY["dec_layers"]
    assert len(samples) == TINY["dec_layers"] * TINY["num_level"]
    got, want = _tensors(got), _tensors(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel_err(g.numpy(), w.detach().numpy()) <= 1e-5


def test_wrapper_raises_on_unsupported_arguments():
    """K4 takes Ch 32 only, 1 to 4 levels with one table each, P = k*k, f32
    contiguous tap inputs and bf16 or f32 tables; anything else raises
    before a launch, and so does a device other than CUDA (meta here)."""
    case = instance_case(1, 2, 2, INSTANCE_SHAPES, LQ, seed=80)
    tables, taps = instance_inputs(case, INSTANCE_SHAPES, "meta")
    before = instance_sample.instance_sample_reduce.launches
    bad = [
        ((tables[:3], INSTANCE_SHAPES, taps, 2), ValueError, "levels"),
        ((tables, INSTANCE_SHAPES, taps, 3), ValueError, "taps for k=3"),
        (([t[:, :64] for t in tables], INSTANCE_SHAPES, taps, 2), ValueError,
         "table must be"),
        ((tables, INSTANCE_SHAPES, [t.double() for t in taps], 2),
         ValueError, "must be f32"),
        ((tables, INSTANCE_SHAPES, taps[:3] + [taps[3][..., :5]], 2),
         ValueError, "must be f32"),
        ((tables, INSTANCE_SHAPES, [t.mT.contiguous().mT for t in taps], 2),
         ValueError, "contiguous"),
        (([t.half() for t in tables], INSTANCE_SHAPES, taps, 2), TypeError,
         "dtype"),
        ((tables, INSTANCE_SHAPES, taps, 2), ValueError, "device"),
    ]
    for (tabs, shapes, ins, k), error, match in bad:
        with pytest.raises(error, match=match):
            instance_sample.instance_sample_reduce(tabs, shapes, *ins, k)
    assert instance_sample.instance_sample_reduce.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, RTOL),
                                        (torch.bfloat16, 1e-2)])
def test_kernel_path_matches_quad_sample_path_on_card(cuda, dtype, rtol):
    """On the card, with no gradient needed: grad mode off, and grad mode
    on with no input that requires one, each launch K4 once (bitwise the
    same outputs); the `QuadSample` path samples each level with K2 and
    sums in torch; the two agree in both outputs (the sums in another
    order)."""
    case = instance_case(2, 4, 14, INSTANCE_SHAPES, 37, seed=90)
    ts = [torch.from_numpy(a).to(cuda) for a in case]
    ts[0] = ts[0].to(dtype)
    k4, k2 = (instance_sample.instance_sample_reduce.launches,
              quad_sample_reduce_w4.launches)
    with torch.no_grad():
        got = tb.instance_attention_qminor(ts[0], INSTANCE_SHAPES, *ts[1:],
                                           14, raw=True)
        torch.cuda.synchronize()
        assert instance_sample.instance_sample_reduce.launches == k4 + 1
        assert quad_sample_reduce_w4.launches == k2
    again = tb.instance_attention_qminor(ts[0], INSTANCE_SHAPES, *ts[1:], 14,
                                         raw=True)
    torch.cuda.synchronize()
    assert instance_sample.instance_sample_reduce.launches == k4 + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    with torch.no_grad():
        want = _quad_sample_path(ts, 14)
        torch.cuda.synchronize()
    assert quad_sample_reduce_w4.launches == k2 + len(INSTANCE_SHAPES)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape
        assert _rel_err(g.float().cpu().numpy(),
                        w.float().cpu().numpy()) <= rtol
