"""K4's plain version (`ops/instance_sample.py:instance_sample_reduce_plain`)
against the JAX package's `instance_attention_qminor`, and the dispatch of
the port's `instance_attention_qminor` between K4 and `QuadSample`.

Inputs come from one numpy seed (`test_torch_kernels.instance_case`: taps
on, just inside and past the level borders and on the cells' edges). Both
sides sum in f32 in another order: rel err <= 1e-5; with a bf16 value both
round their outputs to bf16: 1e-2. The kernel against this plain version is
in `tests/test_torch_kernels.py`; the one case here that needs a card
(marker `gpu`) holds the op's K4 path against its `QuadSample` path, and
jax is imported only inside the JAX case, so on a card without jax it runs
with `python -m pytest --noconftest -p no:cacheprovider -m gpu
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


def _call(case, k, train, requires_grad):
    ts = [torch.from_numpy(a).requires_grad_(requires_grad) for a in case]
    outs = tb.instance_attention_qminor(ts[0], INSTANCE_SHAPES, *ts[1:], k,
                                        raw=True, train=train)
    return ts, outs


def test_gradient_needing_call_takes_quad_sample():
    """train=False with grad mode on and inputs that require grad: outputs
    with a grad_fn, and every input's gradient equal to train=True's."""
    case = instance_case(2, 2, 14, INSTANCE_SHAPES, LQ, seed=60)
    rs = np.random.RandomState(61)
    cot = [torch.from_numpy(rs.randn(*s).astype(np.float32))
           for s in ((2, 2, LQ, 32), (2, LQ, 14, 14, 64))]
    grads = []
    for train in (False, True):
        ts, outs = _call(case, 14, train, requires_grad=True)
        assert all(o.grad_fn is not None for o in outs)
        sum((o * c).sum() for o, c in zip(outs, cot)).backward()
        grads.append([t.grad for t in ts])
    for g, w in zip(*grads):
        assert float(w.abs().max()) > 0
        assert torch.equal(g, w)


@pytest.mark.parametrize("train,grad_mode,requires_grad,k4", [
    (False, False, True, True), (False, True, False, True),
    (False, True, True, False), (True, False, False, False),
    (True, True, True, False)])
def test_dispatch(monkeypatch, train, grad_mode, requires_grad, k4):
    """K4's wrapper runs exactly when train=False and autograd needs no
    gradient of the call (grad mode off, or no input that requires one);
    both paths give the same outputs."""
    calls = []
    wrapper = tb.instance_sample_reduce

    def counted(*args):
        calls.append(args)
        return wrapper(*args)

    monkeypatch.setattr(tb, "instance_sample_reduce", counted)
    case = instance_case(1, 2, 2, INSTANCE_SHAPES, LQ, seed=70)
    with torch.set_grad_enabled(grad_mode):
        _, got = _call(case, 2, train, requires_grad)
    assert len(calls) == int(k4)
    assert all((o.grad_fn is None) == (k4 or not grad_mode or
                                       not requires_grad) for o in got)
    with torch.no_grad():
        _, want = _call(case, 2, not train, False)
    for g, w in zip(got, want):
        assert _rel_err(g.detach().numpy(), w.numpy()) <= 1e-5


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
    """On the card, with no gradient needed: train=False launches K4 once,
    train=True samples each level with K2 and sums in torch; the two agree
    in both outputs (the sums in another order)."""
    case = instance_case(2, 4, 14, INSTANCE_SHAPES, 37, seed=90)
    ts = [torch.from_numpy(a).to(cuda) for a in case]
    ts[0] = ts[0].to(dtype)
    k4, k2 = (instance_sample.instance_sample_reduce.launches,
              quad_sample_reduce_w4.launches)
    with torch.no_grad():
        got = tb.instance_attention_qminor(ts[0], INSTANCE_SHAPES, *ts[1:],
                                           14, raw=True, train=False)
        torch.cuda.synchronize()
        assert instance_sample.instance_sample_reduce.launches == k4 + 1
        assert quad_sample_reduce_w4.launches == k2
        want = tb.instance_attention_qminor(ts[0], INSTANCE_SHAPES, *ts[1:],
                                            14, raw=True, train=True)
        torch.cuda.synchronize()
    assert quad_sample_reduce_w4.launches == k2 + len(INSTANCE_SHAPES)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape
        assert _rel_err(g.float().cpu().numpy(),
                        w.float().cpu().numpy()) <= rtol
