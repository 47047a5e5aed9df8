"""The port's spans (`utils/timer.py:span`) on the CPU: free and silent
while no profiler runs, and under one, named ranges at each layer boundary
of the segm forward and the train step that nest as the layers do.

A tiny segm model (`test_torch_boxer2d.py`'s TINY widths: r10, hidden 32,
1 encoder and 2 decoder layers, 16 queries) on a 64x96 canvas, f32, seeded
weights, with the top-k postprocess; the train step is
`test_torch_train.py`'s tiny segm step. The 3D forward is
`test_torch_boxer3d_reference.py`'s small BoxeR-3D on one seeded frame.
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget)
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_boxer2d import POST, TINY, _inputs

from boxer_tpu_torch.utils import timer

LAYERS = ("boxer.backbone", "boxer.encoder", "boxer.proposals",
          "boxer.decoder", "boxer.mask_decode")
LAYERS_3D = ("boxer.backbone", "boxer.encoder", "boxer.proposals",
             "boxer.decoder")
TRAIN = ("boxer.train.forward", "boxer.train.loss", "boxer.train.backward",
         "boxer.train.grad_sync", "boxer.train.optimizer")


@pytest.fixture(scope="module")
def segm():
    from boxer_tpu_torch.models.boxer2d import BoxeR2D

    model = BoxeR2D(**TINY, use_mask=True).init_weights(0).eval()
    image, mask = (torch.from_numpy(a) for a in _inputs(padded=True))
    return lambda: model(image, mask, postprocess=POST)


@pytest.fixture(scope="module")
def pp3d():
    from test_torch_boxer3d_reference import GRID, _frame, _port

    model, args = _port(1), _frame(1)
    return lambda: model(*args, GRID, 1, inference=True)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof.events(), out


def _ranges(events, name):
    return sorted((e.time_range.start, e.time_range.end) for e in events
                  if e.name == name)


def _inside(t, ranges):
    return any(s <= t[0] and t[1] <= e for s, e in ranges)


def test_span_without_a_profiler_is_one_shared_no_op(segm, monkeypatch):
    assert not torch._C._autograd._profiler_enabled()
    assert timer.span("boxer.forward") is timer.span("boxer.encoder")
    calls = []
    record = torch.profiler.record_function

    def counted(*args, **kw):
        calls.append(args)
        return record(*args, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    with torch.no_grad():
        segm()
    assert calls == []


def test_segm_forward_spans_nest_as_its_layers(segm):
    with torch.no_grad():
        events, _ = _profiled(segm)
    forward = _ranges(events, "boxer.forward")
    assert len(forward) == 1
    found = [_ranges(events, n) for n in LAYERS]
    assert [len(r) for r in found] == [1] * len(LAYERS)
    # in the forward, one after the other in LAYERS' order
    layers = [r[0] for r in found]
    assert all(_inside(t, forward) for t in layers)
    assert all(a[1] <= b[0] for a, b in zip(layers, layers[1:]))

    sampling = {e.name for e in events if e.name.startswith("boxer.sampling")}
    assert sampling == {"boxer.sampling.box", "boxer.sampling.instance",
                        "boxer.sampling.quad_tables", "boxer.sampling.taps"}
    # one call a layer: the encoder's box attention, the decoder's instance
    # attention (box-sampled in the first layer, the op in the last)
    calls = _ranges(events, "boxer.sampling.box") + _ranges(
        events, "boxer.sampling.instance")
    assert len(calls) == TINY["enc_layers"] + TINY["dec_layers"]
    assert sum(_inside(t, layers[1:2]) for t in calls) == TINY["enc_layers"]
    assert sum(_inside(t, layers[3:4]) for t in calls) == TINY["dec_layers"]
    for name in ("boxer.sampling.quad_tables", "boxer.sampling.taps"):
        assert all(_inside(t, calls) for t in _ranges(events, name)), name

    # every op of the forward falls in one of the five layers
    outside = [e.name for e in events if e.name.startswith("aten::")
               and _inside((e.time_range.start, e.time_range.end), forward)
               and not _inside((e.time_range.start, e.time_range.end),
                               layers)]
    assert outside == []


def test_train_step_spans():
    from test_torch_train import _batch, _port_setup, _to_torch

    state, step = _port_setup(True, seed=0, debug_grads=False)
    batch = _to_torch(_batch(True))
    events, (_, stats) = _profiled(lambda: step(state, batch))
    assert stats["skipped"] == 0.0
    for name in TRAIN:
        assert _ranges(events, name), name
    loss = _ranges(events, "boxer.train.loss")
    matcher = _ranges(events, "boxer.train.matcher")
    assert matcher and all(_inside(t, loss) for t in matcher)
    assert all(_inside(t, _ranges(events, "boxer.train.forward"))
               for t in _ranges(events, "boxer.forward"))


def test_outputs_equal_with_and_without_a_profiler(segm):
    with torch.no_grad():
        want = segm()
        _, got = _profiled(segm)
    assert sorted(got) == sorted(want) == ["boxes", "labels", "masks",
                                           "scores"]
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert np.isfinite(want["scores"].numpy()).all()


def test_3d_forward_spans_nest_as_its_layers(pp3d):
    """`boxer.pillars` and `boxer.neck` inside `boxer.backbone`; then the
    encoder, the proposals, the decoder layers and the head's second
    `boxer.decoder`, one after the other; every op of the forward in one
    of them."""
    from test_torch_boxer3d_reference import MODEL

    with torch.no_grad():
        events, _ = _profiled(pp3d)
    forward = _ranges(events, "boxer.forward")
    assert len(forward) == 1
    found = {n: _ranges(events, n) for n in LAYERS_3D + (
        "boxer.pillars", "boxer.neck")}
    assert {n: len(r) for n, r in found.items()} == {
        "boxer.backbone": 1, "boxer.encoder": 1, "boxer.proposals": 1,
        "boxer.decoder": 2, "boxer.pillars": 1, "boxer.neck": 1}
    layers = [t for n in LAYERS_3D for t in found[n]]
    assert all(_inside(t, forward) for t in layers)
    assert all(a[1] <= b[0] for a, b in zip(layers, layers[1:]))
    pillars, neck = found["boxer.pillars"][0], found["boxer.neck"][0]
    assert _inside(pillars, found["boxer.backbone"])
    assert _inside(neck, found["boxer.backbone"]) and pillars[1] <= neck[0]

    calls = _ranges(events, "boxer.sampling.box")
    assert len(calls) == MODEL["enc_layers"] + MODEL["dec_layers"]
    assert sum(_inside(t, found["boxer.encoder"]) for t in calls) == MODEL[
        "enc_layers"]
    assert sum(_inside(t, found["boxer.decoder"][:1]) for t in calls) == \
        MODEL["dec_layers"]
    # inference samples through K9: no quad tables, no taps
    assert not {e.name for e in events} & {"boxer.sampling.quad_tables",
                                           "boxer.sampling.taps"}
    outside = [e.name for e in events if e.name.startswith("aten::")
               and _inside((e.time_range.start, e.time_range.end), forward)
               and not _inside((e.time_range.start, e.time_range.end),
                               layers)]
    assert outside == []


def test_3d_outputs_equal_with_and_without_a_profiler(pp3d):
    with torch.no_grad():
        want = pp3d()
        _, got = _profiled(pp3d)
    for k in ("pred_logits", "pred_boxes"):
        assert torch.equal(got[k], want[k]), k
    assert torch.isfinite(want["pred_boxes"]).all()
