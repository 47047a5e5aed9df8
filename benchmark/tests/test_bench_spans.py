"""The readers of the port's spans (`harness/spans.py`, the nine metrics
that read it) on a synthetic trace with known operations, launches and
ranges, and on a CPU run's trace, which holds the spans and no device
operation."""

import json

import pytest
from conftest import run_cell

from harness import spans, spec, trace

LAYER_METRICS = ("backbone_ms.infer", "encoder_ms.infer", "decoder_ms.infer",
                 "mask_decode_ms.infer")
METRICS = LAYER_METRICS + ("sampling_ms.infer", "quad_tables_ms.infer",
                           "tap_prep_ms.infer", "forward_idle_ms.infer",
                           "forward_launches.infer")
US = 1e-6

# one batch, times in us from its start: the host's ranges, and each
# device operation as (host launch, device start, device end)
RANGES = [("bench.forward", 0, 100), ("boxer.forward", 1, 99),
          ("boxer.backbone", 1, 20), ("boxer.encoder", 20, 50),
          ("boxer.sampling.box", 30, 48),
          ("boxer.sampling.quad_tables", 31, 35),
          ("boxer.sampling.taps", 36, 40), ("boxer.sampling.taps", 41, 43),
          ("boxer.proposals", 50, 55), ("boxer.decoder", 55, 80),
          ("boxer.sampling.instance", 60, 70),
          ("boxer.mask_decode", 80, 99), ("bench.d2h", 100, 130)]
OPS = [(2, 10, 30),       # backbone 20
       (21, 30, 34),      # encoder, outside the sampling op 4
       (32, 34, 44),      # quad tables 10
       (37, 44, 47),      # taps 3
       (42, 47, 49),      # taps 2
       (45, 49, 57),      # the box op's combine 8
       (52, 57, 60),      # proposals 3
       (57, 60, 67),      # decoder 7
       (61, 72, 77),      # instance op 5, after a 5 us gap
       (85, 87, 88),      # mask decode 1, after a 10 us gap
       (101, 120, 125)]   # d2h, outside the forward, after a 32 us gap
# the same operations profiled on the device alone (start, end): in the
# forward, gaps of 2 and 1 us; 9 us after it, before the d2h copy
ALONE = [(5, 25), (25, 29), (29, 39), (39, 42), (42, 44), (44, 52), (52, 55),
         (55, 62), (64, 69), (70, 71), (80, 85)]
BATCH_US = 200


def synthetic(batches: int = 2, forward: bool = True) -> trace.Trace:
    tr = trace.Trace()
    for b in range(batches):
        t0 = b * BATCH_US
        tr.ranges += [(n, (t0 + s) * US, (t0 + e) * US) for n, s, e in RANGES
                      if forward or not n.startswith("boxer.")]
        for i, (launch, s, e) in enumerate(OPS):
            corr = b * 100 + i
            tr.launches[corr] = (t0 + launch) * US
            tr.ops.append((f"k{i}", (t0 + s) * US, (t0 + e) * US, corr))
    tr.window = (0.0, batches * BATCH_US * US)
    return tr


def device_alone(batches: int = 2) -> trace.Trace:
    """The batches of `synthetic` in a profile with no host event."""
    tr = trace.Trace()
    for b in range(batches):
        t0 = b * BATCH_US
        tr.ops += [(f"k{i}", (t0 + s) * US, (t0 + e) * US, None)
                   for i, (s, e) in enumerate(ALONE)]
    tr.window = (tr.ops[0][1], tr.ops[-1][2])
    return tr


def read(name, tr, dev=None):
    return spec.load_module("metrics", name).read(
        {"trace": tr, "device_trace": dev})


def test_each_reader_gives_its_known_value_a_batch():
    tr = synthetic()
    want = {"backbone_ms.infer": 20, "encoder_ms.infer": 4 + 10 + 3 + 2 + 8,
            "decoder_ms.infer": 3 + 7 + 5, "mask_decode_ms.infer": 1,
            "sampling_ms.infer": 10 + 3 + 2 + 8 + 5,
            "quad_tables_ms.infer": 10, "tap_prep_ms.infer": 3 + 2}
    for name, us in want.items():
        assert read(name, tr) == pytest.approx(us * 1e-3), name
    # the device-alone gaps between the forward's first and last operation:
    # not the 9 us before the d2h copy, nor the host stretch's own gaps
    assert read("forward_idle_ms.infer", tr, device_alone()) \
        == pytest.approx((2 + 1) * 1e-3)
    assert read("forward_launches.infer", tr) == len(OPS) - 1


def test_forward_idle_reads_the_forwards_both_stretches_name():
    tr, dev = synthetic(), device_alone()
    # the device-alone profile lost its last records: the first batch's
    # forward is read alone
    dev.ops = dev.ops[:-3]
    assert read("forward_idle_ms.infer", tr, dev) == pytest.approx(3e-3)
    # an operation of the first forward differs: neither is read
    dev = device_alone()
    dev.ops[3] = ("another", *dev.ops[3][1:])
    assert read("forward_idle_ms.infer", tr, dev) is None
    assert read("forward_idle_ms.infer", tr, None) is None


def test_children_fall_inside_their_parents():
    tr = synthetic(batches=3)
    got = {name: read(name, tr, device_alone(3)) for name in METRICS}
    assert got["quad_tables_ms.infer"] + got["tap_prep_ms.infer"] \
        <= got["sampling_ms.infer"]
    assert got["sampling_ms.infer"] <= got["encoder_ms.infer"] \
        + got["decoder_ms.infer"]
    forward = 1e3 * sum(e - s for _, s, e, _ in tr.ops_in(spans.FORWARD)) / 3
    assert sum(got[m] for m in LAYER_METRICS) == pytest.approx(forward)


def test_no_forward_range_reads_none():
    for tr in (synthetic(forward=False), trace.Trace(), None):
        for name in METRICS:
            assert read(name, tr, device_alone()) is None, name


def test_a_cpu_run_holds_the_spans_and_reads_none(small_bench, capsys):
    """A traced run on the CPU: its trace holds a `boxer.forward` range a
    traced batch, the forward launched no device operation, and each
    reader gives None; the run's line leaves them out."""
    import run
    from drivers import infer_closed_loop as drv

    folder = small_bench.parent / "benchmark"
    cell = spec.load_cell(small_bench, "tiny2d.infer", folder)
    family = spec.load_module("families", "boxer2d", folder)
    out = drv.run(cell, family, 2 ** 31 + 9, 0.2, True, "cpu", 0.0,
                  run.CACHE / "scratch")
    tr = out["ctx"]["trace"]
    names = [n for n, _, _ in tr.ranges]
    assert names.count(spans.FORWARD) == cell.traffic["trace_batches"]
    assert "boxer.sampling.quad_tables" in names
    for name in METRICS:
        assert read(name, tr, out["ctx"]["device_trace"]) is None, name

    bench = json.loads(small_bench.read_text())
    for m in bench["per_layer"]:
        if m["name"] in METRICS:
            m["workloads"] = ["tiny2d.infer"]
    small_bench.write_text(json.dumps(bench))
    rc, res = run_cell(small_bench, "tiny2d.infer", trace=1, capsys=capsys)
    assert rc == 0 and res["correct"] is True
    assert not set(METRICS) & set(res["metrics"])
