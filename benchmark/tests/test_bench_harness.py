"""The harness on the CPU: cells found by name, a new configuration, mix
and metric picked up from files alone, the metric arithmetic, and no JAX
in a run's process."""

import json
import subprocess
import sys
import textwrap

import pytest
from conftest import BENCH, ROOT, run_cell

from harness import spec, stats, trace


def test_cells_are_found_by_name():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(ROOT / "BENCHMARK.json", w["name"])
        assert cell.config["family"]
        assert (BENCH / "families" / f"{cell.config['family']}.py").is_file()
        assert (BENCH / "drivers" / f"{cell.traffic['driver']}.py").is_file()
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names
            assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    with pytest.raises(KeyError):
        spec.load_cell(ROOT / "BENCHMARK.json", "no_such_cell")


def test_new_config_mix_and_metric_by_files_alone(small_bench, capsys):
    """A configuration, a traffic mix and a per-layer metric added as files,
    with entries in BENCHMARK.json, run with no edit to a file that is
    there."""
    folder = small_bench.parent / "benchmark"
    cfg = json.loads((folder / "configs" / "tiny2d.json").read_text())
    cfg["model"]["num_queries"] = 20
    (folder / "configs" / "dummy_cfg.json").write_text(json.dumps(cfg))
    mix = json.loads((folder / "traffic" / "tiny2d.json").read_text())
    mix["batch"] = 1
    mix["check"]["samples"] = 1
    (folder / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    (folder / "metrics" / "dummy_metric.py").write_text(textwrap.dedent('''
        def read(ctx):
            return float(len(ctx["latencies"]))
        '''))
    bench = json.loads(small_bench.read_text())
    bench["configs"].append({"name": "dummy_cfg", "source": "test",
                             "file": "benchmark/configs/dummy_cfg.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy_cfg",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({
        "name": "dummy_metric", "unit": "batches", "better": "higher",
        "source": "host_clock", "layer": "test", "moves": "infer_samples_s",
        "workloads": ["dummy.cell"]})
    small_bench.write_text(json.dumps(bench))

    rc, res = run_cell(small_bench, "dummy.cell", trace=1, capsys=capsys)
    assert rc == 0
    assert res["metrics"]["dummy_metric"]["value"] >= 1
    assert res["correct"] is True
    assert list(res)[-1] == "check"
    rc, res = run_cell(small_bench, "dummy.cell", trace=0, capsys=capsys)
    assert rc == 0
    assert set(res["metrics"]) == {"infer_samples_s", "infer_ms_p95",
                                   "peak_gib", "setup_s"}


def test_union_counts_overlaps_once():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7), (10.0, 12.0)]
    assert stats.union_length(iv) == pytest.approx(3.0 + 1.0 + 2.0)
    assert stats.union_length(iv, 1.5, 11.0) == pytest.approx(1.5 + 1.0 + 1.0)
    assert stats.gaps(iv, 0.0, 12.0) == [(3.0, 5.0), (6.0, 10.0)]


def test_trace_busy_idle_and_ranges():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW,
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "bench.forward",
         "ts": 0, "dur": 40},
        {"ph": "X", "cat": "user_annotation", "name": "sampling.box_attention",
         "ts": 10, "dur": 5},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 11, "dur": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel",
         "ts": 30, "dur": 1, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "k7", "ts": 20, "dur": 30,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "k8", "ts": 40, "dur": 20,
         "args": {"correlation": 8}},
    ]
    tr = trace.parse(ev)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s() == pytest.approx(40e-6)
    assert [op[0] for op in tr.ops_in("sampling.box_attention")] == ["k7"]
    bd = tr.breakdown()
    assert bd["device_ops"][0][0] == "k7"
    assert bd["idle_gaps"][0] == ["bench.between_batches",
                                  pytest.approx(40e-6)]
    assert bd["idle_gaps"][1] == ["bench.forward", pytest.approx(20e-6)]


def test_device_alone_trace_spans_its_operations():
    """A profile of the device alone has no ranges: its window runs from
    the first operation's start to the last one's end, and the idle share
    is read from it alone."""
    ev = [
        {"ph": "X", "cat": "gpu_memcpy", "name": "h2d", "ts": 100, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 105, "dur": 45},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 170, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "d2h", "ts": 190, "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 500},
    ]
    tr = trace.parse(ev)
    assert tr.window == (pytest.approx(100e-6), pytest.approx(200e-6))
    assert tr.busy_s() == pytest.approx(80e-6)
    idle = spec.load_module("metrics", "idle_pct.infer")
    assert idle.read({"device_trace": tr}) == pytest.approx(20.0)
    assert idle.read({"device_trace": None}) is None


def test_tail_and_rates_over_every_batch():
    # 95th percentile by nearest rank over every value, not a chunk's median
    lat = [10.0] * 90 + [50.0] * 9 + [400.0]
    assert stats.percentile(lat, 95) == 50.0
    assert stats.percentile(lat, 100) == 400.0
    assert stats.percentile([3.0, 1.0, 2.0], 50) == 2.0


def test_rates_are_all_the_work_over_all_the_window(small_bench):
    """The driver's rate is every sample over the window's seconds and its
    tail the percentile of every batch's latency."""
    import run
    from drivers import infer_closed_loop as drv

    cell = spec.load_cell(small_bench, "tiny2d.infer",
                          small_bench.parent / "benchmark")
    family = spec.load_module("families", "boxer2d")
    out = drv.run(cell, family, 3, 0.3, False, "cpu", 0.0,
              run.CACHE / "scratch")
    ctx = out["ctx"]
    assert out["metrics"]["infer_samples_s"] == pytest.approx(
        ctx["samples"] / ctx["window_s"])
    assert ctx["samples"] == len(ctx["latencies"]) * cell.traffic["batch"]
    assert out["metrics"]["infer_ms_p95"] == pytest.approx(
        1e3 * stats.percentile(ctx["latencies"], 95))
    assert ctx["window_s"] >= sum(ctx["latencies"]) * 0.99


def test_no_jax_in_a_run_and_no_port_in_the_reference(small_bench):
    code = textwrap.dedent(f'''
        import json, sys
        sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]
        from pathlib import Path
        import run
        rc = run.main(["--workload", "tiny2d.infer", "--seed", "4",
                       "--seconds", "0.2", "--trace", "0"], device="cpu",
                      bench_json=Path({str(small_bench)!r}),
                      folder=Path({str(small_bench.parent / "benchmark")!r}))
        import calibrate, counts, reference.boxer2d
        import reference.control
        from harness import data, hooks, spec, stats, trace, weights
        top = sorted({{m.split(".")[0] for m in sys.modules}})
        print(json.dumps({{"rc": rc, "top": top}}))
    ''')
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["rc"] == 0
    assert "boxer_tpu_torch" in got["top"]
    for bad in ("jax", "jaxlib", "flax", "boxer_tpu"):
        assert bad not in got["top"]

    code = textwrap.dedent(f'''
        import json, sys
        sys.path[:0] = [{str(BENCH)!r}]
        import reference.boxer2d, reference.control
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
    ''')
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    top = json.loads(out.stdout.strip().splitlines()[-1])
    for bad in ("jax", "jaxlib", "flax", "boxer_tpu", "boxer_tpu_torch"):
        assert bad not in top


def test_a_checkout_without_the_port_gives_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run fails and prints no result line."""
    import shutil

    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns(
        ".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    cell = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell["name"],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
