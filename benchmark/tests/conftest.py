"""A small copy of the benchmark for the CPU tests: the benchmark's folder
copied into a temporary directory beside a `BENCHMARK.json` of one cell,
the shipped configuration cut to a size the CPU runs in seconds."""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# the real configuration's numbers, with limits set between the readings
# this small cell gave on the CPU over 8 seeds (program in bf16 against
# the f32 reference: its largest; the fp8 control: its smallest):
# proposal_gap 0.0123 / 0.107, topk_gap 0.0162 / 0.0682, box_err 0.581 /
# 3.07 pixels, mask_logit_rms 0.0258 / 0.123, score_mae 0.0044 / 0.0023
SMALL_LIMITS = {
    "tiny2d": {"proposal_gap": 0.06, "topk_gap": 0.065, "box_err": 2.5,
               "mask_logit_rms": 0.045, "score_mae": 0.01,
               "mask_paste_err": 0},
}


def small_configs():
    c2 = json.loads((BENCH / "configs/boxer2d_r50_segm.json").read_text())
    c2["model"].update(hidden_dim=64, nhead=2, enc_layers=1, dec_layers=2,
                       dim_feedforward=128, num_queries=30,
                       backbone_arch="resnet10")
    c2["shapes"]["resnet_blocks"] = [1, 1, 1, 1]
    c2["limits"] = SMALL_LIMITS["tiny2d"]
    t2 = json.loads((BENCH / "traffic/closed_b16_800x1216.json").read_text())
    t2.update(batch=2, canvas=[64, 96], topk=10, pool=2, warmup=1,
              trace_batches=1, check={"batches": 1, "samples": 2, "within": 1})

    return {"tiny2d": (c2, t2)}


def write_bench(tmp: Path) -> Path:
    """The copy; returns its BENCHMARK.json."""
    folder = tmp / "benchmark"
    shutil.copytree(BENCH, folder, ignore=shutil.ignore_patterns(
        ".cache", "tests", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"], spec["workloads"] = [], []
    for name, (cfg, traffic) in small_configs().items():
        (folder / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        (folder / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
        spec["configs"].append({"name": name, "source": "test",
                                "file": f"benchmark/configs/{name}.json",
                                "reduced": [], "why": "test"})
        spec["workloads"].append({"name": f"{name}.infer", "config": name,
                                  "traffic": name, "chips": 1, "why": "test"})
    path = tmp / "BENCHMARK.json"
    path.write_text(json.dumps(spec))
    return path


@pytest.fixture
def small_bench(tmp_path):
    return write_bench(tmp_path)


def run_cell(bench_json: Path, cell: str, trace: int = 0, seed: int = 2 ** 31 + 5,
             capsys=None):
    """run.main on the CPU; returns (exit code, result dict or None)."""
    import run

    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.5", "--trace", str(trace)], device="cpu",
                  bench_json=bench_json, folder=bench_json.parent / "benchmark")
    if capsys is None:
        return rc, None
    lines = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else None
