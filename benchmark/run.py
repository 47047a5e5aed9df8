"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell (`BENCHMARK.json`) names its
configuration and traffic mix; the mix names its driver. With `--trace 0`
the result's metrics are the cell's end-to-end metrics, with `--trace 1`
its per-layer metrics, read by each metric's reader from the window and
from two profiled stretches after it. Every run ends with the check that
decides `correct`: the reference judges what the window produced, and each
number compared is printed beside its limit, last on standard error and
last in the result line.

The run needs as many CUDA cards as the cell asks for, and fails, with no
result, without them, or if JAX, jaxlib, flax or the JAX package
(`boxer_tpu`) is loaded in this process once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CACHE = HERE / ".cache"
# the benchmark's modules, and the checkout's root for the port
for _p in (str(HERE.parent), str(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

FORBIDDEN = ("jax", "jaxlib", "flax", "boxer_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's,
    jaxlib's, flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(device, count: int) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,"
             "nounits", f"--id={torch.device(device).index or 0}"],
            capture_output=True, text=True, timeout=30)
        info["power_limit_w"] = float(smi.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return info


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device=None, bench_json=None, folder=HERE,
         t_start=T_START) -> int:
    """Run the cell; returns the exit code. `device` None asks for CUDA
    cards; the tests pass "cpu" to drive the rest of a run without one."""
    args = parse(argv)
    # build caches at fixed paths inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    from harness import spec

    cell = spec.load_cell(bench_json or HERE.parent / "BENCHMARK.json",
                          args.workload, folder)
    chips = cell.workload["chips"]
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"{cell.name} needs {chips} CUDA card(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda:0"
    dev_info = device_info(device, chips)
    print(f"{cell.name}: {dev_info}", file=sys.stderr, flush=True)

    family = spec.load_module("families", cell.config["family"], folder)
    driver = spec.load_module("drivers", cell.traffic["driver"], folder)
    out = driver.run(cell, family, args.seed, args.seconds, bool(args.trace),
                     device, t_start, CACHE / "scratch")

    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process after the window: {bad}",
              file=sys.stderr)
        return 3

    dev_info["memory_peak_bytes"] = out["peak_bytes"]
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.load_module("metrics", m["name"], folder).read(
                out["ctx"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        tr = out["ctx"]["device_trace"]
        dev_info["busy_s"] = tr.busy_s()
        dev_info["window_s"] = tr.window_s
    else:
        metrics = {m["name"]: {"value": out["metrics"][m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}

    numbers = family.judge(cell.config, cell.traffic, device, args.seed,
                           out["records"])
    limits = cell.config["limits"]
    check = {k: {"value": numbers.get(k, float("inf")), "limit": lim}
             for k, lim in limits.items()}
    correct = (not out["missing"] and bool(numbers)
               and all(c["value"] <= c["limit"] for c in check.values()))
    if out["missing"]:
        print(f"batches to check that the window never reached: "
              f"{out['missing']}", file=sys.stderr)
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": 0 if correct else out["attempted"],
              "metrics": metrics, "device": dev_info}
    if args.trace:
        result["breakdown"] = out["ctx"]["trace"].breakdown()
    result["check"] = check
    for k, c in check.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct: {correct}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
