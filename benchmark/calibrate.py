"""Read the numbers that decide `correct`, for setting their limits.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 3

For each seed of `--seeds`, in one process: the cell's set-up and a short
window at the cell's own load, then the check's numbers of the program
against the reference. For each seed of `--control-seeds`: the same
window, then the control (the reference in fp8, `reference/control.py`)
put in the program's place on the same judged samples, and its numbers.
One JSON line a reading; the limits are set between the program's largest
and the control's smallest (`PERF.md`). The benchmark's own runs do not
run this.
"""

import argparse
import json
import sys
import time

import run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from harness import spec

    import torch

    cell = spec.load_cell(run.HERE.parent / "BENCHMARK.json", args.workload)
    device = "cuda:0" if torch.cuda.is_available() else "cpu"
    family = spec.load_module("families", cell.config["family"])
    driver = spec.load_module("drivers", cell.traffic["driver"])
    out = open(args.out, "a") if args.out else None
    seeds = [("program", int(s)) for s in args.seeds.split(",") if s]
    seeds += [("control", int(s)) for s in args.control_seeds.split(",") if s]
    for side, seed in seeds:
        t = time.perf_counter()
        res = driver.run(cell, family, seed, args.seconds, False, device, t,
                         run.CACHE / "scratch")
        records = res["records"]
        if side == "control":
            records = family.control_records(cell.config, cell.traffic,
                                             device, seed, records)
        numbers = family.judge(cell.config, cell.traffic, device, seed,
                               records)
        line = json.dumps({"workload": cell.name, "side": side, "seed": seed,
                           "numbers": numbers,
                           "metrics": res["metrics"],
                           "seconds": time.perf_counter() - t})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
