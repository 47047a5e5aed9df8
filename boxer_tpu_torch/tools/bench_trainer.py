"""Wall time per update of the port's trainer on the shipped segm config,
for the tree on PYTHONPATH; or that tree's `chip_smoke.py` phases 10 and 11.

    PYTHONPATH=TREE python boxer_tpu_torch/tools/bench_trainer.py [UPDATES]
    PYTHONPATH=TREE python boxer_tpu_torch/tools/bench_trainer.py phases

TREE is the root of a checkout (this one, or a `git archive` of another
commit): its `boxer_tpu_torch` package, and its `chip_smoke.py`, whose
`write_coco` and `trainer_on_card` (phase 10) this script uses, are
imported from there. It writes a synthetic COCO directory of UPDATES x 2
train JPEGs (480x640, COCO's 80 category ids), so that the UPDATES updates
(default 12) are one epoch, and trains `chip_smoke.TRAINER_CONFIG` (the
shipped BoxeR-2D R50 segm config at full width, bf16 autocast, its 1344x1344
canvas and processors) on the first CUDA card, cut only in the schedule:
two microbatches of one image an update, `run_type=train`, no checkpoint
before the last update, a log line every update.

An update's wall time runs from the return of the previous update's train
step to the return of its own: the loader's hand-out (with the batch's copy
to the card), the step and the engine's logging, as a user's run pays them
(no synchronize is added). The first update (the warm-up) has none. Prints
one JSON line {"tree": ..., "wall_ms": [...], "median_wall_ms": ...,
"step_ms": [...], "peak_gib": ...}, where a step's ms is the train step's
own call.

`phases` runs the tree's phase 10 (`chip_smoke.run_trainer`, the shipped
segm config) and phase 11 (`run_trainer_3d`, the shipped Waymo config), as
its `chip_smoke.py` runs them (TF32 off), each inside its
`matcher_syncs()` tally, and prints one JSON line {"tree": ..., "device":
nvidia-smi's name and power limit, "phase10": {...}, "phase11": {...}},
each with the phase's "ms" per update (the median of updates 2-6) and
"times", the profiled update's "busy_ms" and "busy_share", and the
matcher's host "syncs" and hungarian "calls" over the phase.
"""

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch


def main(updates=12):
    import chip_smoke

    tree = Path(chip_smoke.__file__).resolve().parent
    # the tree's write_coco takes its image count from its module
    chip_smoke.COCO_IMAGES = 2 * updates
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        chip_smoke.write_coco(root)
        trainer = chip_smoke.trainer_on_card(root, [
            "training.seed=3", "training.batch_size=2",
            "training.iter_per_update=2", f"training.max_update={updates}",
            f"training.checkpoint_interval={updates}",
            "training.log_interval=1", "training.run_type=train"])
        ends, step_ms = [], []
        train_step = trainer._train_step

        def step(state, batch, **kw):
            t0 = time.perf_counter()
            out = train_step(state, batch, **kw)
            ends.append(time.perf_counter())
            step_ms.append((ends[-1] - t0) * 1e3)
            return out

        trainer._train_step = step
        torch.cuda.reset_peak_memory_stats()
        trainer.train()
        torch.cuda.synchronize()
        if trainer.state.step != updates:
            raise AssertionError(f"{trainer.state.step} of {updates} "
                                 "updates taken")
        wall = [(b - a) * 1e3 for a, b in zip(ends, ends[1:])]
        print(json.dumps({
            "tree": str(tree), "wall_ms": wall,
            "median_wall_ms": statistics.median(wall), "step_ms": step_ms,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}))


def phases():
    import chip_smoke

    tree = Path(chip_smoke.__file__).resolve().parent
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    out = {"tree": str(tree), "device": smi}
    for name, run in (("phase10", chip_smoke.run_trainer),
                      ("phase11", chip_smoke.run_trainer_3d)):
        with chip_smoke.matcher_syncs() as tally:
            _, res = run(dev, smi)
        out[name] = {"ms": res["ms"], "times": res["times"],
                     "busy_ms": res["busy"][0], "busy_share": res["busy"][1],
                     "syncs": tally["syncs"], "calls": tally["calls"]}
    print(json.dumps(out))


if __name__ == "__main__":
    if sys.argv[1:] == ["phases"]:
        phases()
    else:
        main(*map(int, sys.argv[1:]))
