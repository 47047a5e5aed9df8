"""Device time of one full-width BoxeR-2D R50 train step, segm and detection
(per tap), under torch.profiler, for the tree on PYTHONPATH.

    PYTHONPATH=TREE python boxer_tpu_torch/tools/profile_steps.py

TREE is the root of a checkout (this one, or a `git archive` of another
commit): its `boxer_tpu_torch` package and its `chip_smoke.py` (whose
`build_model`, `train_setup`, `train_batch` and `profile` this script
uses, so a tree that has them and not this file can be profiled too) are
imported from there. Each step runs at `chip_smoke`'s recipe (batch 1,
800x1216, 20 targets, f32 parameters, bf16 autocast, AdamW): two steps to
warm up, one timed on the host clock up to a synchronize, one profiled.
Prints, for each, the device's summed kernel time against the step's wall
time and the kernels that take the most of it, then one JSON line
{"tree": ..., "segm_busy_ms": ..., "det_busy_ms": ...}.
"""

import json
import subprocess
import sys
import time

import torch


def main():
    if not torch.cuda.is_available():
        sys.exit("profile_steps: no CUDA card; this script profiles the card")
    import boxer_tpu_torch
    import chip_smoke as cs

    tree = str(boxer_tpu_torch.__file__).rsplit("/boxer_tpu_torch/", 1)[0]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{smi}; tree {tree}", flush=True)
    dev = torch.device("cuda", 0)
    busy = {}
    for use_mask, key in ((True, "segm"), (False, "det")):
        model = cs.build_model(use_mask).to(dev).train()
        _, state, step = cs.train_setup(model, use_mask, torch.bfloat16)
        batch = cs.train_batch(cs.CANVAS, use_mask, dev)
        for _ in range(2):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        busy[key] = cs.profile(lambda: step(state, batch), wall,
                               f"{key} train step, {tree}")[0]
        del model, state, step
        torch.cuda.empty_cache()
    print(json.dumps({"tree": tree, "segm_busy_ms": busy["segm"],
                      "det_busy_ms": busy["det"]}), flush=True)


if __name__ == "__main__":
    main()
