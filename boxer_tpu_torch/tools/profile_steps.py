"""Device time of one full-width BoxeR-2D R50 segm inference forward (under
the p-major and the m-major combine), one segm val forward and one train
step, segm, detection (per tap) and detection folded, and of one
full-width BoxeR-3D forward and train step, under torch.profiler, for the
tree on PYTHONPATH.

    PYTHONPATH=TREE python boxer_tpu_torch/tools/profile_steps.py [RUN ...]

TREE is the root of a checkout (this one, or a `git archive` of another
commit): its `boxer_tpu_torch` package and its `chip_smoke.py` (whose
`build_model`, `make_image`, `train_setup` and `train_batch` this script
uses, and its `sampling` to set `COMBINE_IMPL` and `FOLD_TAP_THRESHOLD`, so
a tree that has them and not this file can be profiled too) are imported
from there. The forward runs at `chip_smoke`'s phase 6 (bf16 weights, batch
1, 800x1216, top-100 postprocess with masks), each train step at its recipe
(batch 1, 800x1216, 20 targets, f32 parameters, bf16 autocast, AdamW); the
m-major forward runs K8 at every level; the val forward runs as the
trainer's val step runs it (`parallel/steps.py:make_eval_step`: f32
parameters, bf16 autocast, under no_grad, train=False, inference=False:
every decoder layer's instance attention with its RoI, 300 queries), on
the forward's image; the folded step K7b in the backward
of every box-attention level. BoxeR-3D runs at `chip_smoke`'s phases 9 and
9c (468x468, bf16 forward of 32,000 voxels of f32 points; a train step of
2 frames, f32 parameters, bf16 autocast), where the tree's `chip_smoke` has
them. Each
runs twice to warm up, WALL_RUNS times each on the host clock up to a
synchronize, once profiled. Prints, for each, the device's summed kernel
time against the median wall time and the wall times' spread, the device
time and calls of each of the port's kernels (by name:
`quad_sample_reduce`, `flash_fwd`, `instance_sample` (K4, in a tree that
has it), `box_sample` (K9), `pillar_net` (K10), `scatter_weighted`,
`scatter_rows` and `rows_` (the row scatter's kernels, before and after it
was split in four), `hungarian`, `Memset`), and the device time of the
kernels that the matcher's `nn/matcher.py:hungarian` launches (its
`boxer.train.matcher`
span; 0 in a tree without the port's spans), of which its sorts
(`aten::sort`: the valid rows' order and the pruning top-k); the spans'
own device-side ranges (`boxer.*`) are left out of the busy time. Then
one JSON line {"tree": ...,
"busy_ms": {run: ms}, "wall_ms": {run: [ms, ...]}, "kernels": {run:
{kernel: ms}}, "matcher_ms": {run: ms}, "matcher_sort_ms": {run: ms}}.
RUNs (segm_forward, segm_forward_mmajor, segm_val, segm, det, det_folded,
boxer3d: its forward and its step) pick runs; all by default.
"""

import json
import statistics
import subprocess
import sys
import time

import torch

PORT_KERNELS = ("quad_sample_reduce", "flash_fwd", "instance_sample",
                "box_sample", "pillar_net", "scatter_weighted",
                "scatter_rows", "rows_", "hungarian", "Memset")
WALL_RUNS = 5
MATCHER_SPAN = "boxer.train.matcher"
# `utils/timer.py:SPAN_PREFIX`, spelt out: the trees this profiles may
# predate it
SPAN_PREFIX = "boxer."


def matcher_ms(prof):
    """Device ms of the kernels launched inside the matcher's span, and of
    those its `aten::sort` calls launched."""
    def sorts(e):
        if e.name == "aten::sort":
            return e.device_time_total
        return sum(sorts(c) for c in e.cpu_children)

    ranges = [e for e in prof.events() if e.name == MATCHER_SPAN
              and e.device_type == torch.autograd.DeviceType.CPU]
    return (sum(e.device_time_total for e in ranges) / 1e3,
            sum(sorts(e) for e in ranges) / 1e3)


def profile(fn):
    """fn() twice to warm up, WALL_RUNS times on the host clock, once under
    the profiler: ([wall ms], device busy ms, {port kernel: (ms, calls)},
    (matcher device ms, of which its sorts))."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    wall = []
    for _ in range(WALL_RUNS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.key.startswith(SPAN_PREFIX)]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    ours = {e.key: (e.self_device_time_total / 1e3, e.count) for e in events
            if any(k in e.key for k in PORT_KERNELS)}
    return wall, busy, ours, matcher_ms(prof)


def main(runs=()):
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
    busy, walls, kernels, match, match_sort = {}, {}, {}, {}, {}
    runs = set(runs) or None

    def report(key, wall, ms, ours, matcher):
        busy[key], walls[key] = ms, wall
        kernels[key] = {k: v[0] for k, v in ours.items()}
        match[key], match_sort[key] = matcher
        med = statistics.median(wall)
        print(f"{key}, {tree}: device busy {ms:.2f} ms of a {med:.2f} ms "
              f"run ({100 * ms / med:.1f}%; median of {len(wall)}, "
              f"{min(wall):.2f}-{max(wall):.2f}); the matcher's kernels "
              f"{matcher[0]:.3f} ms, of which its sorts {matcher[1]:.3f} "
              "ms; the port's kernels:", flush=True)
        for name, (k_ms, calls) in sorted(ours.items(),
                                          key=lambda x: -x[1][0]):
            print(f"  {k_ms:8.3f} ms  {calls:4d}x  {name[:100]}", flush=True)

    def chosen(*keys):
        return runs is None or bool(runs & set(keys))

    if chosen("segm_forward", "segm_forward_mmajor"):
        model = cs.build_model(True).to(dev, torch.bfloat16)
        image, mask = (t.to(dev) for t in cs.make_image(cs.CANVAS))
        post = {"canvas_hw": cs.CANVAS, "topk": 100}
        for combine, key in (("pmajor", "segm_forward"),
                             ("mmajor", "segm_forward_mmajor")):
            if chosen(key):
                with torch.no_grad(), cs.sampling(COMBINE_IMPL=combine):
                    report(key, *profile(
                        lambda: model(image, mask, postprocess=post)))
        del model
        torch.cuda.empty_cache()
    if chosen("segm_val"):
        model = cs.build_model(True).to(dev)
        image, mask = (t.to(dev) for t in cs.make_image(cs.CANVAS))

        def val():
            with torch.no_grad(), torch.autocast("cuda", torch.bfloat16):
                return model(image, mask, train=False, inference=False)

        report("segm_val", *profile(val))
        del model
        torch.cuda.empty_cache()
    for use_mask, key, fold in ((True, "segm", 8), (False, "det", 8),
                                (False, "det_folded", 0)):
        if not chosen(key):
            continue
        model = cs.build_model(use_mask).to(dev).train()
        _, state, step = cs.train_setup(model, use_mask, torch.bfloat16)
        batch = cs.train_batch(cs.CANVAS, use_mask, dev)
        with cs.sampling(FOLD_TAP_THRESHOLD=fold):
            report(key, *profile(lambda: step(state, batch)))
        del model, state, step
        torch.cuda.empty_cache()
    if hasattr(cs, "build_model_3d") and chosen("boxer3d"):
        grid = cs.grid_3d(cs.PC_RANGE_3D)
        model = cs.build_model_3d(cs.PC_RANGE_3D).to(dev, torch.bfloat16)
        vox, coords, npts = cs.random_voxels_3d(grid, cs.VOXELS_3D, 1, 0)
        args = (torch.from_numpy(vox).to(dev),
                torch.from_numpy(coords).to(dev),
                torch.from_numpy(npts).to(dev), grid, 1)
        with torch.no_grad():
            report("boxer3d_forward", *profile(lambda: model(*args)))
        model = model.float().train()
        _, state, step = cs.train_setup_3d(model, torch.bfloat16)
        batch = cs.train_batch_3d(dev)
        report("boxer3d_train", *profile(lambda: step(state, batch)))
        del model, state, step
        torch.cuda.empty_cache()
    print(json.dumps({"tree": tree, "busy_ms": busy, "wall_ms": walls,
                      "kernels": kernels, "matcher_ms": match,
                      "matcher_sort_ms": match_sort}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
