#!/usr/bin/env python3
"""Drive the PyTorch port (boxer_tpu_torch) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

1. device: requires a CUDA card and prints `nvidia-smi`'s name, power.limit;
2. build: compiles the CUDA kernels from boxer_tpu_torch/csrc with nvcc;
3. each kernel against its plain PyTorch version at the inference slice's
   shapes, with its error and its time beside the plain version's (CUDA
   events);
4. the full-width slice: BoxeR-2D R50 (hidden 256, 8 heads, 6+6 layers, 300
   queries, 91 classes) in bf16 at batch 1 on an 800x1216 canvas with
   seeded random weights, segm with the deferred top-100 mask decode, then
   detection only; img/s, and the kernels' launch counts over the timed
   forwards, which must match every call site;
5. the same weights and image on a 256x384 canvas in f32 (no TF32), card
   (kernels) against CPU (plain versions): identical top-k labels, scores
   and boxes within atol 1e-3, fewer than 1e-3 of mask pixels different;
6. one more segm forward under torch.profiler: the device's busy time
   against the forward's time, and the kernels that take the most of it.

Prints the slice's img/s and one JSON line of per-kernel results, then last
{"ok": true, "device": {...}}. Any failed phase raises: the exit code is
not 0 and no ok line is printed.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
BENCH = dict(num_classes=91, hidden_dim=256, nhead=8, num_level=4,
             enc_layers=6, dec_layers=6, dim_feedforward=1024, num_queries=300,
             backbone_arch="resnet50")
CANVAS = (800, 1216)
E2E_CANVAS = (256, 384)
SEGM_ITERS = 10
DET_ITERS = 10


def log(*args):
    print(*args, flush=True)


def rel_err(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-6))


def cuda_ms(fn, iters=20):
    """Mean device time of fn() over `iters` launches after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_kernels(dev):
    """Phase 3: each kernel against its plain version at the slice's shapes.
    Returns {name: result dict}."""
    from boxer_tpu_torch.ops import combine_reduce as cr
    from boxer_tpu_torch.ops import flash_attention as fa

    rs = np.random.RandomState(0)
    # encoder / decoder level 0 at 800x1216: 8 heads x 101 x 153 quad rows
    rows, m_enc, m_dec = 8 * 101 * 153, 8 * 20197, 8 * 300
    table = torch.from_numpy(rs.randn(rows, 128).astype(np.float32)).to(
        dev, torch.bfloat16)

    def taps(p, m):
        idx = torch.from_numpy(rs.randint(0, rows, (p, m)).astype(np.int32))
        return idx.to(dev), *(torch.from_numpy(
            rs.rand(*s).astype(np.float32)).to(dev)
            for s in ((p, m), (p, m), (p, m), (p, 4, m)))

    results = {}
    idx, lx, ly, wt, _ = taps(4, m_enc)
    results["K1"] = dict(
        kernel=lambda: cr.quad_sample_reduce_raw(table, idx, lx, ly, wt),
        plain=lambda: cr.quad_sample_reduce_plain(table, idx, lx=lx, ly=ly,
                                                  wt=wt),
        tol=1e-5, shape=f"P=4 M={m_enc} table {rows}x128 bf16")
    idx2, _, _, _, w4 = taps(196, m_dec)
    results["K2"] = dict(
        kernel=lambda: cr.quad_sample_reduce_w4(table, idx2, w4),
        plain=lambda: cr.quad_sample_reduce_plain(table, idx2, w4=w4),
        tol=1e-5, shape=f"P=196 M={m_dec} table {rows}x128 bf16")
    qkv = [torch.from_numpy(rs.randn(8, 300, 32).astype(np.float32)).to(dev)
           for _ in range(3)]
    results["K3_f32"] = dict(
        kernel=lambda: fa.flash_attention(*qkv),
        plain=lambda: fa.flash_attention_plain(*qkv),
        tol=1e-5, shape="BH=8 L=300 D=32 f32")
    qkv16 = [t.to(torch.bfloat16) for t in qkv]
    results["K3"] = dict(
        kernel=lambda: fa.flash_attention(*qkv16),
        plain=lambda: fa.flash_attention_plain(*qkv16),
        tol=1e-2, shape="BH=8 L=300 D=32 bf16")

    for name, r in results.items():
        got, want = r["kernel"](), r["plain"]()
        torch.cuda.synchronize()
        r["rel_err"] = rel_err(got.float(), want.float())
        r["max_abs_err"] = float((got.float() - want.float()).abs().max())
        r["ms"] = cuda_ms(r["kernel"])
        r["plain_ms"] = cuda_ms(r["plain"])
        log(f"{name} [{r['shape']}]: rel err {r['rel_err']:.3e} "
            f"(tol {r['tol']:g}), max abs err {r['max_abs_err']:.3e}, "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")
        if not r["rel_err"] <= r["tol"]:
            raise AssertionError(f"{name} disagrees with its plain version")
    return results


def build_model(use_mask, seed=0, noise_seed=None):
    """BoxeR2D at the bench width with seeded weights; with noise_seed the
    zero-initialised heads get a little seeded noise so sampling offsets,
    attention weights and logits spread."""
    from boxer_tpu_torch.models.boxer2d import BoxeR2D

    model = BoxeR2D(**BENCH, use_mask=use_mask).init_weights(seed).eval()
    if noise_seed is not None:
        rs = np.random.RandomState(noise_seed)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith(("linear_box_weight", "linear_attn_weight",
                                  "class_embed.bias")):
                    p.add_(torch.from_numpy(
                        rs.randn(*p.shape).astype(np.float32) * 0.05))
    return model


def make_image(hw, seed=0):
    rs = np.random.RandomState(seed)
    image = torch.from_numpy(rs.randn(1, *hw, 3).astype(np.float32))
    return image, torch.zeros((1, *hw), dtype=torch.bool)


def counters():
    from boxer_tpu_torch.ops import combine_reduce as cr
    from boxer_tpu_torch.ops import flash_attention as fa

    return {"K1": cr.quad_sample_reduce_raw, "K2": cr.quad_sample_reduce_w4,
            "K3": fa.flash_attention}


def run_slice(dev, use_mask, iters, label):
    """Phase 4: a warm-up forward, then `iters` forwards each timed on the
    host clock up to a synchronize, with the launch counters zeroed just
    before them. Returns (img/s at the median forward, counts)."""
    model = build_model(use_mask).to(dev, torch.bfloat16)
    image, mask = (t.to(dev) for t in make_image(CANVAS))
    post = {"canvas_hw": CANVAS, "topk": 100}
    times = []
    with torch.no_grad():
        model(image, mask, postprocess=post)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for f in counters().values():
            f.launches = 0
        for _ in range(iters):
            t0 = time.perf_counter()
            out = model(image, mask, postprocess=post)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    counts = {k: f.launches for k, f in counters().items()}
    ms = float(np.median(times))
    fps = 1e3 / ms
    log(f"{label}: {fps:.3f} img/s (median {ms:.2f} ms/img of {iters} "
        f"forwards: {', '.join(f'{t:.2f}' for t in times)}; peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB), "
        f"launches {counts}")

    k = post["topk"]
    want = {"scores": (1, k), "labels": (1, k), "boxes": (1, k, 4)}
    if use_mask:
        want["masks"] = (1, k, *CANVAS)
    for key, shape in want.items():
        if tuple(out[key].shape) != shape:
            raise AssertionError(f"{label}: {key} {tuple(out[key].shape)} "
                                 f"!= {shape}")
        if out[key].is_floating_point() and not torch.isfinite(out[key]).all():
            raise AssertionError(f"{label}: {key} not finite")
    # per forward: K1 in 6 encoder layers x 4 levels (+ 6 decoder layers x 4
    # levels when detection only), K2 in 5 decoder layers x 4 levels, K3 in
    # 6 decoder self-attentions
    per_fwd = ({"K1": 24, "K2": 20, "K3": 6} if use_mask
               else {"K1": 48, "K2": 0, "K3": 6})
    expect = {k: v * iters for k, v in per_fwd.items()}
    if counts != expect:
        raise AssertionError(f"{label}: launches {counts} != {expect}")
    del model
    torch.cuda.empty_cache()
    return fps, counts


def card_vs_cpu(dev):
    """Phase 5: same weights and image, f32, card (kernels) vs CPU (plain)."""
    model = build_model(True, seed=1, noise_seed=2)
    image, mask = make_image(E2E_CANVAS, seed=1)
    post = {"canvas_hw": E2E_CANVAS, "topk": 100}
    with torch.no_grad():
        want = model(image, mask, postprocess=post)
        model.to(dev)
        before = {k: f.launches for k, f in counters().items()}
        got = {k: v.cpu() for k, v in model(image.to(dev), mask.to(dev),
                                            postprocess=post).items()}
    torch.cuda.synchronize()
    after = {k: f.launches for k, f in counters().items()}
    if any(after[k] == before[k] for k in after):
        raise AssertionError("card run did not go through every kernel")
    label_eq = bool((got["labels"] == want["labels"]).all())
    score_err = float((got["scores"] - want["scores"]).abs().max())
    box_err = float((got["boxes"] - want["boxes"]).abs().max())
    mask_diff = float((got["masks"] != want["masks"]).float().mean())
    log(f"card vs CPU at {E2E_CANVAS} f32: labels equal {label_eq}, "
        f"score max abs err {score_err:.3e}, box max abs err {box_err:.3e} px,"
        f" mask pixels differing {mask_diff:.3e}")
    if not (label_eq and score_err <= 1e-3 and box_err <= 1e-3
            and mask_diff < 1e-3):
        raise AssertionError("card and CPU disagree")
    return dict(score_err=score_err, box_err=box_err, mask_diff=mask_diff)


def profile(dev, forward_ms):
    """Phase 6: one segm forward under torch.profiler. Prints the device's
    summed kernel time against the unprofiled forward time (the busy share;
    the rest the device idles while the host dispatches) and the top
    kernels by device time."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    model = build_model(True).to(dev, torch.bfloat16)
    image, mask = (t.to(dev) for t in make_image(CANVAS))
    post = {"canvas_hw": CANVAS, "topk": 100}
    with torch.no_grad():
        model(image, mask, postprocess=post)
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            model(image, mask, postprocess=post)
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"profile: device busy {busy_ms:.2f} ms of a {forward_ms:.2f} ms "
        f"segm forward ({100 * busy_ms / forward_ms:.1f}%); top kernels:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms  {e.count:4d}x  "
            f"{e.key[:90]}")
    del model
    torch.cuda.empty_cache()


def main():
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card (torch.cuda.is_available()"
                         " is false); the port has no CPU path here")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build (the package comes from this checkout)
    sys.path.insert(0, str(ROOT))
    from boxer_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"build: {lib_path.relative_to(ROOT)} in {time.perf_counter() - t0:.1f}"
        f" s (torch {torch.__version__}, CUDA {torch.version.cuda})")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  ptxas:", line.strip())

    # 3. kernels against their plain versions
    kern = check_kernels(dev)

    # 4. the slice at full width
    segm_fps, segm_counts = run_slice(dev, True, SEGM_ITERS,
                                      f"segm R50 {CANVAS} bf16 [{smi}]")
    det_fps, _ = run_slice(dev, False, DET_ITERS,
                           f"detection R50 {CANVAS} bf16 [{smi}]")

    # 5. card against CPU
    card_vs_cpu(dev)

    # 6. where the device time goes
    profile(dev, 1e3 / segm_fps)

    sources = {"K1": ("quad_sample_reduce_raw", "quad_sample_reduce.cu",
                      "boxer_tpu/ops/pallas/combine_reduce.py:123"),
               "K2": ("quad_sample_reduce_w4", "quad_sample_reduce.cu",
                      "boxer_tpu/ops/pallas/combine_reduce.py:264"),
               "K3": ("flash_attention", "flash_attention.cu",
                      "boxer_tpu/ops/pallas/flash_attention.py:69")}
    kernels = []
    for key, (name, src, replaces) in sources.items():
        r = kern[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"boxer_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": segm_counts[key], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"]})
    log(f"slice [{smi}]: segm {segm_fps:.3f} img/s, detection "
        f"{det_fps:.3f} img/s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
