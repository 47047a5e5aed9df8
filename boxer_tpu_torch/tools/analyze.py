"""Model analysis: parameters, FLOPs, inference speed and structure; port of
`tools/analyze.py` (the reference's `tools/analyze.py`).

  python -m boxer_tpu_torch.tools.analyze --tasks parameter flop speed \
      structure --config <yaml> --model boxer2d [--height 800 --width 1216] \
      [--device cuda|cpu] [--no-bf16] [key.path=value ...]

Runs on the first CUDA card unless `--device cpu` is given; without a card
`--device cuda` (the default) raises. The model has seeded random weights
(`init_weights(0)`), in bf16 unless `--no-bf16`, on a zero image of the
given size with no padding.

- parameter: the trainable parameters (every `parameters()` entry, as the
  JAX package counts its `params`) and the frozen statistics (the
  FrozenBN buffers, its `constants`);
- flop: `torch.utils.flop_counter.FlopCounterMode` over one inference
  forward. It counts the aten ops the dispatcher sees; on the card it does
  not see the CUDA kernels called through ctypes (K1, K2, K3, K8), as XLA's
  cost analysis does not see inside a custom call, and on the CPU it counts
  their plain versions. So the count is not comparable one to one with the
  JAX package's;
- speed: one warm-up forward, then `iters` forwards with one synchronize at
  the end: img/s at batch 1, beside the card's name and power limit;
- structure: one line a parameter (name, shape, size).
"""

import argparse
import subprocess
import time

import torch


def build(args):
    """The model (seeded weights, eval, on the device in its dtype), a zero
    image and an all-False padding mask."""
    from boxer_tpu_torch.models import build_model
    from boxer_tpu_torch.trainer.base_trainer import resolve_device
    from boxer_tpu_torch.utils.config import Configuration

    device = resolve_device(args.device)
    config = Configuration(config_path=args.config, opts=args.opts,
                           extra={"task": args.task, "model": args.model},
                           device=args.device).get_config()
    try:
        model_cfg = config.model_config[args.model]
    except KeyError:
        raise SystemExit(
            f"model_config.{args.model} not found: pass --config <experiment "
            "yaml> (e.g. boxer_tpu_torch/config/COCO-Detection/"
            "boxer2d_r50_3x.yaml)")
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = build_model(model_cfg, args.num_classes).init_weights(0).eval()
    model = model.to(device, dtype)
    image = torch.zeros((1, args.height, args.width, 3), device=device)
    mask = torch.zeros((1, args.height, args.width), dtype=torch.bool,
                       device=device)
    return model, image, mask


def _forward(model, image, mask):
    with torch.no_grad():
        return model(image, mask, train=False, inference=True)["pred_boxes"]


def task_parameter(model, *_):
    """Returns (trainable, frozen) counts."""
    from boxer_tpu_torch.nn.resnet import FrozenBatchNorm

    total = sum(p.numel() for p in model.parameters())
    frozen = sum(b.numel() for m in model.modules()
                 if isinstance(m, FrozenBatchNorm) for b in m.buffers())
    print(f"parameters: {total / 1e6:.2f}M trainable "
          f"(+{frozen / 1e6:.2f}M frozen stats): {total} and {frozen}")
    return total, frozen


def task_flop(model, image, mask, *_):
    """Returns the FLOPs of one inference forward that the counter sees."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        _forward(model, image, mask)
    flops = counter.get_total_flops()
    unseen = ("it does not see the ctypes kernels K1/K2/K3/K8"
              if image.is_cuda else "on the CPU it counts the kernels' plain "
              "versions")
    print(f"flops: {flops / 1e9:.2f} GFLOPs / image (FlopCounterMode over "
          f"one inference forward; {unseen}, as XLA's cost analysis does not "
          "see inside a custom call: not comparable one to one with the JAX "
          "package's count)")
    return flops


def device_label(device: torch.device) -> str:
    """`nvidia-smi`'s name and power limit of the card, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", f"--id={device.index or 0}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def task_speed(model, image, mask, iters: int = 50):
    """Returns img/s at batch 1, warm."""
    def sync():
        if image.is_cuda:
            torch.cuda.synchronize(image.device)

    _forward(model, image, mask)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        _forward(model, image, mask)
    sync()
    dt = time.perf_counter() - t0
    print(f"speed: {iters / dt:.2f} img/s ({dt / iters * 1e3:.1f} ms/img, "
          f"bs=1 warm, {iters} forwards) on {device_label(image.device)}")
    return iters / dt


def task_structure(model, *_):
    """Returns the number of lines printed, one a parameter."""
    n = 0
    for name, p in model.named_parameters():
        print(f"{name:80s} {str(tuple(p.shape)):20s} {p.numel():>12,}")
        n += 1
    return n


TASKS = {"speed": task_speed, "flop": task_flop, "parameter": task_parameter,
         "structure": task_structure}


def get_parser():
    parser = argparse.ArgumentParser(description="boxer_tpu_torch analysis")
    parser.add_argument("--tasks", nargs="+", default=["parameter"],
                        choices=sorted(TASKS))
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--task", type=str, default="detection")
    parser.add_argument("--model", type=str, default="boxer2d")
    parser.add_argument("--num-classes", type=int, default=91)
    parser.add_argument("--height", type=int, default=800)
    parser.add_argument("--width", type=int, default=1216)
    parser.add_argument("--bf16", action=argparse.BooleanOptionalAction,
                        default=True)
    parser.add_argument("--iters", type=int, default=50,
                        help="timed forwards of the speed task")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda (the default) or cpu; never a fallback")
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    return parser


def main(argv=None):
    """Runs the tasks in order; returns {task: its result}."""
    args = get_parser().parse_args(argv)
    model, image, mask = build(args)
    results = {}
    for t in args.tasks:
        extra = (args.iters,) if t == "speed" else ()
        results[t] = TASKS[t](model, image, mask, *extra)
    return results


if __name__ == "__main__":
    main()
