"""CLI entry point of the port; counterpart of the JAX package's
`tools/run.py`:

  python -m boxer_tpu_torch.tools.run --config <yaml> --task detection \
      --model boxer2d [--device cuda|cpu] [key.path=value ...]
  python -m boxer_tpu_torch.tools.run \
      --config boxer_tpu_torch/config/Waymo-Detection/boxer3d_pointpillar.yaml \
      --task detection3d --model boxer3d [--device cuda|cpu] [...]

`--task detection` trains BoxeR-2D from a COCO directory, `--task
detection3d` BoxeR-3D from a Waymo frame directory (infos pkl, per-frame
lidar pkl, the GT database of `tools/preprocess/create_gt_database.py`).
`training.run_type` picks the run: train (then val and test, as the split
files exist), val, or test. Without a card `--device cuda` (the default)
raises before it builds anything; `--device cpu` runs on the CPU.

Parallel, one process a card, on the layout of `distributed.{dp,sp,mp}`
(`parallel/mesh.py`): the config's global `batch_size` split over dp,
BoxeR-2D's encoder tokens over sp, attention heads and FFN features over
mp:
- the processes are dp * sp * mp, or `distributed.world_size` when dp is
  null (the shipped default: `${device_count:}`, every visible card on
  cuda, 1 on cpu), dp then the world over sp * mp;
- at one process it trains in this process, with no process group;
- at more, it spawns one process a card (NCCL on cuda; a number above the
  visible cards raises) or, with `--device cpu`, one process a rank over
  gloo (`--device cpu distributed.dp=2`, `--device cpu distributed.dp=1
  distributed.sp=2 distributed.mp=2`);
- under torchrun (its environment set: `torchrun --nproc-per-node 8 -m
  boxer_tpu_torch.tools.run ...`, across nodes with `--nnodes` and a
  rendezvous) each process joins torchrun's group and trains as its rank.
`--model detr` trains DETR from `config/COCO-Detection/detr_r50.yaml`.
BoxeR-3D and DETR take mp but not sp (ValueError, as the JAX package
rejects `seq_shard` for them).
"""

import argparse

import torch


def get_parser():
    parser = argparse.ArgumentParser(description="boxer_tpu_torch runner")
    parser.add_argument("--config", type=str, default=None,
                        help="experiment yaml")
    parser.add_argument("--task", type=str, default="detection",
                        help="detection (COCO) or detection3d (Waymo)")
    parser.add_argument("--model", type=str, default="boxer2d",
                        help="boxer2d or detr (with detection), boxer3d "
                        "(with detection3d)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda (the default) or cpu; never a fallback")
    parser.add_argument("opts", nargs=argparse.REMAINDER,
                        help="dotlist overrides: key.path=value")
    return parser


def configuration(args):
    from boxer_tpu_torch.utils.config import Configuration

    return Configuration(config_path=args.config, opts=args.opts,
                         extra={"task": args.task, "model": args.model},
                         device=args.device)


def train(args):
    """Build the trainer in this process (a rank, in a process group) and
    run `training.run_type`."""
    from boxer_tpu_torch.trainer import build_trainer

    trainer = build_trainer(configuration(args), device=args.device)
    trainer.load()
    run_type = trainer.running_config.get("run_type", "train_val_test")
    if "train" in run_type:
        trainer.train()
    elif "val" in run_type:
        trainer.evaluate("val")
    else:
        trainer.inference()
    return trainer


def run(argv=None):
    """Returns the trainer when it ran in this process, None when the run
    was spawned over several processes."""
    args = get_parser().parse_args(argv)

    from boxer_tpu_torch.parallel import distributed
    from boxer_tpu_torch.parallel.mesh import num_processes
    from boxer_tpu_torch.trainer.base_trainer import resolve_device

    resolve_device(args.device)
    backend = "nccl" if args.device == "cuda" else "gloo"
    if distributed.initialize_if_needed(backend):
        return train(args)
    world = num_processes(
        configuration(args).get_config().get("distributed", {}) or {})
    if world == 1:
        return train(args)
    devices = None
    if args.device == "cuda":
        cards = torch.cuda.device_count()
        if world > cards:
            raise RuntimeError(f"{world} processes of one card each, but "
                               f"{cards} CUDA cards are visible")
        devices = list(range(world))
    distributed.launch(train, world, backend, args=(args,), devices=devices)
    return None


if __name__ == "__main__":
    run()
