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
files exist), val, or test. It runs on the first CUDA card unless
`--device cpu` asks for the CPU; without a card it raises before it builds
anything. The model `detr` and a `distributed` layout of more than one
process raise NotImplementedError, naming their ROADMAP item.
"""

import argparse


def get_parser():
    parser = argparse.ArgumentParser(description="boxer_tpu_torch runner")
    parser.add_argument("--config", type=str, default=None,
                        help="experiment yaml")
    parser.add_argument("--task", type=str, default="detection",
                        help="detection (COCO) or detection3d (Waymo)")
    parser.add_argument("--model", type=str, default="boxer2d",
                        help="boxer2d (with detection) or boxer3d (with "
                        "detection3d)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda (the default) or cpu; never a fallback")
    parser.add_argument("opts", nargs=argparse.REMAINDER,
                        help="dotlist overrides: key.path=value")
    return parser


def run(argv=None):
    args = get_parser().parse_args(argv)

    from boxer_tpu_torch.trainer import build_trainer
    from boxer_tpu_torch.trainer.base_trainer import resolve_device
    from boxer_tpu_torch.utils.config import Configuration

    resolve_device(args.device)
    configuration = Configuration(
        config_path=args.config,
        opts=args.opts,
        extra={"task": args.task, "model": args.model},
        device=args.device,
    )
    trainer = build_trainer(configuration, device=args.device)
    trainer.load()

    run_type = trainer.running_config.get("run_type", "train_val_test")
    if "train" in run_type:
        trainer.train()
    elif "val" in run_type:
        trainer.evaluate("val")
    else:
        trainer.inference()
    return trainer


if __name__ == "__main__":
    run()
