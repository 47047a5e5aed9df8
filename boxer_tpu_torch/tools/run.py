"""CLI entry point of the port; counterpart of the JAX package's
`tools/run.py`:

  python -m boxer_tpu_torch.tools.run --config <yaml> --task detection \
      --model boxer2d [--device cuda|cpu] [key.path=value ...]

`training.run_type` picks the run: train (then val and test, as the split
files exist), val, or test. It runs on the first CUDA card unless
`--device cpu` asks for the CPU; without a card it raises before it builds
anything. The task `detection3d`, the model `detr` and a `distributed`
layout of more than one process raise NotImplementedError, naming their
ROADMAP item.
"""

import argparse


def get_parser():
    parser = argparse.ArgumentParser(description="boxer_tpu_torch runner")
    parser.add_argument("--config", type=str, default=None,
                        help="experiment yaml")
    parser.add_argument("--task", type=str, default="detection")
    parser.add_argument("--model", type=str, default="boxer2d")
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
