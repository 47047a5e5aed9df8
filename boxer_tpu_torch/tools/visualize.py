"""Inference visualization: a BoxeR-2D's boxes (and masks, when the model
has them) drawn on an image and written as a PNG; port of
`tools/visualize.py`.

  python -m boxer_tpu_torch.tools.visualize --config <yaml> --model boxer2d \
      [--weights <save_dir>/model_final] [--image photo.jpg] [--out viz.png] \
      [--device cuda|cpu] [key.path=value ...]

The image is resized to a short side of `--min-size` (at most `--max-size`
on the long side), normalized with ImageNet's mean and std and padded to a
multiple of 64, as the JAX tool does; without `--image` a seeded random
image of `--min-size` rows stands in. The weights are seeded
(`init_weights(0)`) unless `--weights` names the port's weights-only export
(`utils/checkpoint.py:Checkpoint.finalize`). Runs on the first CUDA card
unless `--device cpu` is given; without a card `--device cuda` (the
default) raises.
"""

import argparse

import numpy as np
import torch

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def get_parser():
    parser = argparse.ArgumentParser(description="boxer_tpu_torch visualize")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--task", type=str, default="detection")
    parser.add_argument("--model", type=str, default="boxer2d")
    parser.add_argument("--weights", type=str, default=None,
                        help="the port's weights-only export (model_final)")
    parser.add_argument("--image", type=str, default=None)
    parser.add_argument("--out", type=str, default="viz.png")
    parser.add_argument("--num-classes", type=int, default=91)
    parser.add_argument("--threshold", type=float, default=0.4)
    parser.add_argument("--min-size", type=int, default=800)
    parser.add_argument("--max-size", type=int, default=1333)
    parser.add_argument("--bf16", action=argparse.BooleanOptionalAction,
                        default=True)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda (the default) or cpu; never a fallback")
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    return parser


def load_image(path, min_size: int, max_size: int) -> np.ndarray:
    """(H, W, 3) f32 in [0, 1]: the image resized to a short side of
    min_size, the long side at most max_size; a seeded random
    (min_size, min_size * 1.52) image without a path."""
    from PIL import Image

    if path is None:
        return np.random.RandomState(0).rand(
            min_size, min_size * 1216 // 800, 3).astype(np.float32)
    pil = Image.open(path).convert("RGB")
    w, h = pil.size
    scale = min_size / min(w, h)
    if max(w, h) * scale > max_size:
        scale = max_size / max(w, h)
    pil = pil.resize((int(w * scale), int(h * scale)), Image.BILINEAR)
    return np.asarray(pil, np.float32) / 255.0


def main(argv=None):
    """Writes the PNG; returns (its path, the number of detections)."""
    from PIL import Image

    from boxer_tpu_torch.dataset.coco import _paste_masks_np
    from boxer_tpu_torch.models import build_model
    from boxer_tpu_torch.trainer.base_trainer import resolve_device
    from boxer_tpu_torch.utils.config import Configuration
    from boxer_tpu_torch.utils.visualization import draw_boxes, draw_masks

    args = get_parser().parse_args(argv)
    device = resolve_device(args.device)
    config = Configuration(config_path=args.config, opts=args.opts,
                           extra={"task": args.task, "model": args.model},
                           device=args.device).get_config()
    model = build_model(config.model_config[args.model],
                        args.num_classes).init_weights(0).eval()
    if args.weights:
        model.load_state_dict(torch.load(args.weights, map_location="cpu",
                                         weights_only=True))
        print(f"loaded weights from {args.weights}")
    model = model.to(device, torch.bfloat16 if args.bf16 else torch.float32)

    raw = load_image(args.image, args.min_size, args.max_size)
    h, w = raw.shape[:2]
    ph, pw = -(-h // 64) * 64, -(-w // 64) * 64
    image = np.zeros((1, ph, pw, 3), np.float32)
    image[0, :h, :w] = (raw - MEAN) / STD
    mask = np.ones((1, ph, pw), bool)
    mask[0, :h, :w] = False
    with torch.no_grad():
        out = model(torch.from_numpy(image).to(device),
                    torch.from_numpy(mask).to(device), train=False,
                    inference=True)

    def host(key):
        return out[key][0].float().cpu().numpy()

    prob = 1 / (1 + np.exp(-host("pred_logits")))
    scores, labels = prob.max(-1), prob.argmax(-1)
    keep = scores > args.threshold
    boxes = host("pred_boxes")
    xyxy = np.concatenate([boxes[:, :2] - boxes[:, 2:] / 2,
                           boxes[:, :2] + boxes[:, 2:] / 2], -1)
    xyxy = xyxy * np.array([pw, ph, pw, ph], np.float32)

    canvas = np.pad((raw * 255).astype(np.uint8),
                    ((0, ph - h), (0, pw - w), (0, 0)))
    img = draw_boxes(canvas, xyxy[keep], labels[keep], scores[keep])
    if "pred_masks" in out:
        m = 1 / (1 + np.exp(-host("pred_masks")))
        pasted = _paste_masks_np(m[keep], xyxy[keep], (ph, pw)) >= 0.5
        img = draw_masks(img, pasted, labels[keep])
    Image.fromarray(img[:h, :w]).save(args.out)
    print(f"wrote {args.out} ({int(keep.sum())} detections)")
    return args.out, int(keep.sum())


if __name__ == "__main__":
    main()
