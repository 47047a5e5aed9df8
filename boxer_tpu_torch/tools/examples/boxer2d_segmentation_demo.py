"""Worked example: BoxeR-2D instance segmentation, end to end; port of
`tools/examples/boxer2d_segmentation_demo.py` (the reference's demo
notebook `tools/visualization/BoxeR_2d_segmentation.ipynb`).

Builds the instance-segmentation model (R50, hidden 256, 8 heads, 6+6
layers, 300 queries), runs one image through preprocessing, inference and
the on-device postprocess (top-k selection, box rescale, mask paste and
rescoring) and writes an overlay PNG. Needs no checkpoint: with seeded
random weights (`init_weights(0)`) it shows the pipeline mechanically;
`--weights` loads the port's weights-only export (`model_final`).

  python -m boxer_tpu_torch.tools.examples.boxer2d_segmentation_demo \
      [--image photo.jpg] [--weights save/model_final] [--out demo.png] \
      [--device cuda|cpu]

Runs on the first CUDA card unless `--device cpu` is given; without a card
`--device cuda` (the default) raises.
"""

import argparse

import numpy as np
import torch

MODEL = dict(num_classes=91, hidden_dim=256, nhead=8, num_level=4,
             enc_layers=6, dec_layers=6, dim_feedforward=1024,
             num_queries=300, use_mask=True, backbone_arch="resnet50")


def get_parser():
    ap = argparse.ArgumentParser(description="BoxeR-2D segmentation demo")
    ap.add_argument("--image", default=None, help="input photo (else "
                    "synthetic)")
    ap.add_argument("--weights", default=None,
                    help="the port's weights-only export (model_final)")
    ap.add_argument("--out", default="demo.png")
    ap.add_argument("--threshold", type=float, default=0.3)
    ap.add_argument("--size", type=int, default=512, help="short-side resize")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the default) or cpu; never a fallback")
    return ap


def demo_image(path, size: int) -> np.ndarray:
    """(H, W, 3) f32 in [0, 1]: the photo resized to a short side of size,
    or a seeded (size, size) image of four coloured discs."""
    from PIL import Image

    if path:
        pil = Image.open(path).convert("RGB")
        scale = size / min(pil.size)
        pil = pil.resize((int(pil.width * scale), int(pil.height * scale)))
        return np.asarray(pil, np.float32) / 255.0
    rng = np.random.default_rng(0)
    img = np.full((size, size, 3), 0.35, np.float32)
    yy, xx = np.ogrid[:size, :size]
    for _ in range(4):
        cy, cx = rng.integers(60, size - 60, 2)
        r = int(rng.integers(24, 56))
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.random(3)
    return img


def main(argv=None, model_kwargs=None):
    """Writes the PNG; returns (its path, the number of instances kept).
    model_kwargs overrides MODEL's widths."""
    from PIL import Image

    from boxer_tpu_torch.models.boxer2d import BoxeR2D
    from boxer_tpu_torch.trainer.base_trainer import resolve_device
    from boxer_tpu_torch.utils.visualization import draw_boxes, draw_masks

    args = get_parser().parse_args(argv)
    device = resolve_device(args.device)

    # 1. the image, ImageNet-normalized; one image, no padding
    img = demo_image(args.image, args.size)
    h, w = img.shape[:2]
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    x = torch.from_numpy((img - mean) / std)[None].to(device)
    pad_mask = torch.zeros((1, h, w), dtype=torch.bool, device=device)

    # 2. the model in bf16, with the deferred top-k mask decode and the
    # on-device postprocess
    model = BoxeR2D(**dict(MODEL, **(model_kwargs or {}))).init_weights(0)
    if args.weights:
        model.load_state_dict(torch.load(args.weights, map_location="cpu",
                                         weights_only=True))
    model = model.eval().to(device, torch.bfloat16)
    with torch.no_grad():
        out = model(x, pad_mask, train=False, inference=True,
                    postprocess={"canvas_hw": (h, w), "topk": 50})

    # 3. the overlay: scores, labels, boxes and masks are final
    def host(key):
        t = out[key][0]
        return (t.float() if t.is_floating_point() else t).cpu().numpy()

    scores, labels = host("scores"), host("labels")
    keep = scores > args.threshold
    print(f"{int(keep.sum())} instances above {args.threshold:.2f} "
          f"(top score {scores.max():.3f})")
    canvas = (img * 255).astype(np.uint8)
    if keep.any():
        canvas = draw_masks(canvas, host("masks")[keep] > 0.5,
                            labels=labels[keep])
        canvas = draw_boxes(canvas, host("boxes")[keep], labels=labels[keep],
                            scores=scores[keep])
    Image.fromarray(canvas).save(args.out)
    print(f"wrote {args.out}")
    return args.out, int(keep.sum())


if __name__ == "__main__":
    main()
