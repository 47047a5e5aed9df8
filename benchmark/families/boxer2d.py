"""BoxeR-2D instance segmentation (`boxer_tpu_torch/models/boxer2d.py`) as
the benchmark serves and judges it.

The served forward is the port's inference fast path: `BoxeR2D.forward(
image, mask, postprocess={"canvas_hw", "topk"})`, through the deferred
top-k mask decode, in the configuration's dtype. Scores,
labels and boxes come back to the host; the masks stay on the card, done by
the same synchronize.

The check: the reference (`reference/boxer2d.py`, f32, the served bf16
weights) runs each judged image once, following the program's discrete
choices (which encoder tokens became proposals and which queries the top-k
kept, recorded from the port's calls; the labels it returned; which class
channel each mask was decoded from). Each choice is judged by how far the
reference's own logit of it lies below the reference's k-th best
(`proposal_gap`, `topk_gap`, in logits); `box_err` is the largest error of
a returned box (pixels); `mask_logit_rms` the relative RMS error of the
mask head's logits, recorded from the port's call; `mask_paste_err` the
pixels where the returned masks differ from the paste and threshold of
those logits at the returned boxes (exact); `score_mae` the mean error of
the returned, mask-rescored scores against the reference's class
probability times its mean mask probability over the returned pixels.
"""

import torch

import counts
from harness import data, weights
from reference.postprocess import paste_masks_mxu

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _build(cls, config, device, seed, **kw):
    """The model with the seed's weights, in the served dtype."""
    with torch.device(device):
        model = cls(**config["model"], **kw)
    weights.fill_(model, data.substream(seed, "weights"), device,
                  config.get("weight_scales"))
    return model.to(DTYPES[config["dtype"]]).eval()


class Program:
    def __init__(self, config, traffic, device, seed):
        from boxer_tpu_torch.models.boxer2d import BoxeR2D
        from boxer_tpu_torch.nn import box_transformer

        self.config, self.traffic, self.device = config, traffic, device
        self.model = _build(BoxeR2D, config, device, seed)
        self.post = {"canvas_hw": tuple(traffic["canvas"]),
                     "topk": traffic["topk"]}
        b, pool = traffic["batch"], traffic["pool"]
        imgs = data.images(seed, b * pool, traffic["canvas"], device)
        mask = torch.zeros((b, *traffic["canvas"]), dtype=torch.bool)
        if torch.device(device).type == "cuda":
            mask = mask.pin_memory()
        self.inputs = [{"image": imgs[i * b:(i + 1) * b], "mask": mask}
                       for i in range(pool)]
        self.images = imgs

        # the program's discrete choices of the last forward, for the check
        self.choices = {}
        tr = self.model.transformer
        proposals = tr._get_enc_proposals

        def record_proposals(*args, **kw):
            out = proposals(*args, **kw)
            self.choices["proposals"] = out[3]
            return out

        tr._get_enc_proposals = record_proposals
        self._bt, self._select = box_transformer, box_transformer.select_topk

        def record_topk(*args, **kw):
            out = self._select(*args, **kw)
            self.choices["topk"] = out[2]
            return out

        box_transformer.select_topk = record_topk
        head = self.model.detector.mask_embed
        head.register_forward_pre_hook(
            lambda mod, args, kw: self.choices.__setitem__(
                "mask_class", kw["select"]), with_kwargs=True)
        head.register_forward_hook(
            lambda mod, args, out: self.choices.__setitem__(
                "mask_logits", out))

    def to_device(self, batch):
        return {k: v.to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def forward(self, batch):
        return self.model(batch["image"], batch["mask"],
                          postprocess=self.post)

    def to_host(self, out):
        host = {k: out[k].cpu() for k in ("scores", "labels", "boxes")}
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)
        return host

    def keep(self, pool_index, samples, host, out):
        """The judged samples' results and the choices behind them."""
        b = self.traffic["batch"]
        q = self.choices["topk"]
        recs = []
        for i in samples:
            rec = {"input": self.images[pool_index * b + i],
                   "scores": host["scores"][i], "labels": host["labels"][i],
                   "boxes": host["boxes"][i],
                   "proposals": self.choices["proposals"][i].cpu(),
                   "q": q[i].cpu(), "masks": out["masks"][i].cpu(),
                   "mask_class": self.choices["mask_class"].reshape(
                       b, -1)[i].cpu(),
                   "mask_logits": self.choices["mask_logits"][0][i].float(
                       ).cpu()}
            recs.append(rec)
        return recs

    def flops_per_sample(self) -> int:
        shapes = dict(self.config["model"], **self.config["shapes"])
        return counts.total(counts.boxer2d_forward(
            shapes, tuple(self.traffic["canvas"]), self.traffic["topk"]))

    def free(self):
        self._bt.select_topk = self._select
        del self.model
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()


def reference(config, device, seed, control=False):
    """The f32 reference on the served weights; with control, the same
    computed in fp8 (`reference/control.py`)."""
    from reference.boxer2d import BoxeR2D
    from reference.control import to_fp8

    # f32 on the weights the program serves
    model = _build(BoxeR2D, config, device, seed).float()
    return to_fp8(model) if control else model


def _inputs(traffic, device, rec):
    """The judged image, as the program got it."""
    return (rec["input"][None].to(device),
            torch.zeros((1, *traffic["canvas"]), dtype=torch.bool,
                        device=device))


def _kth_gap(scores, chosen, k):
    """How far the chosen entries of `scores` lie below its k-th best."""
    kth = torch.topk(scores.float().reshape(-1), k).values[-1]
    return float((kth - scores.float().reshape(-1)[chosen]).clamp(min=0).max())


def _judge_one(ref, rec, image, mask, post):
    """The numbers of one judged image (module docstring)."""
    dev = image.device
    tr = ref.transformer
    tr.forced = {"proposals": rec["proposals"][None].to(dev),
                 "topk": (rec["q"][None].to(dev), rec["labels"][None].to(dev)),
                 "mask_class": rec["mask_class"][None].to(dev)}
    tr.seen = {}
    out = ref(image, mask, postprocess=post)
    seen = tr.seen
    logits = seen["proposals"][1][0]
    got = {"proposal_gap": _kth_gap(logits, rec["proposals"].to(dev),
                                    rec["proposals"].numel())}
    cls = seen["topk"][1][0]                               # (NQ, C)
    flat = rec["q"].to(dev) * cls.shape[-1] + rec["labels"].to(dev)
    got["topk_gap"] = _kth_gap(cls, flat, rec["q"].numel())
    got["box_err"] = float((out["boxes"][0].cpu() - rec["boxes"]).abs().max())

    # the mask head: the program's mask logits against the reference's
    ref_logits = seen["mask_logits"][0].float().cpu()
    got["mask_logit_rms"] = float(
        (rec["mask_logits"] - ref_logits).square().mean().sqrt()
        / ref_logits.square().mean().sqrt())
    # the paste and threshold, from the program's own logits and boxes,
    # exactly; the rescored score against the reference's class
    # probability times its mean mask probability over the program's pixels
    boxes = rec["boxes"].to(dev)
    shape = tuple(rec["masks"].shape[1:])
    own = paste_masks_mxu(torch.sigmoid(rec["mask_logits"].to(dev)), boxes,
                          shape) >= 0.5
    got["mask_paste_err"] = float((own.cpu() != rec["masks"]).sum())
    del own
    prob = torch.sigmoid(seen["mask_logits"][0].float())
    ref_cls = torch.sigmoid(cls.float().reshape(-1)[flat])
    errs = []
    for k in range(prob.shape[0]):
        p = paste_masks_mxu(prob[k:k + 1], boxes[k:k + 1], shape)[0]
        m = rec["masks"][k].to(dev)
        mean = float((p * m).sum() / m.sum().clamp(min=1))
        errs.append(abs(float(ref_cls[k]) * mean - float(rec["scores"][k])))
    got["score_mae"] = sum(errs) / len(errs)
    return got


def judge(config, traffic, device, seed, records) -> dict:
    """The largest of each number over the judged samples."""
    if not records:
        return {}
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = reference(config, device, seed)
        post = {"canvas_hw": tuple(traffic["canvas"]), "topk": traffic["topk"]}
        worst = {}
        with torch.no_grad():
            for rec in records:
                got = _judge_one(ref, rec, *_inputs(traffic, device, rec),
                                 post)
                for k, v in got.items():
                    worst[k] = max(worst.get(k, 0.0), v)
        return worst
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev


def control_records(config, traffic, device, seed, records) -> list:
    """The control in the program's place: the fp8 reference's own results
    and choices on the judged images, in the form `keep` gives."""
    ctl = reference(config, device, seed, control=True)
    post = {"canvas_hw": tuple(traffic["canvas"]), "topk": traffic["topk"]}
    out_recs = []
    with torch.no_grad():
        for rec in records:
            image, mask = _inputs(traffic, device, rec)
            ctl.transformer.forced, ctl.transformer.seen = {}, {}
            out = ctl(image, mask, postprocess=post)
            seen = ctl.transformer.seen
            q, _ = seen["topk"][0]
            new = {"input": rec["input"], "scores": out["scores"][0].cpu(),
                   "labels": out["labels"][0].cpu(),
                   "boxes": out["boxes"][0].cpu(),
                   "proposals": seen["proposals"][0][0].cpu(),
                   "q": q[0].cpu(), "masks": out["masks"][0].cpu(),
                   "mask_class": seen["mask_class"][0][0].cpu(),
                   "mask_logits": seen["mask_logits"][0].float().cpu()}
            out_recs.append(new)
    return out_recs
