"""Training metrics; port of `boxer_tpu/criterion/metrics.py`.

Parity: reference `e2edet/criterion/metrics.py` — Accuracy (top-k on matched
logits, :64-88) and Cardinality (predicted-vs-GT count error, :91-107),
registry (:9-34). Metrics are functions of the outputs and the final
matching the criterion exposes (`_query_idx`/`_valid`); they carry no
gradient. Each is a `Metric`: its value is a function of sums over the
batch's images, which a data-parallel step adds over the ranks before it
takes the value, so the value is the global batch's.
"""

from typing import Dict

import torch

from boxer_tpu_torch.utils.registry import METRIC_REGISTRY


def register_metric(name):
    return METRIC_REGISTRY.register(name)


class Metric:
    """A metric that is a function of sums over the batch's images:
    `parts(outputs, targets, query_idx, valid)` gives (num, den), which add
    over images, so over the ranks of a data-parallel update too, and the
    value is `finish(num, den)`. Calling it gives the value."""

    def __init__(self, parts, finish):
        self.parts = parts
        self.finish = finish

    def __call__(self, *args, **kwargs):
        return self.finish(*self.parts(*args, **kwargs))


@torch.no_grad()
def _accuracy_parts(outputs, targets, query_idx, valid, topk: int = 1):
    logits = outputs["pred_logits"].float()                    # (B, NQ, C)
    matched = torch.gather(
        logits, 1, query_idx[..., None].expand(-1, -1, logits.shape[-1]))
    k = min(topk, logits.shape[-1])
    # a stable descending sort: ties keep the lower class first, as the JAX
    # package's argsort of the negated logits
    top = torch.sort(matched, dim=-1, descending=True, stable=True)[1][..., :k]
    correct = (top == targets["labels"][..., None].long()).any(-1)
    vf = valid.float()
    return (correct.float() * vf).sum(), vf.sum()


# top-k accuracy over matched (query, target-label) pairs, in %
accuracy = register_metric("accuracy")(Metric(
    _accuracy_parts, lambda num, den: num / den.clamp(min=1.0) * 100.0))


@torch.no_grad()
def _cardinality_parts(outputs, targets, query_idx, valid):
    logits = outputs["pred_logits"].float()
    prob = torch.where(torch.isfinite(logits), logits,
                       torch.full_like(logits, -float("inf"))).amax(-1)
    pred_count = (prob > 0.0).float().sum(1)
    gt_count = valid.float().sum(1)
    return ((pred_count - gt_count).abs().sum(),
            logits.new_full((), float(logits.shape[0])))


# |#high-confidence predictions - #GT| per image, averaged
cardinality = register_metric("cardinality")(Metric(
    _cardinality_parts, lambda num, den: num / den))


def build_metrics(metric_configs) -> Dict[str, callable]:
    out = {}
    for m in metric_configs or []:
        name = m["type"]
        out[name] = METRIC_REGISTRY.get(name)
    return out


def compute_metrics(metrics: Dict, outputs, targets, losses
                    ) -> Dict[str, torch.Tensor]:
    """Evaluate configured metrics using the criterion's final matching."""
    if "_query_idx" not in losses:
        return {}
    qi = losses["_query_idx"]
    valid = losses["_valid"]
    return {name: fn(outputs, targets, qi, valid)
            for name, fn in metrics.items()}
