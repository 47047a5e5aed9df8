"""Optimizer, LR schedule and gradient clipping; port of
`boxer_tpu/optim/__init__.py`.

- `multi_step`, `step` and `cosine_annealing` schedules with their linear
  warmup; the first two on the iteration or the epoch clock;
  `build_schedule`. A schedule is a multiplicative factor of the update
  index (the number of updates taken), applied to each group's base LR.
- `label_params`: `backbone` (any name containing "backbone"), `deform`
  (`linear_box` parameters outside the backbone, lr * deform_lr_multi) and
  `transformer` (everything else).
- `build_optimizer`: `torch.optim.AdamW` or `torch.optim.SGD` with one
  param group per label. torch's decoupled AdamW and optax's `adamw` take
  the same update: p <- p * (1 - lr*wd) - lr * m_hat / (sqrt(v_hat) + eps).
  torch's SGD with dampening 0 keeps optax's `sgd` trace (t <- g + mu*t,
  nesterov g + mu*t) and, as optax's `sgd`, no weight decay.
- `clip_by_global_norm`: scale = min(1, max_norm / (norm + 1e-6)).
"""

import math
from typing import Callable, Dict, Optional

import torch

from boxer_tpu_torch.utils.registry import SCHEDULER_REGISTRY


def _warmup_factor(step, warmup_iterations, warmup_factor):
    alpha = step / max(warmup_iterations, 1)
    return warmup_factor * (1.0 - alpha) + alpha


@SCHEDULER_REGISTRY.register("multi_step")
def multi_step_schedule(config) -> Callable[[int], float]:
    """Decay by lr_ratio at each of lr_steps (reached at the threshold);
    `mode: epoch` counts the thresholds in epochs of `_steps_per_epoch`
    updates, while warmup stays on the iteration clock."""
    lr_steps = tuple(config["lr_steps"])
    lr_ratio = config["lr_ratio"]
    use_warmup = config.get("use_warmup", False)
    warmup_iterations = config.get("warmup_iterations", 0)
    wf = config.get("warmup_factor", 1.0)
    epoch_mode = config.get("mode", "iter") == "epoch"
    spe = max(1, int(config.get("_steps_per_epoch", 1)))

    def schedule(step: int) -> float:
        clock = math.floor(step / spe) if epoch_mode else step
        factor = lr_ratio ** sum(1 for s in lr_steps if clock >= s)
        if use_warmup and warmup_iterations > 0 and step <= warmup_iterations:
            return _warmup_factor(step, warmup_iterations, wf)
        return factor

    return schedule


@SCHEDULER_REGISTRY.register("step")
def step_schedule(config) -> Callable[[int], float]:
    """Decay by lr_ratio every step_size steps of the clock (iterations, or
    epochs of `_steps_per_epoch` updates with `mode: epoch`); warmup on the
    iteration clock."""
    step_size = config["step_size"]
    lr_ratio = config.get("lr_ratio", 0.1)
    use_warmup = config.get("use_warmup", False)
    warmup_iterations = config.get("warmup_iterations", 0)
    wf = config.get("warmup_factor", 1.0)
    epoch_mode = config.get("mode", "iter") == "epoch"
    spe = max(1, int(config.get("_steps_per_epoch", 1)))

    def schedule(step: int) -> float:
        clock = math.floor(step / spe) if epoch_mode else step
        if use_warmup and warmup_iterations > 0 and step <= warmup_iterations:
            return _warmup_factor(step, warmup_iterations, wf)
        return lr_ratio ** math.floor(clock / step_size)

    return schedule


@SCHEDULER_REGISTRY.register("cosine_annealing")
def cosine_schedule(config) -> Callable[[int], float]:
    """Cosine from 1 down to the floor eta_ratio = eta_min / _max_base_lr
    over T_max iterations after the warmup: every group's LR ends at
    lr_i / max_lr * eta_min, as the reference's per-group eta_min."""
    eta_min = config.get("eta_min", 0.0)
    t_max = config["T_max"]
    use_warmup = config.get("use_warmup", False)
    warmup_iterations = (config.get("warmup_iterations", 0) if use_warmup
                         else 0)
    wf = config.get("warmup_factor", 1.0)
    max_lr = config["_max_base_lr"]
    eta_ratio = eta_min / max_lr if max_lr > 0 else 0.0
    t_eff = t_max - warmup_iterations

    def schedule(step: int) -> float:
        if warmup_iterations > 0 and step <= warmup_iterations:
            return _warmup_factor(step, warmup_iterations, wf)
        cos_term = (1.0 + math.cos(
            math.pi * (step - warmup_iterations) / t_eff)) / 2.0
        return eta_ratio + (1.0 - eta_ratio) * cos_term

    return schedule


def build_schedule(config, base_lr: float):
    cfg = dict(config["params"]) if "params" in config else dict(config)
    cfg["_max_base_lr"] = base_lr
    return SCHEDULER_REGISTRY.get(config["type"])(cfg)


def label_params(model: torch.nn.Module) -> Dict[str, str]:
    """{parameter name: group label}."""
    def label(name: str) -> str:
        if "backbone" in name:
            return "backbone"
        if "linear_box" in name:
            return "deform"
        return "transformer"

    return {n: label(n) for n, _ in model.named_parameters()}


def build_optimizer(config, model: torch.nn.Module):
    """AdamW or SGD over three param groups. `config` is the optimizer node:
    {type: adamw|sgd, params: {lr, lr_backbone, deform_lr_multi; adamw:
    weight_decay, betas, eps; sgd: momentum, nesterov}}. Each group keeps
    its unscheduled LR as `base_lr`; the train step sets
    `lr = base_lr * schedule(step)` before updating."""
    opt_type = config["type"]
    if opt_type not in ("adamw", "sgd"):
        raise ValueError(f"Unsupported optimizer: {opt_type}")
    p = config["params"]
    lr = p["lr"]
    base = {"backbone": p.get("lr_backbone", lr), "transformer": lr,
            "deform": lr * p.get("deform_lr_multi", 1.0)}
    labels = label_params(model)
    groups = []
    for name in ("backbone", "transformer", "deform"):
        params = [t for n, t in model.named_parameters() if labels[n] == name]
        groups.append({"name": name, "params": params, "lr": base[name],
                       "base_lr": base[name]})
    if opt_type == "sgd":
        return torch.optim.SGD(groups, lr=lr,
                               momentum=p.get("momentum", 0.9),
                               nesterov=p.get("nesterov", False),
                               dampening=0)
    betas = tuple(p.get("betas", (0.9, 0.999)))
    return torch.optim.AdamW(groups, lr=lr, betas=betas,
                             eps=p.get("eps", 1e-8),
                             weight_decay=p.get("weight_decay", 1e-4))


def set_lr(optimizer: torch.optim.Optimizer,
           schedule: Optional[Callable[[int], float]], step: int):
    factor = 1.0 if schedule is None else schedule(step)
    for group in optimizer.param_groups:
        group["lr"] = group["base_lr"] * factor


@torch.no_grad()
def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


@torch.no_grad()
def clip_by_global_norm(tensors, max_norm: float,
                        norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scale the tensors in place by min(1, max_norm / (norm + 1e-6));
    max_norm <= 0 leaves them. `norm` (default: the tensors' global norm)
    is the norm of the whole gradient, where a rank holds only a part.
    Returns the norm before clipping."""
    tensors = list(tensors)
    if norm is None:
        norm = global_norm(tensors)
    if max_norm is not None and max_norm > 0:
        scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
        for t in tensors:
            t.mul_(scale.to(t.dtype))
    return norm
