"""The training, eval and inference steps; port of
`boxer_tpu/parallel/steps.py`.

One update: forward + criterion (matching on the step's device) and
backward for each microbatch, the gradients summed over microbatches that
share the update's global `num_boxes`; then the global-norm clip, the
NaN/Inf skip (no update, no optimizer-state change, step not advanced) and
the optimizer's update at the scheduled LR. A batch is an image batch
(BoxeR-2D) or a voxel batch (BoxeR-3D), as `apply_model` dispatches. On a
CUDA card the forward runs under `torch.autocast(bfloat16)` when
`compute_dtype` is bf16, with parameters in f32: the torch idiom for
flax's `dtype=bf16` modules. The eval and inference steps run the model in
`eval()` under `torch.no_grad()` and the same autocast.

In a process group the step runs on its `layout` (`parallel/mesh.py`):
the ranks of one data shard (one dp index) hold the same batch, the model
cut over mp (`parallel/sharding.py`) and, under sp, BoxeR-2D's encoder
tokens split over sp, and the update is the global batch's, as the JAX
package's one step over its mesh computes it:
- the target count is summed over dp before the forward (the losses are
  over the global `num_boxes`);
- each rank's loss is divided by sp: the decoder, the heads and the losses
  run whole on every sp rank, and the encoder's gather sums its tokens'
  cotangents over sp, so the gradients summed over dp x sp (the grad
  group) are the global batch's;
- under mp the replicated parameters' gradients are summed over every
  rank and divided by mp (the mp ranks hold the same ones: this keeps
  their copies bitwise equal whatever order each one's backward added
  in), the mp-cut ones over the grad group; without mp one all_reduce of
  one flat buffer sums the gradients and, where dp is the grad group, the
  stats' sums (loss terms, the metrics' parts); otherwise the stats go
  over dp alone;
- the global norm adds the squares of the mp-cut gradients over mp and
  counts the replicated ones once, so the clip, the NaN/Inf skip and the
  optimizer act on the same gradient on every rank.

Dropout: each microbatch's forward gets a `DropoutKey` of (the step's
`dropout_seed`, the update index, the microbatch, the dp rank, the dp
size) (`nn/dropout.py`), as JAX splits a key per update and per microbatch
(`boxer_tpu/parallel/steps.py:112`). The update index is the caller's count
of update calls, a skipped one included (`state.step` counts only the
updates taken), so a resume or a rerun draws the same masks.
"""

import contextlib
import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from boxer_tpu_torch.criterion.losses import weighted_total
from boxer_tpu_torch.criterion.metrics import Metric
from boxer_tpu_torch.nn.dropout import DropoutKey
from boxer_tpu_torch.optim import clip_by_global_norm, set_lr
from boxer_tpu_torch.parallel import distributed
from boxer_tpu_torch.parallel.mesh import Layout, create_layout
from boxer_tpu_torch.parallel.sharding import gather_state, tp_rule
from boxer_tpu_torch.utils.timer import span


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Optional[Callable[[int], float]] = None
    step: int = 0                  # completed updates


def apply_model(model, batch, train: bool, inference: bool,
                dropout_key: Optional[DropoutKey] = None):
    """The model on one (micro)batch of either family: image/mask (2D) or
    voxels/coordinates/num_points_per_voxel with the static grid_shape
    (nx, ny) and batch_size (3D)."""
    if "voxels" in batch:
        return model(batch["voxels"], batch["coordinates"],
                     batch["num_points_per_voxel"], tuple(batch["grid_shape"]),
                     int(batch["batch_size"]), train=train,
                     inference=inference, dropout_key=dropout_key)
    return model(batch["image"], batch.get("mask"), train=train,
                 inference=inference, dropout_key=dropout_key)


def microbatch(batch, a: int):
    """Microbatch a of an update's batch: every array's leading (A) index;
    the static entries (grid_shape, batch_size) and a missing mask as
    they are."""
    def pick(v):
        if isinstance(v, dict):
            return {k: pick(x) for k, x in v.items()}
        return v[a] if isinstance(v, torch.Tensor) else v
    return {k: pick(v) for k, v in batch.items()}


def _autocast(compute_dtype, device):
    if compute_dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=compute_dtype)


def _final(out):
    return {k: v for k, v in out.items()
            if k not in ("aux_outputs", "enc_outputs")}


def make_train_step(criterion, max_norm: float = 0.0,
                    compute_dtype: torch.dtype = torch.float32,
                    metrics=None, debug_grads: bool = False,
                    dropout_seed: int = 0,
                    layout: Optional[Layout] = None) -> Callable:
    """Returns train_step(state, batch, update=None) -> (state, stats),
    updating `state` in place; `update` (default `state.step`) is the
    update index of the dropout key. `layout`: the run's, the model cut to
    it (None: data parallel over the process group's ranks, a world of one
    without a group).

    batch = {"image": (A, B, H, W, 3), "mask": (A, B, H, W) or None,
             "targets": {labels (A,B,NT), boxes (A,B,NT,4), valid (A,B,NT)
                         [, instance_masks (A,B,NT,s,s)]}}
    or, for BoxeR-3D, {"voxels": (A, V, P, F), "coordinates": (A, V, 4),
    "num_points_per_voxel": (A, V), "grid_shape": (nx, ny), "batch_size":
    B, "targets": {labels, boxes (A,B,NT,7), valid}}, each microbatch's
    voxel block holding its B samples' fixed `max_voxels` blocks with
    batch indices 0..B-1 (the loader's split), with A = iter_per_update
    microbatches, all on the model's device.
    stats: every loss term and every metric of `metrics` ({name: fn},
    `criterion.metrics.build_metrics`; on the final layer's matching),
    summed over microbatches, total_loss, grad_norm (before clipping),
    num_boxes, skipped (1.0 when the update was skipped) as host floats,
    read from the device in one copy; with debug_grads `_grads`, the
    pre-clip summed gradients by parameter name (over the ranks too, in a
    process group; whole, the mp parts gathered). In a process group every
    stat is the global batch's.
    """
    weight_dict = criterion.expanded_weight_dict(num_aux=16, num_enc=2)
    layout = layout if layout is not None else create_layout()
    dp, sp, mp, grad = layout.dp, layout.sp, layout.mp, layout.grad

    def train_step(state: TrainState, batch, update: Optional[int] = None):
        model = state.model
        update = state.step if update is None else update
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        params = [p for _, p in named]
        targets = batch["targets"]
        grouped = layout.world > 1
        if dp.size > 1 and metrics and not all(
                isinstance(fn, Metric) for fn in metrics.values()):
            raise ValueError("a metric summed over ranks must be a Metric "
                             "(criterion.metrics), with parts")
        # the target count over the whole update: every microbatch, every
        # data shard
        num_boxes = targets["valid"].float().sum()
        if dp.size > 1:
            distributed.all_reduce_sum(num_boxes, dp.group)
        num_boxes = num_boxes.clamp(min=1.0)
        model.train()
        for p in params:
            p.grad = None

        loss_acc, stats_acc, parts = 0.0, {}, {}
        for a in range(targets["valid"].shape[0]):
            mb = microbatch(batch, a)
            key = DropoutKey(dropout_seed, update, a, dp.index, dp.size)
            with span("boxer.train.forward"), _autocast(
                    compute_dtype, targets["valid"].device):
                out = apply_model(model, mb, train=True, inference=False,
                                  dropout_key=key)
            with span("boxer.train.loss"):
                losses = criterion(out, mb["targets"], num_boxes=num_boxes)
                total, stats = weighted_total(losses, weight_dict)
            if metrics and "_query_idx" in losses:
                args = (_final(out), mb["targets"], losses["_query_idx"],
                        losses["_valid"])
                for name, fn in metrics.items():
                    parts.setdefault(name, []).append(
                        fn.parts(*args) if isinstance(fn, Metric)
                        else (fn(*args),))
            with span("boxer.train.backward"):
                (total / sp.size if sp.size > 1 else total).backward()
            loss_acc = loss_acc + total.detach()
            for k, v in stats.items():
                stats_acc[k] = stats_acc.get(k, 0.0) + v.detach()

        # this process's unused parameters (None in `_grads` without a
        # group; in one, the gradients are the ranks' sums)
        unused = {id(p) for p in params if p.grad is None and not grouped}
        for p in params:
            # an unused parameter's gradient is zero, as under jax.grad, so
            # AdamW still decays it
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        cut = [p.grad for n, p in named if mp.size > 1 and tp_rule(n)]
        whole = ([p.grad for n, p in named if not tp_rule(n)]
                 if mp.size > 1 else grads)
        sums = [loss_acc, *stats_acc.values(),
                *(t for ps in parts.values() for part in ps for t in part)]
        with span("boxer.train.grad_sync"):
            if mp.size > 1:
                _sum_over_ranks(whole, None)
                for g in whole:
                    g.div_(mp.size)
                if grad.size > 1:
                    _sum_over_ranks(cut, grad.group)
            elif grad.size > 1 and grad.group is dp.group:
                _sum_over_ranks(grads + sums, dp.group)
                sums = []
            elif grad.size > 1:
                _sum_over_ranks(grads, grad.group)
            if sums and dp.size > 1:
                _sum_over_ranks(sums, dp.group)
        raw_grads = None
        if debug_grads:
            raw_grads = gather_state(
                {n: p.grad.clone() for n, p in named}, layout)
            raw_grads = {n: None if id(p) in unused else raw_grads[n]
                         for n, p in named}
        with span("boxer.train.optimizer"):
            norm = None
            if mp.size > 1:
                cut_sq = sum(g.float().square().sum() for g in cut)
                norm = torch.sqrt(
                    sum(g.float().square().sum() for g in whole)
                    + distributed.all_reduce_sum(cut_sq, mp.group))
            grad_norm = clip_by_global_norm(grads, max_norm, norm)
        for name, ps in parts.items():
            fn = metrics[name]
            for part in ps:
                value = fn.finish(*part) if isinstance(fn, Metric) else part[0]
                stats_acc[name] = stats_acc.get(name, 0.0) + value
        out_stats = dict(stats_acc, total_loss=loss_acc, grad_norm=grad_norm,
                         num_boxes=num_boxes)
        # one device-to-host copy for every stat
        out_stats = dict(zip(out_stats, torch.stack(
            [v.float() for v in out_stats.values()]).tolist()))
        ok = math.isfinite(out_stats["grad_norm"])
        if ok:
            with span("boxer.train.optimizer"):
                set_lr(state.optimizer, state.schedule, state.step)
                state.optimizer.step()
            state.step += 1
        out_stats["skipped"] = 0.0 if ok else 1.0
        if debug_grads:
            out_stats["_grads"] = raw_grads
        return state, out_stats

    return train_step


def _sum_over_ranks(tensors, group):
    """Sum every tensor over the ranks of `group` (None: every rank) in
    place, in one all_reduce of one flat buffer (the tensors share a dtype
    and a device)."""
    flat = distributed.all_reduce_sum(
        torch.cat([t.reshape(-1) for t in tensors]), group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def make_eval_step(compute_dtype: torch.dtype = torch.float32) -> Callable:
    """eval_step(state, batch) -> outputs: the model in val mode
    (inference=False: every decoder layer's outputs and the encoder
    head's). The JAX step's losses, which its engine drops, are not
    computed."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        state.model.eval()
        with _autocast(compute_dtype, batch["image" if "image" in batch
                                            else "voxels"].device):
            return apply_model(state.model, batch, train=False,
                               inference=False)

    return eval_step


def make_inference_step(compute_dtype: torch.dtype = torch.float32
                        ) -> Callable:
    """inference_step(state, batch) -> outputs (test-mode topology)."""

    @torch.no_grad()
    def inference_step(state: TrainState, batch):
        state.model.eval()
        with _autocast(compute_dtype, batch["image" if "image" in batch
                                            else "voxels"].device):
            return apply_model(state.model, batch, train=False,
                               inference=True)

    return inference_step
