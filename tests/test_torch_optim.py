"""The port's schedules, SGD and training metrics against the JAX package.

- Schedules: the cases of `tests/test_optim.py` (multi-step on both
  clocks with warmup, step on both clocks, cosine with eta_min and warmup,
  and the shipped configs' own schedules) hold the port's factor against
  `boxer_tpu.optim`'s at every step of their range: abs 1e-7, and for the
  cosine two f32 ulps at 1 (2.4e-7). The JAX package computes the cosine
  in f32, 1.2-1.3e-7 from its exact value here, and the port in f64; an f32
  emulation in numpy or torch differs from XLA's f32 cos by the same.
- SGD: 3 steps with momentum, with and without nesterov, at a scheduled
  LR, over three labelled groups (backbone, transformer, deform) against
  `boxer_tpu.optim.build_optimizer(type="sgd")` on the same numpy-seeded
  params and grads (rel 1e-6); and torch's SGD gets no weight decay.
- Metrics: `accuracy` (top-1, top-5) and `cardinality` against
  `boxer_tpu.criterion.metrics` on seeded logits and matchings (rel 1e-6:
  XLA's f32 mean of three image counts rounds 50/3 one ulp above torch's),
  and the train step sums them over microbatches.
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

SCHEDULES = {
    "multi_step_iter": ({"type": "multi_step", "params": {
        "lr_steps": [100, 200], "lr_ratio": 0.1, "use_warmup": True,
        "warmup_iterations": 10, "warmup_factor": 0.001}}, 300),
    "multi_step_epoch": ({"type": "multi_step", "params": {
        "lr_steps": [2, 4], "lr_ratio": 0.1, "mode": "epoch",
        "_steps_per_epoch": 50, "use_warmup": True, "warmup_iterations": 10,
        "warmup_factor": 0.001}}, 300),
    "step_epoch": ({"type": "step", "params": {
        "step_size": 3, "lr_ratio": 0.1, "mode": "epoch",
        "_steps_per_epoch": 10}}, 100),
    "step_iter": ({"type": "step", "params": {
        "step_size": 100, "lr_ratio": 0.5, "use_warmup": False}}, 400),
    "step_warmup": ({"type": "step", "params": {
        "step_size": 40, "lr_ratio": 0.1, "use_warmup": True,
        "warmup_iterations": 25, "warmup_factor": 0.01}}, 200),
    "cosine": ({"type": "cosine_annealing", "params": {
        "T_max": 1000, "eta_min": 1e-5, "use_warmup": True,
        "warmup_iterations": 100, "warmup_factor": 0.001}}, 1100),
    "cosine_no_warmup": ({"type": "cosine_annealing", "params": {
        "T_max": 500, "eta_min": 0.0}}, 500),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax(name):
    from boxer_tpu.optim import build_schedule as jax_schedule
    from boxer_tpu_torch.optim import build_schedule

    config, n = SCHEDULES[name]
    want = jax.jit(jax.vmap(jax_schedule(config, base_lr=1e-3)))(
        jnp.arange(n + 1))
    got = build_schedule(config, base_lr=1e-3)
    diff = max(abs(got(s) - float(want[s])) for s in range(n + 1))
    tol = (2 * float(np.spacing(np.float32(1))) if name.startswith("cosine")
           else 1e-7)
    assert diff <= tol, diff


@pytest.mark.parametrize("path", [
    "COCO-InstanceSegmentation/boxer2d_r50_50eps.yaml",
    "COCO-Detection/boxer2d_r50_50epochs.yaml",
    "COCO-Detection/boxer2d_r50_3x.yaml",
    "base_boxer3d_detection.yaml",
])
def test_shipped_schedule_and_optimizer_build(path):
    """Every shipped BoxeR config's scheduler and optimizer build in the
    port and give JAX's schedule on a 100-update epoch clock."""
    from boxer_tpu.optim import build_schedule as jax_schedule
    from boxer_tpu_torch.models.boxer2d import BoxeR2D
    from boxer_tpu_torch.optim import build_optimizer, build_schedule
    from boxer_tpu_torch.utils.config import Configuration, _config_root

    cfg = Configuration(f"{_config_root()}/{path}", device="cpu").get_config()
    sched = cfg.scheduler.to_dict()
    sched["params"]["_steps_per_epoch"] = 100
    base_lr = cfg.optimizer.params.lr
    got = build_schedule(sched, base_lr)
    want = jax_schedule(sched, base_lr)
    steps = [0, 1, 99, 100, 500, 4000, 5000, 10 ** 5, 3 * 10 ** 5]
    tol = (2 * float(np.spacing(np.float32(1)))
           if sched["type"] == "cosine_annealing" else 1e-7)
    assert max(abs(got(s) - float(want(s))) for s in steps) <= tol
    tiny = BoxeR2D(num_classes=3, hidden_dim=32, nhead=4, enc_layers=1,
                   dec_layers=1, dim_feedforward=32, num_queries=8,
                   backbone_arch="resnet10")
    opt = build_optimizer(cfg.optimizer.to_dict(), tiny)
    assert [g["name"] for g in opt.param_groups] == [
        "backbone", "transformer", "deform"]


def _sgd_problem(seed=0):
    """Seeded params of the three labels and 3 steps of grads."""
    rs = np.random.RandomState(seed)
    shapes = {"backbone.conv": (4, 3), "transformer.value_proj": (5,),
              "transformer.linear_box": (3, 2)}
    params = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    return params, grads


class _Named(torch.nn.Module):
    """A module whose parameter names carry the labels' keywords."""

    def __init__(self, params):
        super().__init__()
        self.backbone_conv = torch.nn.Parameter(
            torch.from_numpy(params["backbone.conv"].copy()))
        self.value_proj = torch.nn.Parameter(
            torch.from_numpy(params["transformer.value_proj"].copy()))
        self.linear_box = torch.nn.Parameter(
            torch.from_numpy(params["transformer.linear_box"].copy()))

    def tensors(self):
        return {"backbone.conv": self.backbone_conv,
                "transformer.value_proj": self.value_proj,
                "transformer.linear_box": self.linear_box}


@pytest.mark.parametrize("nesterov", [False, True], ids=["momentum",
                                                         "nesterov"])
def test_sgd_matches_optax(nesterov):
    from boxer_tpu.optim import build_optimizer as jax_optimizer
    from boxer_tpu.optim import build_schedule as jax_schedule
    from boxer_tpu_torch.optim import build_optimizer, build_schedule, set_lr

    config = {"type": "sgd", "params": {
        "lr": 0.1, "lr_backbone": 0.01, "momentum": 0.8,
        "nesterov": nesterov, "deform_lr_multi": 0.5,
        "weight_decay": 1e-2}}
    sched_cfg = {"type": "step", "params": {"step_size": 1, "lr_ratio": 0.5}}
    params, grads = _sgd_problem()

    tree = {"backbone": {"conv": params["backbone.conv"]},
            "transformer": {"value_proj": params["transformer.value_proj"],
                            "linear_box": params["transformer.linear_box"]}}
    tree = jax.tree_util.tree_map(jnp.asarray, tree)
    tx, _ = jax_optimizer(config, tree, jax_schedule(sched_cfg, 0.1))
    opt_state = tx.init(tree)
    for g in grads:
        gt = {"backbone": {"conv": g["backbone.conv"]},
              "transformer": {"value_proj": g["transformer.value_proj"],
                              "linear_box": g["transformer.linear_box"]}}
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray,
                                                              gt),
                                       opt_state, tree)
        tree = optax.apply_updates(tree, updates)
    want = {"backbone.conv": tree["backbone"]["conv"],
            "transformer.value_proj": tree["transformer"]["value_proj"],
            "transformer.linear_box": tree["transformer"]["linear_box"]}

    model = _Named(params)
    opt = build_optimizer(config, model)
    assert isinstance(opt, torch.optim.SGD)
    assert all(g["weight_decay"] == 0 and g["dampening"] == 0
               for g in opt.param_groups)
    assert [len(g["params"]) for g in opt.param_groups] == [1, 1, 1]
    schedule = build_schedule(sched_cfg, 0.1)
    for step, g in enumerate(grads):
        for k, t in model.tensors().items():
            t.grad = torch.from_numpy(g[k])
        set_lr(opt, schedule, step)
        opt.step()
    for k, t in model.tensors().items():
        w = np.asarray(want[k])
        err = np.abs(t.detach().numpy() - w).max() / np.abs(w).max()
        assert err <= 1e-6, (k, err)


def _metric_inputs(seed):
    rs = np.random.RandomState(seed)
    b, nq, nt, c = 3, 20, 6, 9
    logits = rs.randn(b, nq, c).astype(np.float32)
    logits[0, 3, :] = -np.inf                 # a masked query
    logits[1, :4, :2] = 1.5                   # ties across classes
    labels = rs.randint(0, c, (b, nt)).astype(np.int32)
    qi = np.stack([rs.permutation(nq)[:nt] for _ in range(b)])
    valid = rs.rand(b, nt) < 0.7
    valid[2] = False                          # an image without targets
    return logits, labels, qi, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_match_jax(seed):
    from boxer_tpu.criterion import metrics as jm
    from boxer_tpu_torch.criterion import metrics as tm

    logits, labels, qi, valid = _metric_inputs(seed)
    j_args = ({"pred_logits": jnp.asarray(logits)},
              {"labels": jnp.asarray(labels)}, jnp.asarray(qi),
              jnp.asarray(valid))
    t_args = ({"pred_logits": torch.from_numpy(logits)},
              {"labels": torch.from_numpy(labels)},
              torch.from_numpy(qi).long(), torch.from_numpy(valid))
    def close(got, want):
        return abs(float(got) - float(want)) <= 1e-6 * max(1.0, abs(
            float(want)))

    for topk in (1, 5):
        assert close(tm.accuracy(*t_args, topk=topk),
                     jm.accuracy(*j_args, topk=topk)), topk
    assert close(tm.cardinality(*t_args), jm.cardinality(*j_args))
    built = tm.build_metrics([{"type": "accuracy", "params": {}},
                              {"type": "cardinality"}])
    losses = {"_query_idx": t_args[2], "_valid": t_args[3]}
    out = tm.compute_metrics(built, *t_args[:2], losses)
    assert sorted(out) == ["accuracy", "cardinality"]


def test_train_step_sums_metrics_over_microbatches():
    """The step's `accuracy` is the sum of its microbatches' values, as
    JAX's scan sums its stats."""
    from test_torch_train import (MASK_WEIGHTS, TINY, WEIGHTS, _batch,
                                  _port_setup, _to_torch)

    from boxer_tpu_torch.criterion.losses import Boxer2DCriterion
    from boxer_tpu_torch.criterion.metrics import accuracy
    from boxer_tpu_torch.nn.matcher import HungarianMatcher
    from boxer_tpu_torch.parallel.steps import make_train_step

    seen = []
    criterion = Boxer2DCriterion(TINY["num_classes"],
                                 HungarianMatcher(2, 5, 2, focal_label=True),
                                 dict(WEIGHTS, **MASK_WEIGHTS),
                                 ["boxes", "focal_labels", "masks"])
    step = make_train_step(criterion, max_norm=0.1, metrics={
        "accuracy": lambda *a: seen.append(accuracy(*a)) or seen[-1]})
    state, _ = _port_setup(True, seed=2)
    _, stats = step(state, _to_torch(_batch(True, batch_size=2,
                                            iter_per_update=2, seed=1)))
    assert len(seen) == 2
    assert abs(stats["accuracy"] - float(seen[0] + seen[1])) <= 1e-5
