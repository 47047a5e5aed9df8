"""The training slice: the port's sampling Functions, K3's backward and the
whole train step against the JAX package, on the CPU.

- `QuadSample` (box and instance attention): grads of value, gx, gy and the
  attention weights against `jax.grad` of the JAX ops in train mode (rel
  err <= 1e-4; f32 sums in another order).
- The folded differentiable path (`TakeRows`, K7b's plain version in the
  backward): `box_attention` at its default fold with P=16, and
  `box_attention_qminor(fold=None)` at P=4 with both packages' fold
  thresholds set below 4, output and grads against `jax.grad` (rel 1e-4);
  and the graph of `box_attention`'s output holds the port's autograd
  Function (`QuadSample` at P <= 8, `TakeRows` above), so the CPU runs the
  card's backward.
- K3's Function backward against autograd of `flash_attention_plain`.
- The whole step: a tiny r10 model (hidden 64 in 2 heads of 32, 1 encoder
  and 2 decoder layers, 16 queries) on a 64x96 canvas, f32, weights from a
  numpy seed, through `make_train_step(..., debug_grads=True)` on both
  sides; segm and detection per tap, and detection folded (both fold
  thresholds below the 4 taps of a box-attention level). Every loss term within rel 1e-4 and the pre-clip grads within a
  worst-leaf rel err (max abs diff over the leaf's max abs) of 2e-3, the
  JAX package's own starting tolerance against the reference. Hidden 64
  gives each of the 32 GroupNorm groups two channels: with one, the input
  projections' conv biases have an exactly zero gradient, and both sides
  hold only rounding noise there.
- Port only: microbatch accumulation under the shared num_boxes, and the
  NaN skip.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_boxer2d import TINY as _TINY
from test_torch_modules import SHAPES, _j, _rel_err, _t, random_variables

from boxer_tpu_torch.utils.weights import jax_to_torch_state, load_jax_params

H, W = 64, 96
TINY = dict(_TINY, hidden_dim=64, nhead=2)
WEIGHTS = {"loss_ce": 2.0, "loss_bbox": 5.0, "loss_giou": 2.0}
MASK_WEIGHTS = {"loss_mask": 5.0, "loss_dice": 5.0}
OPTIM = {"type": "adamw", "params": {"lr": 2e-4, "lr_backbone": 2e-5,
                                     "weight_decay": 1e-4}}
SCHEDULE = {"type": "multi_step",
            "params": {"lr_steps": [10 ** 9], "lr_ratio": 0.1,
                       "use_warmup": False}}


def _sampling_inputs(seed, npt, lq=30, nh=2, ch=32):
    rs = np.random.RandomState(seed)
    s = sum(h * w for h, w in SHAPES)
    nl = len(SHAPES)
    value = rs.randn(1, s, nh, ch).astype(np.float32)
    # on, inside and past the level borders
    grid = rs.uniform(-0.1, 1.1, (2, 1, nh, nl, npt, lq)).astype(np.float32)
    w = rs.rand(2, 1, nh, nl, npt, lq).astype(np.float32)
    cot = rs.randn(1, nh, lq, ch).astype(np.float32)
    return value, grid[0], grid[1], w[0], w[1], cot


def _torch_grads(fn, *arrays):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    fn(*ts).backward()
    return [t.grad.numpy() for t in ts]


def test_box_sampling_grads_match_jax():
    jb = importlib.import_module("boxer_tpu.ops.box_attention")
    from boxer_tpu_torch.ops.box_attention import box_attention_qminor

    value, gx, gy, aw, _, cot = _sampling_inputs(0, npt=4)

    def j_loss(v, x, y, a):
        out = jb.box_attention_qminor(v, SHAPES, x, y, a, raw=True)
        return (out * cot).sum()

    want = jax.grad(j_loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (value, gx, gy, aw)))
    got = _torch_grads(lambda v, x, y, a: (box_attention_qminor(
        v, SHAPES, x, y, a, raw=True, fold=False) * _t(cot)).sum(),
        value, gx, gy, aw)
    for name, g, wa in zip(("value", "gx", "gy", "attn_weight"), got, want):
        assert _rel_err(g, wa) <= 1e-4, name


def _graph_functions(t):
    """Names of the autograd nodes behind tensor t."""
    seen, stack = set(), [t.grad_fn]
    while stack:
        node = stack.pop()
        if node is not None and node not in seen:
            seen.add(node)
            stack.extend(n for n, _ in node.next_functions)
    return {type(n).__name__ for n in seen}


def test_box_attention_p16_folded_grads_match_jax():
    """The reference-contract op at its default fold: P=16 folds on both
    sides (`_take_rows_vjp` in JAX, `TakeRows` in the port)."""
    jb = importlib.import_module("boxer_tpu.ops.box_attention")
    from boxer_tpu_torch.ops.box_attention import box_attention

    rs = np.random.RandomState(4)
    nh, ch, lq, p = 2, 32, 30, 16
    value = rs.randn(1, sum(h * w for h, w in SHAPES), nh, ch).astype(
        np.float32)
    loc = rs.uniform(-0.1, 1.1, (1, lq, nh, len(SHAPES), p, 2)).astype(
        np.float32)
    weight = rs.rand(1, lq, nh, len(SHAPES), p).astype(np.float32)
    cot = rs.randn(1, lq, nh * ch).astype(np.float32)

    def j_loss(v, loc_, w):
        return (jb.box_attention(v, SHAPES, loc_, w) * cot).sum()

    want_out = jb.box_attention(_j(value), SHAPES, _j(loc), _j(weight))
    want = jax.grad(j_loss, argnums=(0, 1, 2))(_j(value), _j(loc),
                                                _j(weight))
    ts = [torch.from_numpy(a).requires_grad_() for a in (value, loc, weight)]
    out = box_attention(ts[0], SHAPES, ts[1], ts[2])
    assert "TakeRowsBackward" in _graph_functions(out)
    assert _rel_err(out.detach().numpy(), want_out) <= 1e-4
    (out * _t(cot)).sum().backward()
    for name, t, wa in zip(("value", "loc", "weight"), ts, want):
        assert _rel_err(t.grad.numpy(), wa) <= 1e-4, name


def test_box_sampling_folded_above_threshold_matches_jax(monkeypatch):
    """fold=None folds the P=4 taps once both thresholds are below 4."""
    jb = importlib.import_module("boxer_tpu.ops.box_attention")
    tb = importlib.import_module("boxer_tpu_torch.ops.box_attention")

    monkeypatch.setattr(jb, "_FOLD_TAP_THRESHOLD", 3)
    monkeypatch.setattr(tb, "FOLD_TAP_THRESHOLD", 3)
    value, gx, gy, aw, _, cot = _sampling_inputs(5, npt=4)

    def j_loss(v, x, y, a):
        out = jb.box_attention_qminor(v, SHAPES, x, y, a, raw=True)
        return (out * cot).sum()

    want = jax.grad(j_loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (value, gx, gy, aw)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (value, gx, gy, aw)]
    out = tb.box_attention_qminor(*ts[:1], SHAPES, *ts[1:], raw=True)
    assert "TakeRowsBackward" in _graph_functions(out)
    (out * _t(cot)).sum().backward()
    for name, t, wa in zip(("value", "gx", "gy", "attn_weight"), ts, want):
        assert _rel_err(t.grad.numpy(), wa) <= 1e-4, name


@pytest.mark.parametrize("p,function", [(4, "QuadSampleBackward"),
                                        (16, "TakeRowsBackward")])
def test_box_attention_output_holds_the_autograd_function(p, function):
    """The reference-contract op is differentiable through the port's own
    Function (the card's backward), not through the plain version's ops."""
    from boxer_tpu_torch.ops.box_attention import box_attention

    rs = np.random.RandomState(p)
    value = torch.from_numpy(rs.randn(1, sum(h * w for h, w in SHAPES), 1,
                                      32).astype(np.float32))
    loc = torch.from_numpy(rs.rand(1, 5, 1, len(SHAPES), p, 2).astype(
        np.float32))
    weight = torch.from_numpy(rs.rand(1, 5, 1, len(SHAPES), p).astype(
        np.float32))
    out = box_attention(value.requires_grad_(), SHAPES, loc, weight)
    functions = _graph_functions(out)
    assert function in functions
    assert not {"QuadSampleBackward", "TakeRowsBackward"} - {function} \
        & functions


def test_instance_sampling_grads_match_jax():
    jb = importlib.import_module("boxer_tpu.ops.box_attention")
    from boxer_tpu_torch.ops.box_attention import instance_attention_qminor

    k = 4
    value, gx, gy, sw, lw, cot = _sampling_inputs(1, npt=k * k)
    cot_mask = np.random.RandomState(2).randn(
        1, gx.shape[-1], k, k, value.shape[2] * value.shape[3]
    ).astype(np.float32)

    def j_loss(v, x, y, s, lv):
        out, mask = jb.instance_attention_qminor(v, SHAPES, x, y, s, lv, k,
                                                 raw=True)
        return (out * cot).sum() + (mask * cot_mask).sum()

    want = jax.grad(j_loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (value, gx, gy, sw, lw)))

    def t_loss(v, x, y, s, lv):
        out, mask = instance_attention_qminor(v, SHAPES, x, y, s, lv, k,
                                              raw=True)
        return (out * _t(cot)).sum() + (mask * _t(cot_mask)).sum()

    got = _torch_grads(t_loss, value, gx, gy, sw, lw)
    for name, g, wa in zip(("value", "gx", "gy", "spatial", "level"), got,
                           want):
        assert _rel_err(g, wa) <= 1e-4, name


def test_flash_attention_backward_matches_plain_autograd():
    from boxer_tpu_torch.ops.flash_attention import (NEG_INF, attention,
                                                     flash_attention_plain)

    rs = np.random.RandomState(3)
    q, k, v = (rs.randn(4, n, 32).astype(np.float32) * 0.5
               for n in (30, 25, 25))
    mask = np.where(rs.rand(4, 25) < 0.2, NEG_INF, 0.0).astype(np.float32)
    cot = rs.randn(4, 30, 32).astype(np.float32)
    got = _torch_grads(lambda *a: (attention(*a, _t(mask)) * _t(cot)).sum(),
                       q, k, v)
    want = _torch_grads(lambda *a: (flash_attention_plain(*a, _t(mask))
                                    * _t(cot)).sum(), q, k, v)
    for g, wa in zip(got, want):
        assert _rel_err(g, wa) <= 1e-6


def _batch(use_mask, batch_size=1, iter_per_update=1, seed=0):
    from boxer_tpu_torch.dataset.synthetic import synthetic_batch

    return synthetic_batch(batch_size, H, W, num_targets=6,
                           num_classes=TINY["num_classes"],
                           with_masks=use_mask, seed=seed,
                           iter_per_update=iter_per_update)


def _to_torch(batch):
    return {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else torch.from_numpy(v))
            for k, v in batch.items()}


def _port_setup(use_mask, variables=None, seed=0, debug_grads=True):
    from boxer_tpu_torch.criterion.losses import Boxer2DCriterion
    from boxer_tpu_torch.models.boxer2d import BoxeR2D
    from boxer_tpu_torch.nn.matcher import HungarianMatcher
    from boxer_tpu_torch.optim import build_optimizer, build_schedule
    from boxer_tpu_torch.parallel.steps import TrainState, make_train_step

    model = BoxeR2D(**TINY, use_mask=use_mask)
    if variables is None:
        model.init_weights(seed)
    else:
        unused, unfilled = load_jax_params(model, variables)
        assert unused == [] and unfilled == []
    wd = dict(WEIGHTS, **(MASK_WEIGHTS if use_mask else {}))
    losses = ["boxes", "focal_labels"] + (["masks"] if use_mask else [])
    criterion = Boxer2DCriterion(TINY["num_classes"],
                                 HungarianMatcher(2, 5, 2, focal_label=True),
                                 wd, losses)
    state = TrainState(model, build_optimizer(OPTIM, model),
                       build_schedule(SCHEDULE, base_lr=2e-4))
    return state, make_train_step(criterion, max_norm=0.1,
                                  debug_grads=debug_grads)


def _train_step_matches_jax(use_mask):
    from boxer_tpu.criterion.losses import Boxer2DCriterion as JCrit
    from boxer_tpu.models.boxer2d import BoxeR2D as JaxBoxeR2D
    from boxer_tpu.nn.matcher import HungarianMatcher as JMatcher
    from boxer_tpu.optim import build_optimizer, build_schedule
    from boxer_tpu.parallel.steps import create_train_state, make_train_step

    batch = _batch(use_mask)
    jm = JaxBoxeR2D(**TINY, use_mask=use_mask)
    v = random_variables(jm, 0, jnp.asarray(batch["image"][0]),
                         jnp.asarray(batch["mask"][0]), train=False)
    wd = dict(WEIGHTS, **(MASK_WEIGHTS if use_mask else {}))
    losses = ["boxes", "focal_labels"] + (["masks"] if use_mask else [])
    crit = JCrit(TINY["num_classes"], JMatcher(2, 5, 2, focal_label=True),
                 wd, losses)
    tx, _ = build_optimizer(OPTIM, v["params"],
                            build_schedule(SCHEDULE, base_lr=2e-4))
    jstate = create_train_state(v["params"], v["constants"], tx)
    jstep = jax.jit(make_train_step(jm, crit, tx, max_norm=0.1,
                                    debug_grads=True))
    _, want = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch),
                    jax.random.PRNGKey(0))

    state, step = _port_setup(use_mask, v)
    _, got = step(state, _to_torch(batch))

    loss_keys = [k for k in want if k.startswith("loss_")]
    assert sorted(loss_keys) == sorted(k for k in got
                                       if k.startswith("loss_"))
    for k in loss_keys + ["total_loss", "grad_norm", "num_boxes"]:
        assert _rel_err(got[k], want[k]) <= 1e-4, k
    assert state.step == 1 and got["skipped"] == 0.0

    j_grads, _ = jax_to_torch_state({"params": want["_grads"]})
    assert sorted(j_grads) == sorted(got["_grads"])
    worst = max(_rel_err(got["_grads"][n].numpy(), j_grads[n])
                for n in j_grads)
    assert worst <= 2e-3, worst


@pytest.mark.parametrize("use_mask", [True, False], ids=["segm", "det"])
def test_train_step_matches_jax(use_mask):
    _train_step_matches_jax(use_mask)


def test_folded_train_step_matches_jax(monkeypatch):
    """Detection with every box-attention level folded on both sides: the
    port's backward scatters through K7b's plain version at each of the 4
    levels of the 1 encoder and 2 decoder layers."""
    tb = importlib.import_module("boxer_tpu_torch.ops.box_attention")

    monkeypatch.setattr(importlib.import_module("boxer_tpu.ops.box_attention"),
                        "_FOLD_TAP_THRESHOLD", 3)
    monkeypatch.setattr(tb, "FOLD_TAP_THRESHOLD", 3)
    scatters = []
    scatter = tb.scatter_add_rows_pmajor
    monkeypatch.setattr(tb, "scatter_add_rows_pmajor",
                        lambda *a: scatters.append(1) or scatter(*a))
    _train_step_matches_jax(use_mask=False)
    assert len(scatters) == 4 * (TINY["enc_layers"] + TINY["dec_layers"])


def _worst_leaf(a, b):
    return max(_rel_err(a[n].numpy(), b[n].numpy()) for n in a)


def test_microbatches_share_num_boxes():
    """Two microbatches of one image give the gradients of one batch of
    two: both are normalised by the update's global target count."""
    batch = _batch(True, batch_size=2, seed=1)
    split = _batch(True, batch_size=2, iter_per_update=2, seed=1)
    state, step = _port_setup(True, seed=2)
    _, whole = step(state, _to_torch(batch))
    state, step = _port_setup(True, seed=2)
    _, micro = step(state, _to_torch(split))
    assert micro["num_boxes"] == whole["num_boxes"] == float(
        batch["targets"]["valid"].sum())
    for k in ("total_loss", "loss_ce", "loss_mask_0", "loss_giou_enc_0"):
        assert _rel_err(micro[k], whole[k]) <= 1e-5, k
    assert _worst_leaf(micro["_grads"], whole["_grads"]) <= 1e-4


def test_nan_skip_leaves_state_unchanged():
    batch = _to_torch(_batch(False))
    batch["image"][0, 0, 0, 0, 0] = float("nan")
    state, step = _port_setup(False, seed=3, debug_grads=False)
    params = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    state, stats = step(state, batch)
    assert stats["skipped"] == 1.0 and state.step == 0
    assert state.optimizer.state_dict()["state"] == {}
    for n, p in state.model.named_parameters():
        assert torch.equal(p, params[n]), n
