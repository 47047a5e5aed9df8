"""The port's matcher, losses, box ops and optimizer against the JAX
package (and scipy for the assignment), on the CPU.

- `hungarian`: the valid rows' assignment equals scipy's
  `linear_sum_assignment` and the JAX solver's exactly, below and above
  the column-pruning threshold (NQ > 4*NT), with and without padded
  target rows: the same count in both problems, counts that differ (one
  of them 0), and valid rows scattered among the padding.
- `HungarianMatcher`: the cost matrix within rel 1e-5 and the same query
  indices; `Boxer2DCriterion`: every loss term within rel 1e-5 (f32 sums in
  another order), with aux layers, the encoder head's binary-label match
  (NEG_INF-masked logits and zero boxes, as the encoder head makes them)
  and the mask losses.
- The optimizer: the same gradients through optax (`build_optimizer`,
  `build_schedule` with warmup and a decay, `clip_by_global_norm`) and the
  port for 3 steps give every group's params within rel 1e-6.
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget)
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import jax
import jax.numpy as jnp

from test_torch_modules import _j, _rel_err, _t


def _scipy_col4row(cost):
    rows, cols = linear_sum_assignment(cost)
    out = np.empty(cost.shape[0], np.int64)
    out[rows] = cols
    return out


def _valid_rows(n_valid, n, rs):
    """(2, n) bool: a prefix of n_valid rows in both problems, a prefix of
    n_valid[b] rows in problem b, or rows scattered among the padding."""
    if n_valid == "interleaved":
        return np.stack([np.arange(n) % 2 == 1, rs.rand(n) < 0.3])
    counts = np.broadcast_to(n_valid, (2,))
    return np.arange(n)[None, :] < counts[:, None]


@pytest.mark.parametrize("n,m,n_valid", [
    (4, 10, 4), (10, 10, 10), (25, 60, 25), (20, 80, 13),     # full solve
    (10, 200, 10), (20, 2000, 20), (20, 20197, 7),            # pruned
    (20, 80, (3, 13)), (20, 2000, (3, 13)), (20, 80, (0, 5)),
    (20, 80, "interleaved"), (20, 2000, "interleaved")])
def test_hungarian_matches_scipy_and_jax(n, m, n_valid):
    from boxer_tpu.nn.matcher import hungarian as j_hungarian
    from boxer_tpu_torch.nn.matcher import hungarian

    rs = np.random.RandomState(n * m)
    cost = (rs.randn(2, n, m) * 10).astype(np.float32)
    valid = _valid_rows(n_valid, n, rs)
    got = hungarian(_t(cost), _t(valid)).numpy()
    want = np.asarray(j_hungarian(_j(cost), _j(valid)))
    # the port solves the valid rows only, the JAX package the padding
    # too: a padding row's column is arbitrary (masked by every caller)
    assert ((got >= 0) & (got < m)).all()
    for b in range(2):
        v = valid[b]
        np.testing.assert_array_equal(got[b, v], want[b, v])
        assert len(set(got[b, v].tolist())) == v.sum()        # distinct
        np.testing.assert_array_equal(got[b, v], _scipy_col4row(cost[b, v]))


def _outputs(rs, b, nq, ncls, masks=False, masked=None):
    logits = rs.randn(b, nq, ncls).astype(np.float32)
    boxes = np.concatenate([rs.uniform(0.2, 0.8, (b, nq, 2)),
                            rs.uniform(0.05, 0.4, (b, nq, 2))],
                           -1).astype(np.float32)
    if masked is not None:
        from boxer_tpu_torch.nn.predictor import NEG_INF

        logits[masked] = NEG_INF
        boxes[masked] = 0.0
    out = {"pred_logits": logits, "pred_boxes": boxes}
    if masks:
        out["pred_masks"] = rs.randn(b, nq, 28, 28).astype(np.float32)
    return out


def _targets(rs, b, nt, ncls, masks=False):
    valid = np.arange(nt)[None, :] < rs.randint(1, nt + 1, (b, 1))
    t = {"labels": rs.randint(0, ncls, (b, nt)).astype(np.int32),
         "boxes": np.concatenate([rs.uniform(0.2, 0.8, (b, nt, 2)),
                                  rs.uniform(0.05, 0.3, (b, nt, 2))],
                                 -1).astype(np.float32),
         "valid": valid}
    if masks:
        t["instance_masks"] = (rs.rand(b, nt, 28, 28) > 0.5).astype(
            np.float32)
    return t


def _tree(x, conv):
    if isinstance(x, dict):
        return {k: _tree(v, conv) for k, v in x.items()}
    if isinstance(x, list):
        return [_tree(v, conv) for v in x]
    return conv(x)


def test_matcher_matches_jax():
    from boxer_tpu.nn.matcher import HungarianMatcher as JMatcher
    from boxer_tpu_torch.nn.matcher import HungarianMatcher

    rs = np.random.RandomState(0)
    out = _outputs(rs, 3, 50, 9)
    tgt = _targets(rs, 3, 12, 9)
    jm, tm = JMatcher(2, 5, 2, focal_label=True), HungarianMatcher(2, 5, 2)
    assert _rel_err(tm.cost_matrix(_tree(out, _t), _tree(tgt, _t)),
                    jm.cost_matrix(_tree(out, _j), _tree(tgt, _j))) <= 1e-5
    got, _ = tm(_tree(out, _t), _tree(tgt, _t))
    want, _ = jm(_tree(out, _j), _tree(tgt, _j))
    valid = tgt["valid"]
    np.testing.assert_array_equal(got.numpy()[valid], np.asarray(want)[valid])


def test_criterion_matches_jax():
    from boxer_tpu.criterion.losses import Boxer2DCriterion as JCrit
    from boxer_tpu.criterion.losses import weighted_total as j_total
    from boxer_tpu.nn.matcher import HungarianMatcher as JMatcher
    from boxer_tpu_torch.criterion.losses import (Boxer2DCriterion,
                                                  weighted_total)
    from boxer_tpu_torch.nn.matcher import HungarianMatcher

    rs = np.random.RandomState(1)
    b, nq, ns, nt, ncls = 2, 30, 200, 8, 7
    out = _outputs(rs, b, nq, ncls, masks=True)
    out["aux_outputs"] = [_outputs(rs, b, nq, ncls, masks=True)
                          for _ in range(2)]
    out["enc_outputs"] = [_outputs(rs, b, ns, 1,
                                   masked=rs.rand(b, ns) < 0.3)]
    tgt = _targets(rs, b, nt, ncls, masks=True)
    wd = {"loss_ce": 2.0, "loss_bbox": 5.0, "loss_giou": 2.0,
          "loss_mask": 5.0, "loss_dice": 5.0}
    losses = ["boxes", "focal_labels", "masks"]
    jc = JCrit(ncls, JMatcher(2, 5, 2, focal_label=True), wd, losses)
    tc = Boxer2DCriterion(ncls, HungarianMatcher(2, 5, 2), wd, losses)
    num_boxes = float(tgt["valid"].sum())
    want = jc(_tree(out, _j), _tree(tgt, _j), num_boxes=num_boxes)
    got = tc(_tree(out, _t), _tree(tgt, _t), num_boxes=torch.tensor(num_boxes))

    assert sorted(got) == sorted(want)
    assert "loss_mask_1" in got and "loss_giou_enc_0" in got
    assert "loss_mask_enc_0" not in got
    valid = tgt["valid"]
    np.testing.assert_array_equal(got["_query_idx"].numpy()[valid],
                                  np.asarray(want["_query_idx"])[valid])
    for k in got:
        if not k.startswith("_"):
            assert _rel_err(got[k], want[k]) <= 1e-5, k
    weights = tc.expanded_weight_dict(num_aux=16, num_enc=2)
    assert weights == jc.expanded_weight_dict(num_aux=16, num_enc=2)
    t_tot, t_stats = weighted_total(got, weights)
    j_tot, j_stats = j_total(want, weights)
    assert sorted(t_stats) == sorted(j_stats)
    assert _rel_err(t_tot, j_tot) <= 1e-5


def test_box_ops_match_jax():
    from boxer_tpu.utils import box_ops as jb
    from boxer_tpu_torch.utils import box_ops as tb

    rs = np.random.RandomState(2)
    a = np.concatenate([rs.uniform(0, 1, (3, 5, 2)),
                        rs.uniform(0, 0.5, (3, 5, 2))], -1).astype(np.float32)
    c = np.concatenate([rs.uniform(0, 1, (3, 7, 2)),
                        rs.uniform(0, 0.5, (3, 7, 2))], -1).astype(np.float32)
    c[0, 0] = 0.0                                   # a degenerate box
    xa, xc = (jb.box_cxcywh_to_xyxy(_j(x)) for x in (a, c))
    ta, tc = (tb.box_cxcywh_to_xyxy(_t(x)) for x in (a, c))
    assert _rel_err(ta, xa) <= 1e-6
    assert _rel_err(tb.box_area(ta), jb.box_area(xa)) <= 1e-6
    for g, w in zip(tb.box_iou(ta, tc), jb.box_iou(xa, xc)):
        assert _rel_err(g, w) <= 1e-6
    assert _rel_err(tb.generalized_box_iou(ta, tc),
                    jb.generalized_box_iou(xa, xc)) <= 1e-6
    assert _rel_err(tb.elementwise_generalized_box_iou(ta, tc[:, :5]),
                    jb.elementwise_generalized_box_iou(xa, xc[:, :5])) <= 1e-6


def test_optimizer_matches_optax():
    import optax

    from boxer_tpu import optim as jo
    from boxer_tpu_torch import optim as to

    config = {"type": "adamw", "params": {
        "lr": 1e-2, "lr_backbone": 1e-3, "deform_lr_multi": 0.1,
        "weight_decay": 1e-2}}
    sched = {"type": "multi_step", "params": {
        "lr_steps": [2], "lr_ratio": 0.1, "use_warmup": True,
        "warmup_iterations": 1, "warmup_factor": 0.5}}
    rs = np.random.RandomState(3)
    shapes = {"backbone": {"conv": (4, 3)},
              "attn": {"linear_box": (6, 2), "value_proj": (5,)}}
    params = _tree(shapes, lambda s: rs.randn(*s).astype(np.float32))

    class Port(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for k, sub in params.items():
                mod = torch.nn.Module()
                for name, arr in sub.items():
                    mod.register_parameter(
                        name, torch.nn.Parameter(torch.from_numpy(arr.copy())))
                self.add_module(k, mod)

    model = Port()
    assert to.label_params(model) == {
        "backbone.conv": "backbone", "attn.linear_box": "deform",
        "attn.value_proj": "transformer"}
    schedule = to.build_schedule(sched, base_lr=1e-2)
    j_schedule = jo.build_schedule(sched, base_lr=1e-2)
    for step in range(5):
        assert abs(schedule(step) - float(j_schedule(step))) <= 1e-7, step
    opt = to.build_optimizer(config, model)
    tx, _ = jo.build_optimizer(config, _tree(params, jnp.asarray), j_schedule)
    j_params = _tree(params, jnp.asarray)
    j_state = tx.init(j_params)

    for step in range(3):
        grads = _tree(shapes, lambda s: rs.randn(*s).astype(np.float32))
        g, j_norm = jo.clip_by_global_norm(_tree(grads, jnp.asarray), 0.1)
        updates, j_state = tx.update(g, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for k, sub in grads.items():
            for name, arr in sub.items():
                getattr(getattr(model, k), name).grad = torch.from_numpy(arr)
        norm = to.clip_by_global_norm([p.grad for p in model.parameters()],
                                      0.1)
        assert _rel_err(norm, j_norm) <= 1e-6
        to.set_lr(opt, schedule, step)
        opt.step()
        for k, sub in j_params.items():
            for name, arr in sub.items():
                got = getattr(getattr(model, k), name).detach()
                assert _rel_err(got, arr) <= 1e-6, (step, k, name)
