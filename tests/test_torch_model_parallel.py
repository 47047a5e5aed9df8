"""Tensor (mp) and sequence (sp) parallelism of the port on the CPU: the
ranks of a layout are processes joined over gloo by `boxer_tpu_torch.
parallel.distributed.launch` (a hard timeout each), running this module's
`_*_ranks` functions, which import neither JAX nor the JAX package; the
JAX side runs in the test's process (imported inside the tests).

- One update of the tiny BoxeR-2D (`test_torch_parallel`'s tiny r10
  config: hidden 64 in 4 heads, 1 encoder and 2 decoder layers, FFN 64,
  SGD at LR 10, a global batch of 2) at mp2, sp2, sp2 x mp2, dp2 x sp2 x
  mp2 (8 ranks) and sp3 (340 tokens, not a multiple of 3: the pad path)
  against the JAX package's one unsharded update of the same weights and
  batch, by `test_torch_parallel._held_against_jax` (stats rel 1e-4, the
  updated parameters' worst leaf 2e-3, the port's single-process update
  within 1e-3 and its stats 1e-5), and the raw gradients by name: against
  JAX's, worst leaf 2e-3 (`test_torch_train`'s tolerance); against the
  port's world-1 update, at most 1e-5 of the largest gradient (f32 sums in
  another order; about 1e-6 seen). Every rank's whole parameters
  (`gather_state`) are bitwise equal; each rank's coordinate and groups
  follow JAX's `reshape(dp, sp, mp)`.
- The same for the segm model at sp2 x mp2 (instance attention, K6's
  plain version), BoxeR-3D at mp2 (the Waymo config; its gradient norm and
  parameters at 2e-3, as `test_world2_update_3d_matches_jax`) and DETR at
  mp2 (no padding mask: JAX's DETR turns its mask round).
- Dropout 0.1 at sp2 x mp2: one update equal to the port's world-1 update
  under the same key (stats 1e-5, gradients 1e-4 of the largest, see the
  test). The world-1 references run in a process of their own, launched
  as the ranks are.
- The trainer at sp2 x mp2: a checkpoint at update 2 resumed at world 1
  (model and optimizer state bitwise), a world-1 checkpoint resumed at sp2
  x mp2 (each rank's gathered state bitwise), val and test results hold
  every image once; a dp2 x mp2 checkpoint with ZeRO-1 resumed at world
  1; BoxeR-3D with the GT-database sampler at mp2: its checkpoint (one
  draws' entry a data shard) resumed at mp2 and at world 1; a sp2
  trainer trains one update (the JAX package's
  `test_trainer_sp2_loads_and_trains`).
- The port's TP rule against JAX's `param_spec` at mp 2 on the same tiny
  BoxeR-2D, BoxeR-3D and DETR: the same weights, through the weight map's
  names, besides the listed exceptions.
- The collectives raise without a group; `shard_state` and the parts'
  reassembly round-trip.
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget)
import json
import os
import shutil

import numpy as np
import pytest
import torch

from test_torch_parallel import (JAX_2D_OPTS, REPO, WAYMO_CONFIG,
                                 _draws_equal, _held_against_jax,
                                 _jax_update, _launch, _run_ranks_beside,
                                 _share, _state_equal, _tiny, _to_torch,
                                 _trainer)

LAYOUTS = {"mp2": (1, 1, 2), "sp2": (1, 2, 1), "sp2mp2": (1, 2, 2),
           "dp2sp2mp2": (2, 2, 2), "sp3": (1, 3, 1)}
OPTS_2D = JAX_2D_OPTS + ["model_config.boxer2d.transformer.params.nhead=4",
                         "training.batch_size=2"]
# JAX_2D_OPTS for DETR; `_jax_update` reads a model's deform_lr_multi,
# which DETR's config lacks (it has no deform group)
DETR_OPTS = [o for o in JAX_2D_OPTS if "boxer2d" not in o] + [
    "model_config.detr.deform_lr_multi=0.1", "training.batch_size=2"]


def _layout_opts(dp, sp, mp):
    return [f"distributed.dp={dp}", f"distributed.sp={sp}",
            f"distributed.mp={mp}"]


# ---------------------------------------------------------------------------
# what the ranks run (no JAX here: the ranks import this module)

def _update(task, opts):
    """A trainer from the task's config and `opts` (its layout: this
    process's group, or a world of one) takes one debug update from the
    task's whole weights on its data shard of the task's batch. Returns
    the update's stats, its raw gradients and parameters (whole), the
    layout and the collectives' counts."""
    import torch.distributed as dist

    from boxer_tpu_torch.criterion.metrics import build_metrics
    from boxer_tpu_torch.parallel import collectives
    from boxer_tpu_torch.parallel.sharding import gather_state, shard_state
    from boxer_tpu_torch.parallel.steps import make_train_step

    trainer = _trainer(task["config"], opts, task["task"], task["model"])
    lay = trainer.layout
    model = trainer.state.model
    model.load_state_dict(shard_state(task["weights"], lay))
    rc = trainer.running_config
    step = make_train_step(
        trainer.criterion, max_norm=float(rc.get("max_norm", 0) or 0),
        compute_dtype=trainer.compute_dtype,
        metrics=build_metrics(trainer.config.model_config[task["model"]].get(
            "metric")),
        debug_grads=True, dropout_seed=trainer.seed + 7, layout=lay)
    batch = _to_torch(_share(task["batch"], lay.dp.index, lay.dp.size))
    collectives.reset_counts()
    _, stats = step(trainer.state, batch)
    grads = stats.pop("_grads")
    groups = {}
    if dist.is_initialized():
        for axis in ("dp", "sp", "mp", "grad"):
            g = getattr(lay, axis).group
            groups[axis] = (None if g is None
                            else dist.get_process_group_ranks(g))
    return dict(
        stats=[stats], grads=grads, step=trainer.state.step,
        params=gather_state({n: p.detach() for n, p in
                             model.named_parameters()}, lay),
        lrs={g["name"]: g["lr"] for g in trainer.state.optimizer.param_groups},
        coord=(lay.dp.index, lay.sp.index, lay.mp.index), groups=groups,
        counts={k: tuple(v) for k, v in collectives.COUNTS.items()})


def _update_ranks(task_path, opts, out_dir):
    import torch.distributed as dist

    task = torch.load(task_path, weights_only=False)
    torch.save(_update(task, opts),
               os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))


def _trainer_ranks(cfg_path, opts, root):
    """The tiny segm trainer at the layout of `opts`: one update at
    dropout 0.1 from the task's weights and batch; 2 updates with a
    checkpoint, val and test; a world-1 checkpoint resumed. What the test
    checks to <root>/rank<r>.pt."""
    import torch.distributed as dist

    from boxer_tpu_torch.parallel.sharding import (gather_state,
                                                   optimizer_state_dict,
                                                   param_names)

    task = torch.load(root / "task.pt", weights_only=False)
    out = {"dropout": _update(task, task["opts"] + opts)}

    def whole(trainer):
        st = trainer.state
        return (gather_state(st.model.state_dict(), trainer.layout),
                optimizer_state_dict(st.optimizer, trainer.layout,
                                     param_names(st.model, st.optimizer)))

    run = _trainer(cfg_path, opts + [
        "training.max_update=2", "training.checkpoint_interval=2",
        f"training.save_dir={root}/sharded"])
    run.train()
    out["val"] = {k: v.tolist() for k, v in run.evaluate("val").items()}
    out["trained"] = whole(run)
    resumed = _trainer(cfg_path, opts + [
        "training.max_update=3", "training.run_type=train",
        "training.resume=true", f"training.save_dir={root}/from_one"])
    out["restored"] = (resumed.state.step,) + whole(resumed)
    torch.save(out, root / f"rank{dist.get_rank()}.pt")


def _zero1_ranks(cfg_path, root):
    """The tiny segm trainer at dp2 x mp2 (ZeRO-1 over dp): 2 updates with
    a checkpoint; each rank's type of optimizer and gathered state."""
    import torch.distributed as dist

    from boxer_tpu_torch.parallel.sharding import (gather_state,
                                                   optimizer_state_dict,
                                                   param_names)

    run = _trainer(cfg_path, _layout_opts(2, 1, 2) + [
        "training.max_update=2", "training.checkpoint_interval=2",
        "training.run_type=train", f"training.save_dir={root}/zero1"])
    run.train()
    st = run.state
    torch.save(dict(
        optimizer=type(st.optimizer).__name__,
        model=gather_state(st.model.state_dict(), run.layout),
        state=optimizer_state_dict(st.optimizer, run.layout,
                                   param_names(st.model, st.optimizer))),
        root / f"rank{dist.get_rank()}.pt")


def _waymo_db_ranks(opts, root):
    """BoxeR-3D with the GT-database sampler at mp2: 2 updates with a
    checkpoint, which a second trainer resumes for 1 more; each rank's
    draws after the first run, its restored draws and its last step."""
    import torch.distributed as dist

    def trainer(extra):
        return _trainer(WAYMO_CONFIG, opts + _layout_opts(1, 1, 2) + extra,
                        "detection3d", "boxer3d")

    first = trainer(["training.max_update=2", f"training.save_dir={root}/mp2"])
    first.train()
    resumed = trainer(["training.max_update=3", "training.resume=true",
                       f"training.save_dir={root}/mp2"])
    restored = resumed.loaders["train"].draw_state
    resumed.train()
    torch.save(dict(draws=first.loaders["train"].draw_state,
                    restored=restored, step=resumed.state.step),
               root / f"rank{dist.get_rank()}.pt")


def _sp2_trainer_ranks(cfg_path, root):
    import torch.distributed as dist

    trainer = _trainer(cfg_path, [
        "distributed.sp=2", "training.max_update=1",
        "training.run_type=train", f"training.save_dir={root}/sp2"])
    assert trainer.layout.sp.size == 2 and trainer.layout.dp.size == 1
    trainer.train()
    torch.save((trainer.current_update, trainer.state.step),
               root / f"rank{dist.get_rank()}.pt")


# ---------------------------------------------------------------------------
# the updates against JAX's unsharded one

def _ranks_out(out_dir, world):
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _grads_close(got, want, single, tol=2e-3):
    """Raw gradients by name: against JAX's (`want`, worst leaf `tol`) and
    against the port's world-1 update (`single`, 1e-5 of its largest)."""
    from test_torch_modules import _rel_err

    assert sorted(got) == sorted(want) == sorted(single)
    worst = max(_rel_err(g.numpy(), want[n]) for n, g in got.items())
    assert worst <= tol, worst
    top = max(float(g.abs().max()) for g in single.values())
    diff = max(float((g - single[n]).abs().max()) for n, g in got.items())
    assert diff <= 1e-5 * top, (diff, top)


def _ranks_agree(ranks, dp, sp, mp):
    """Every rank's whole parameters bitwise equal; the coordinates and
    groups of JAX's reshape(dp, sp, mp)."""
    for r, got in enumerate(ranks):
        d, s, m = got["coord"]
        assert r == (d * sp + s) * mp + m
        for axis, size in (("dp", dp), ("sp", sp), ("mp", mp),
                           ("grad", dp * sp)):
            ranks_of = got["groups"][axis]
            assert (ranks_of is None) == (size == 1), axis
            assert ranks_of is None or (len(ranks_of) == size
                                        and r in ranks_of)
        assert all(torch.equal(p, ranks[0]["params"][n])
                   for n, p in got["params"].items())


def _world1(task_file, opts, out):
    """The port's world-1 update of the task in a process of its own,
    launched as the ranks are: under the suite's thread budget it runs on
    one thread, as each rank does (CPU kernels sum in another order on
    more, which moves a few leaves by 1e-3)."""
    out.mkdir()
    _launch(_update_ranks, task_file, opts, out, world=1)
    return _ranks_out(out, 1)[0]


def _jax_reference(root, tmp, cfg, opts, task="detection", model="boxer2d",
                   pop_mask=False, **kw):
    """The JAX package's unsharded update of the task's first batch (run
    beside) the port's world-1 debug update, and the task file the ranks
    load."""
    from boxer_tpu_torch.utils.weights import jax_to_torch_state

    batch, weights, jax_step, _ = _jax_update(
        cfg, opts, task, model, debug_grads=True, **kw)
    if pop_mask:
        batch.pop("mask")
    task_file = tmp / f"{model}_task.pt"
    torch.save(dict(config=str(cfg), task=task, model=model, batch=batch,
                    weights=weights), task_file)
    out = tmp / f"{model}_world1"
    out.mkdir()
    want, deltas = _run_ranks_beside(_update_ranks, lambda: jax_step(batch),
                                     task_file, opts, out, world=1)
    single = _ranks_out(out, 1)[0]
    j_grads, _ = jax_to_torch_state({"params": want.pop("_grads")})
    port = (single["stats"][0], {n: p - weights[n]
                                 for n, p in single["params"].items()})
    return dict(task=task_file, weights=weights, want=want, deltas=deltas,
                j_grads=j_grads, single=single, port=port, opts=opts)


@pytest.fixture(scope="module")
def coco7(tmp_path_factory):
    from test_torch_data import write_coco

    return write_coco(tmp_path_factory.mktemp("model_parallel_coco"),
                      n_images=7)


@pytest.fixture(scope="module")
def det_ref(coco7, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp_det")
    cfg = _tiny(coco7, tmp, use_mask=False)
    return _jax_reference(coco7, tmp, cfg, OPTS_2D)


def _launch_update(ref, layout, tmp_path):
    dp, sp, mp = layout
    out = tmp_path / "ranks"
    out.mkdir()
    _launch(_update_ranks, ref["task"], ref["opts"] + _layout_opts(*layout),
            out, world=dp * sp * mp)
    return _ranks_out(out, dp * sp * mp)


def _held(ranks, ref, layout, grad_tol=1e-4, param_tol=2e-3,
          single_tol=1e-3):
    got = ranks[0]
    _held_against_jax(got, ref["weights"], ref["want"], ref["deltas"],
                      grad_tol, ref["port"], param_tol, single_tol)
    _grads_close(got["grads"], ref["j_grads"], ref["single"]["grads"])
    _ranks_agree(ranks, *layout)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_layout_update_matches_jax(det_ref, tmp_path, name):
    layout = LAYOUTS[name]
    ranks = _launch_update(det_ref, layout, tmp_path)
    _held(ranks, det_ref, layout)
    counts = ranks[0]["counts"]
    dp, sp, mp = layout
    assert ("reduce_from_mp" in counts) == (mp > 1)
    assert ("gather_tokens" in counts) == (sp > 1)
    if sp > 1:
        # the encoder layer's value (again in remat's recompute) and the
        # encoder's output; each one's backward once
        assert counts["gather_tokens"][0] == 3
        assert counts["gather_tokens backward"][0] == 2


def test_segm_sp2mp2_matches_jax(coco7, tmp_path):
    """The parameters against the port's world-1 update at 2e-3: the mask
    head's first (transposed) conv sums over every RoI pixel of the batch,
    and the world-1 port's gradient of that one leaf is 1.15e-3 from JAX's
    and from the sp2 x mp2 one alike (every other leaf within 4.7e-4)."""
    cfg = _tiny(coco7, tmp_path, use_mask=True)
    ref = _jax_reference(coco7, tmp_path, cfg, OPTS_2D)
    _held(_launch_update(ref, (1, 2, 2), tmp_path), ref, (1, 2, 2),
          single_tol=2e-3)


@pytest.fixture(scope="module")
def waymo7(tmp_path_factory):
    from test_torch_waymo import write_waymo_small

    return write_waymo_small(tmp_path_factory.mktemp("mp_waymo"), val=3)


def test_boxer3d_mp2_matches_jax(waymo7, tmp_path, monkeypatch):
    from test_torch_boxer3d import _TwoPassLinen
    from test_torch_trainer import waymo_opts

    from boxer_tpu.nn import point_pillar

    monkeypatch.setattr(point_pillar, "nn", _TwoPassLinen())
    opts = waymo_opts(waymo7, tmp_path / "save", db=False) + [
        "model_config.boxer3d.hidden_dim=64", "optimizer.type=sgd",
        "optimizer.params.lr=10.0", "optimizer.params.lr_backbone=1.0",
        "scheduler.params.use_warmup=false", "training.run_type=train",
        "training.batch_size=2"]
    ref = _jax_reference(
        waymo7, tmp_path, WAYMO_CONFIG, opts, "detection3d", "boxer3d",
        jax_cfg_path=REPO / "boxer_tpu/config/Waymo-Detection/"
        "boxer3d_pointpillar.yaml", static_3d=True)
    _held(_launch_update(ref, (1, 1, 2), tmp_path), ref, (1, 1, 2),
          grad_tol=2e-3)


def test_detr_mp2_matches_jax(coco7, tmp_path):
    from test_torch_detr import tiny_detr_config

    cfg = tmp_path / "detr.yaml"
    cfg.write_text(tiny_detr_config(coco7, tmp_path / "save", dropout=0.0))
    ref = _jax_reference(coco7, tmp_path, cfg, DETR_OPTS, model="detr",
                         pop_mask=True)
    assert "loss_ce_0" in ref["want"]
    _held(_launch_update(ref, (1, 1, 2), tmp_path), ref, (1, 1, 2))


# ---------------------------------------------------------------------------
# dropout, checkpoints and eval through the trainer at sp2 x mp2

@pytest.fixture(scope="module")
def sharded_trainer(coco7, tmp_path_factory):
    """The tiny segm trainer (dropout 0.1) at sp2 x mp2 and the world-1
    runs the test holds it against."""
    root = tmp_path_factory.mktemp("mp_trainer")
    cfg = _tiny(coco7, root)
    drop = ["model_config.boxer2d.transformer.params.dropout=0.1"]
    batch, weights, _, _ = _jax_update(cfg, OPTS_2D + drop, "detection",
                                       "boxer2d")
    task = dict(config=str(cfg), task="detection", model="boxer2d",
                batch=batch, weights=weights, opts=OPTS_2D + drop)
    torch.save(task, root / "task.pt")
    single = _world1(root / "task.pt", OPTS_2D + drop, root / "world1")
    # a world-1 checkpoint at update 2, for the ranks to resume
    _trainer(cfg, drop + ["training.run_type=train", "training.max_update=2",
                          "training.checkpoint_interval=2",
                          f"training.save_dir={root}/from_one"]).train()
    opts = drop + _layout_opts(1, 2, 2)
    _launch(_trainer_ranks, cfg, opts, root, world=4)
    return cfg, root, single, _ranks_out(root, 4)


def test_dropout_sp2mp2_equals_world1(sharded_trainer):
    """The masks are the world-1 run's: a wrong part of a mask moves a
    gradient element by its whole size. The gradients are held at 1e-4 of
    the largest: the row-parallel sums over mp, in another order, move
    this update's by 1.02e-5 of it (sp alone 3.2e-7; a spread over
    thousands of elements, not a mask's)."""
    from test_torch_modules import _rel_err

    _, _, single, ranks = sharded_trainer
    got = ranks[0]["dropout"]
    keys = [k for k in single["stats"][0] if k != "skipped"]
    for k in keys:
        assert _rel_err(got["stats"][0][k], single["stats"][0][k]) <= 1e-5, k
    top = max(float(g.abs().max()) for g in single["grads"].values())
    diff = max(float((g - single["grads"][n]).abs().max())
               for n, g in got["grads"].items())
    assert diff <= 1e-4 * top, (diff, top)
    _ranks_agree([r["dropout"] for r in ranks], 1, 2, 2)


def test_checkpoint_sp2mp2_resumes_at_world1_and_back(sharded_trainer,
                                                       tmp_path):
    cfg, root, _, ranks = sharded_trainer
    ckpt = torch.load(root / "sharded/checkpoints/model_2.pth",
                      weights_only=True)
    model, opt = ranks[0]["trained"]
    assert sorted(ckpt["model"]) == sorted(model)
    assert all(torch.equal(v, ckpt["model"][k]) for k, v in model.items())
    assert _state_equal(opt, ckpt["optimizer"])
    for r in ranks:
        assert all(torch.equal(v, model[k]) for k, v in r["trained"][0].items())
    # at world 1: the sp2 x mp2 checkpoint restored bitwise, one more update
    os.makedirs(tmp_path / "one/checkpoints")
    shutil.copy(root / "sharded/checkpoints/model_2.pth",
                tmp_path / "one/checkpoints")
    one = _trainer(cfg, ["training.run_type=train", "training.resume=true",
                         "training.max_update=3",
                         f"training.save_dir={tmp_path}/one"])
    assert one.state.step == 2
    assert all(torch.equal(v, ckpt["model"][k])
               for k, v in one.state.model.state_dict().items())
    assert _state_equal(one.state.optimizer.state_dict(), ckpt["optimizer"])
    one.train()
    assert one.state.step == 3
    # and back: a world-1 checkpoint restored at sp2 x mp2, every rank's
    # gathered state bitwise
    w1 = torch.load(root / "from_one/checkpoints/model_2.pth",
                    weights_only=True)
    for r in ranks:
        step, model, opt = r["restored"]
        assert step == 2
        assert all(torch.equal(v, w1["model"][k]) for k, v in model.items())
    assert _state_equal(ranks[0]["restored"][2], w1["optimizer"])


def test_sharded_eval_holds_each_image_once(sharded_trainer):
    cfg, root, _, ranks = sharded_trainer
    assert all(r["val"] == ranks[0]["val"] for r in ranks)
    ap = ranks[0]["val"]["coco_eval_bbox"]
    assert len(ap) == 12 and 0.0 <= ap[0] <= 1.0
    got = json.loads((root / "sharded/test_result.json").read_text())
    per_image = {}
    for r in got:
        per_image[r["image_id"]] = per_image.get(r["image_id"], 0) + 1
    assert sorted(per_image) == list(range(1, 8))
    assert len(set(per_image.values())) == 1


def test_checkpoint_dp2mp2_zero1_resumes_at_world1(coco7, tmp_path):
    """ZeRO-1 over dp under mp: the moments gathered over dp to each dp
    group's first rank, then over mp; the checkpoint holds the whole
    state, which a world-1 trainer restores bitwise."""
    cfg = _tiny(coco7, tmp_path)
    _launch(_zero1_ranks, cfg, tmp_path, world=4)
    ranks = _ranks_out(tmp_path, 4)
    assert {r["optimizer"] for r in ranks} == {"ZeroRedundancyOptimizer"}
    assert [r["state"] is None for r in ranks] == [False, False, True, True]
    ckpt = torch.load(tmp_path / "zero1/checkpoints/model_2.pth",
                      weights_only=True)
    assert _state_equal(ranks[0]["state"], ckpt["optimizer"])
    for r in ranks:
        assert all(torch.equal(v, ckpt["model"][k])
                   for k, v in r["model"].items())
    os.makedirs(tmp_path / "one/checkpoints")
    shutil.copy(tmp_path / "zero1/checkpoints/model_2.pth",
                tmp_path / "one/checkpoints")
    one = _trainer(cfg, ["training.run_type=train", "training.resume=true",
                         "training.max_update=3",
                         f"training.save_dir={tmp_path}/one"])
    assert one.state.step == 2
    assert sorted(ckpt["optimizer"]["state"]) == list(range(len(list(
        one.state.model.parameters()))))
    assert all(torch.equal(v, ckpt["model"][k])
               for k, v in one.state.model.state_dict().items())
    assert _state_equal(one.state.optimizer.state_dict(), ckpt["optimizer"])


def test_waymo_db_checkpoint_mp2_resumes_at_mp2_and_world1(waymo7,
                                                            tmp_path):
    """The GT-database draws (the shipped Waymo config's sampler on) of a
    mp2 run: both mp ranks of the data shard draw alike and the checkpoint
    holds the shard's one entry, which each rank restores at mp2 and a
    world-1 trainer restores too; both resumed runs train on."""
    from test_torch_trainer import waymo_opts

    opts = [o for o in waymo_opts(waymo7, None)
            if not o.startswith("training.max_update")] + [
        "training.run_type=train"]
    _launch(_waymo_db_ranks, opts, tmp_path)
    ranks = _ranks_out(tmp_path, 2)
    assert _draws_equal(ranks[0]["draws"], ranks[1]["draws"])
    ckpt = torch.load(tmp_path / "mp2/checkpoints/model_2.pth",
                      weights_only=True)
    saved = ckpt["extra"]["draw_states"]
    assert len(saved) == 1 and _draws_equal(ranks[0]["draws"], saved[0])
    for r in ranks:
        assert _draws_equal(r["restored"], saved[0]) and r["step"] == 3
    os.makedirs(tmp_path / "one/checkpoints")
    shutil.copy(tmp_path / "mp2/checkpoints/model_2.pth",
                tmp_path / "one/checkpoints")
    one = _trainer(WAYMO_CONFIG, opts + [
        "training.max_update=3", "training.resume=true",
        f"training.save_dir={tmp_path}/one"], "detection3d", "boxer3d")
    assert one.state.step == 2
    assert _draws_equal(one.loaders["train"].draw_state, saved[0])
    one.train()
    assert one.state.step == 3


def test_sp2_trainer_trains(coco7, tmp_path):
    """The JAX package's `test_trainer_sp2_loads_and_trains`: a trainer at
    distributed.sp=2 (two ranks, dp 1) loads and trains one update."""
    cfg = _tiny(coco7, tmp_path)
    _launch(_sp2_trainer_ranks, cfg, tmp_path)
    assert _ranks_out(tmp_path, 2) == [(1, 1), (1, 1)]


# ---------------------------------------------------------------------------
# the TP rule, the collectives

def _jax_cut(variables):
    """The JAX leaves `param_spec` shards at mp 2, by weight-map name."""
    import jax
    from jax.sharding import PartitionSpec as P

    from boxer_tpu.parallel.sharding import param_spec

    leaves, _ = jax.tree_util.tree_flatten_with_path(variables["params"])
    return {"/".join(["params"] + [str(getattr(p, "key", p)) for p in path])
            for path, leaf in leaves if param_spec(path, leaf, 2) != P()}


def _tp_models(model):
    import jax.numpy as jnp

    if model == "boxer2d":
        from test_torch_boxer2d import TINY, _inputs
        from test_torch_modules import random_variables

        from boxer_tpu.models.boxer2d import BoxeR2D as JaxBoxeR2D
        from boxer_tpu_torch.models.boxer2d import BoxeR2D

        image, mask = _inputs(True)
        jm = JaxBoxeR2D(**TINY, use_mask=True)
        v = random_variables(jm, 0, jnp.asarray(image), jnp.asarray(mask),
                             train=False)
        return v, BoxeR2D(**TINY, use_mask=True)
    if model == "boxer3d":
        from test_torch_boxer3d import TINY, _models

        _, v, tm, _ = _models(**TINY)
        return v, tm
    from test_torch_detr import _models

    _, v, tm, _ = _models()
    return v, tm


@pytest.mark.parametrize("model", ["boxer2d", "boxer3d", "detr"])
def test_tp_rule_matches_param_spec(model):
    """The weights the port cuts over mp are the ones JAX's `param_spec`
    shards (through `jax_to_torch_state`'s names), besides the exceptions:
    the port also cuts `linear_box_*` and `linear_attn_*` (read by head)
    and the biases of its column-parallel layers (a Dense bias is no
    kernel, which is all `param_spec` shards)."""
    from boxer_tpu_torch.parallel.sharding import tp_rule
    from boxer_tpu_torch.utils.weights import jax_to_torch_state

    v, tm = _tp_models(model)
    _, src = jax_to_torch_state(v)
    names = [n for n, _ in tm.named_parameters()]
    assert all(n in src for n in names)
    exceptions = ("linear_box_weight", "linear_box_bias",
                  "linear_attn_weight", "linear_attn_bias",
                  "value_proj.bias", "linear1.bias", "in_proj_bias")
    cut = [n for n in names if tp_rule(n)]
    port = {j for n in cut if not n.endswith(exceptions) for j in src[n]}
    jax_cut = _jax_cut(v)
    assert port == jax_cut and len(jax_cut) > 0
    # the exceptions are what JAX keeps whole
    assert not {j for n in cut if n.endswith(exceptions)
                for j in src[n]} & jax_cut
    kinds = {tp_rule(n) for n in cut}
    assert kinds == {"column", "qkv", "row"}


def test_collectives_raise_without_group():
    from boxer_tpu_torch.parallel.collectives import (Tokens, copy_to_mp,
                                                      gather_tokens,
                                                      reduce_from_mp,
                                                      slice_tokens)
    from boxer_tpu_torch.parallel.mesh import Axis

    x = torch.ones(1, 4, 2)
    loose = Axis(2, 0, None)
    for fn in (lambda: copy_to_mp(x, loose), lambda: reduce_from_mp(x, loose),
               lambda: gather_tokens(x, Tokens(loose, 8)),
               lambda: slice_tokens(x, Tokens(loose, 4)),
               lambda: copy_to_mp(x, None)):
        with pytest.raises(RuntimeError, match="no process group"):
            fn()


@pytest.mark.parametrize("size", [2, 4])
def test_shard_state_round_trip(size):
    """Each mp rank's part of every kind of cut weight, put back together,
    is the whole; q, k and v are cut each by its own heads."""
    from boxer_tpu_torch.parallel.mesh import Axis, Layout
    from boxer_tpu_torch.parallel.sharding import _whole, shard_state, tp_rule

    rs = np.random.RandomState(0)
    state = {n: torch.from_numpy(rs.randn(*shape).astype(np.float32))
             for n, shape in (("a.value_proj.weight", (8, 3)),
                              ("a.in_proj_weight", (24, 8)),
                              ("a.in_proj_bias", (24,)),
                              ("a.out_proj.weight", (3, 8)),
                              ("a.out_proj.bias", (3,)),
                              ("a.linear_box_weight", (16, 3)))}
    parts = [shard_state(state, Layout(mp=Axis(size, i)))
             for i in range(size)]
    for n, t in state.items():
        kind = tp_rule(n)
        if kind is None:
            assert all(p[n] is t for p in parts)
            continue
        assert torch.equal(_whole([p[n] for p in parts], kind), t)
    # rank 0's q, k and v rows are the first rows of each third
    rows = 8 // size
    q0 = parts[0]["a.in_proj_weight"]
    for j in range(3):
        assert torch.equal(q0[j * rows:(j + 1) * rows],
                           state["a.in_proj_weight"][8 * j:8 * j + rows])
