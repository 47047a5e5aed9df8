"""Data parallel training of the port on the CPU: two ranks are two
processes joined over gloo by `boxer_tpu_torch.parallel.distributed.launch`,
each call with a free port and a hard timeout (the ranks are killed past
it). The ranks run this module's `_*_ranks` functions, which import
neither JAX nor the JAX package; the JAX side runs in the test's process
(JAX and its helpers are imported inside the tests for that reason).

- The (dp, sp, mp) layout against the processes, and its errors (the
  sharded layouts themselves: `test_torch_model_parallel.py`).
- One world-2 update of the tiny BoxeR-2D (`test_torch_trainer.tiny_config`
  as `test_trainer_update_matches_jax` cuts it: hidden 64, SGD at LR 10)
  at iter_per_update 1 and 2, each rank on its half of the JAX loader's
  first batch, against the JAX package's one-device step on the whole
  batch from the same weights (the weight map): loss terms, accuracy,
  num_boxes and the gradient norm within rel 1e-4, the updated parameters'
  worst leaf within 2e-3 (that test's tolerances); and a batch whose
  second rank holds no valid target (the global num_boxes). The same for
  the tiny BoxeR-3D from the shipped Waymo config
  (`test_torch_trainer.waymo_opts`; the gradient norm at 2e-3, as
  `test_trainer_3d_update_matches_jax`; the parameters at 3e-3 at ipu 2,
  see the test). Each also within 1e-3 (stats 1e-5) of the port's
  single-process update of the whole batch.
- ZeRO-1 on and off equal bitwise over 2 AdamW updates (the optimizer
  state gathered from the shards); one rank's image non-finite: both ranks
  skip, their states unchanged and equal.
- The trainer at world 2 on a COCO directory of 7 images (the sampler pads
  each split to 8, so one image is evaluated on both ranks): a checkpoint
  at update 2 resumed at world 2 replays 4 uninterrupted updates bitwise
  (model, optimizer state, position); the same checkpoint (a plain
  optimizer state_dict, the model's own keys) resumed at world 1, and a
  world-1 checkpoint resumed at world 2 (model and state bitwise); val
  metrics and `test_result.json` (every test image once) equal a world-1
  evaluation of the same weights.
- The Waymo trainer at world 2 with the GT-database sampler: the ranks'
  draws differ, a resume replays 3 updates bitwise with each rank's
  cursors, val and test `results.pkl` hold every frame once (3 val frames,
  one padded), and a world-1 resume of that checkpoint raises.
- The loader's seeds: as before at one replica, the rank folded in at two.
- The process-group helpers at world 2, and the launcher's timeout and a
  failing rank; CPU ranks share the launching process's threads, and the
  test process holds `torch_threads`'s budget.
"""

import torch_threads  # (first: the CPU thread budget)
import json
import os
import pickle
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
WAYMO_CONFIG = REPO / "boxer_tpu_torch/config/Waymo-Detection/boxer3d_pointpillar.yaml"
TIMEOUT = 300


def _launch(fn, *args, world=2, timeout=TIMEOUT):
    from boxer_tpu_torch.parallel.distributed import launch

    launch(fn, world, "gloo", args=args, timeout=timeout)


def _trainer(cfg_path, opts, task="detection", model="boxer2d"):
    from boxer_tpu_torch.trainer import build_trainer
    from boxer_tpu_torch.utils.config import Configuration

    configuration = Configuration(str(cfg_path), opts=list(opts), extra={
        "task": task, "model": model}, device="cpu")
    trainer = build_trainer(configuration, device="cpu")
    trainer.load()
    return trainer


def _share(batch, rank, world):
    """Rank's share of an update's host batch (leading (A, B) axes): its B
    / world samples of every microbatch; of a voxel batch, those frames'
    voxel blocks with their batch indices from 0."""
    b = batch["targets"]["valid"].shape[1] // world
    lo, hi = rank * b, (rank + 1) * b
    out = {"targets": {k: v[:, lo:hi] for k, v in batch["targets"].items()}}
    if "voxels" in batch:
        per = batch["voxels"].shape[1] // (b * world)
        for k in ("voxels", "coordinates", "num_points_per_voxel"):
            out[k] = batch[k][:, lo * per:hi * per]
        c = out["coordinates"]
        out["coordinates"] = np.concatenate(
            [np.where(c[..., :1] >= 0, c[..., :1] - lo, -1), c[..., 1:]], -1)
        out["grid_shape"], out["batch_size"] = batch["grid_shape"], b
    else:
        out["image"] = batch["image"][:, lo:hi]
        if "mask" in batch:
            out["mask"] = batch["mask"][:, lo:hi]
    return out


def _to_torch(batch):
    return {k: _to_torch(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray)
            else v for k, v in batch.items()}


def _params(trainer):
    return {n: p.detach().clone()
            for n, p in trainer.state.model.named_parameters()}


def _state_equal(a, b):
    """Two optimizer state_dicts' state, bitwise."""
    return sorted(a["state"]) == sorted(b["state"]) and all(
        torch.equal(v, b["state"][i][k]) if torch.is_tensor(v)
        else v == b["state"][i][k]
        for i, s in a["state"].items() for k, v in s.items())


# ---------------------------------------------------------------------------
# what the ranks run (no JAX here: the ranks import this module)

def _step_ranks(task_path, out_dir):
    """Every run of the task: a trainer from its config and dotlist with
    the task's weights takes `steps` train steps on this rank's share of
    the task's batch (a NaN pixel in `nan_rank`'s image); the stats, the
    parameters, the gathered optimizer state and the LRs to
    <out_dir>/rank<r>.pt."""
    import torch.distributed as dist

    from boxer_tpu_torch.parallel.sharding import optimizer_state_dict

    task = torch.load(task_path, weights_only=False)
    rank, world = dist.get_rank(), dist.get_world_size()
    share = _share(task["batch"], rank, world)
    out = {}
    for run in task["runs"]:
        trainer = _trainer(task["config"], run["opts"], task["task"],
                           task["model"])
        trainer.state.model.load_state_dict(task["weights"])
        stats = []
        for _ in range(run.get("steps", 1)):
            batch = _to_torch(share)
            if run.get("nan_rank") == rank:
                batch["image"][0, 0, 0, 0, 0] = float("nan")
            stats.append(trainer._train_step(trainer.state, batch)[1])
        out[run["tag"]] = dict(
            stats=stats, params=_params(trainer), step=trainer.state.step,
            optimizer=optimizer_state_dict(trainer.state.optimizer),
            sharded=type(trainer.state.optimizer).__name__,
            lrs={g["name"]: g["lr"]
                 for g in trainer.state.optimizer.param_groups})
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def _resume_ranks(cfg_path, root):
    """BoxeR-2D at world 2: 4 uninterrupted updates (then val and test,
    rank 0's metrics); 2 with a checkpoint; that checkpoint resumed for 2
    more. Parameters, gathered optimizer state and the resume position to
    <root>/rank<r>.pt."""
    import torch.distributed as dist

    from boxer_tpu_torch.parallel.sharding import optimizer_state_dict

    base = ["training.checkpoint_interval=2"]
    whole = _trainer(cfg_path, base + [
        "training.max_update=4", f"training.save_dir={root}/whole"])
    whole.train()
    val = whole.evaluate("val")
    cut = base + ["training.run_type=train", "training.num_checkpoint=2",
                  f"training.save_dir={root}/cut"]
    _trainer(cfg_path, cut + ["training.max_update=2"]).train()
    resumed = _trainer(cfg_path, cut + [
        "training.max_update=4",
        "training.resume=true"])
    position = (resumed.current_update, resumed.current_epoch,
                resumed.epoch_batches_done)
    resumed.train()
    # a world-1 checkpoint (written before the ranks started) resumed here
    from_one = _trainer(cfg_path, base + [
        "training.max_update=3", "training.run_type=train",
        "training.resume=true", f"training.save_dir={root}/one_to_two"])
    one_restored = (from_one.state.step, _params(from_one),
                    optimizer_state_dict(from_one.state.optimizer))
    from_one.train()
    torch.save(dict(
        whole=_params(whole), resumed=_params(resumed), position=position,
        val={k: v.tolist() for k, v in val.items()},
        whole_opt=optimizer_state_dict(whole.state.optimizer),
        resumed_opt=optimizer_state_dict(resumed.state.optimizer),
        steps=(whole.state.step, resumed.state.step),
        one_restored=one_restored, one_step=from_one.state.step),
        os.path.join(root, f"rank{dist.get_rank()}.pt"))


def _waymo_ranks(opts, root):
    """BoxeR-3D at world 2 with the GT-database sampler: 3 updates (val
    and test after), 2 with a checkpoint and that checkpoint resumed for 1
    more; each rank's draws, parameters and the gathered optimizer state to
    <root>/rank<r>.pt."""
    import torch.distributed as dist

    from boxer_tpu_torch.parallel.sharding import optimizer_state_dict

    def trainer(extra):
        return _trainer(WAYMO_CONFIG, opts + extra, "detection3d", "boxer3d")

    whole = trainer(["training.max_update=3", f"training.save_dir={root}/whole"])
    whole.train()   # then val, then test: results.pkl is test's
    if dist.get_rank() == 0:
        shutil.copy(f"{root}/whole/results.pkl", f"{root}/test_results.pkl")
    whole.evaluate("val")
    trainer(["training.max_update=2", "training.run_type=train",
             f"training.save_dir={root}/cut"]).train()
    resumed = trainer(["training.max_update=3", "training.run_type=train",
                       "training.resume=true", f"training.save_dir={root}/cut"])
    restored = resumed.loaders["train"].draw_state
    resumed.train()
    torch.save(dict(
        whole=_params(whole), resumed=_params(resumed),
        draws=whole.loaders["train"].draw_state,
        resumed_draws=resumed.loaders["train"].draw_state,
        restored=restored,
        whole_opt=optimizer_state_dict(whole.state.optimizer),
        resumed_opt=optimizer_state_dict(resumed.state.optimizer)),
        os.path.join(root, f"rank{dist.get_rank()}.pt"))


def _helpers_ranks(out_dir):
    from boxer_tpu_torch.parallel import distributed as d

    rank = d.get_rank()
    np.random.seed(100 + rank)
    t = torch.full((3,), float(rank + 1))
    out = dict(
        rank=rank, world=d.get_world_size(), master=d.is_master(),
        grouped=d.is_dist_avail_and_initialized(),
        gathered=d.all_gather({"r": rank}), gather=d.gather(rank * 10),
        scalar=d.broadcast_scalar(rank + 5),
        mean=d.reduce_dict({"x": rank}), total=d.reduce_dict(
            {"x": rank}, average=False),
        seed=d.shared_random_seed(),
        summed=d.all_reduce_sum(t.clone()).tolist(),
        broadcast=d.broadcast(t.clone(), src=1).tolist())
    d.synchronize()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def _sleeping_ranks(seconds):
    time.sleep(seconds)


def _failing_ranks():
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails")


def _threads_ranks(out_dir):
    import torch.distributed as dist

    torch.save(torch.get_num_threads(),
               os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))


# ---------------------------------------------------------------------------
# the layout

@pytest.mark.parametrize("world,dp,mp,sp,want", [
    (1, None, 1, 1, 1), (4, None, 1, 1, 4), (2, 2, 1, 1, 2),
    (8, None, 1, 1, 8), (2, None, 2, 1, 1), (2, None, 1, 2, 1),
    (8, None, 2, 2, 2), (8, 2, 2, 2, 2)])
def test_resolve_dp(world, dp, mp, sp, want):
    from boxer_tpu_torch.parallel.mesh import resolve_dp

    assert resolve_dp(world, dp, mp, sp) == want


@pytest.mark.parametrize("world,dp,mp,sp,error", [
    (1, 2, 1, 1, ValueError), (2, 3, 1, 1, ValueError),
    (2, 1, 1, 1, ValueError), (4, 0, 1, 1, ValueError),
    (4, None, 3, 1, ValueError), (4, 2, 1, 3, ValueError),
], ids=["dp2_world1", "dp3_world2", "dp1_world2", "dp0", "mp3_world4",
        "dp2_sp3_world4"])
def test_resolve_dp_errors(world, dp, mp, sp, error):
    """A layout the processes cannot hold: dp * sp * mp is not the world,
    or mp * sp does not divide it."""
    from boxer_tpu_torch.parallel.mesh import resolve_dp

    with pytest.raises(error, match="world size"):
        resolve_dp(world, dp, mp, sp)


@pytest.mark.parametrize("dist_cfg,want", [
    ({"dp": None, "world_size": 8}, 8), ({"dp": 2, "world_size": 1}, 2),
    ({"dp": None, "world_size": 1}, 1),
    ({"dp": 2, "sp": 2, "mp": 2, "world_size": 1}, 8),
    ({"dp": None, "sp": 2, "world_size": 4}, 4)])
def test_num_processes(dist_cfg, want):
    from boxer_tpu_torch.parallel.mesh import num_processes

    assert num_processes(dist_cfg) == want


def test_world_of_one_has_no_group(coco7, tmp_path):
    """A trainer outside a process group is world 1, creates no group and
    keeps the plain optimizer; `distributed.dp=2` there raises."""
    import torch.distributed as dist

    cfg = _tiny(coco7, tmp_path)
    trainer = _trainer(cfg, ["training.run_type=train"])
    assert (trainer.rank, trainer.world_size) == (0, 1)
    assert not dist.is_initialized()
    assert type(trainer.state.optimizer).__name__ == "AdamW"
    assert trainer.loaders["train"].batch_size == 2
    with pytest.raises(ValueError, match="world size"):
        _trainer(cfg, ["distributed.dp=2"])


# ---------------------------------------------------------------------------
# one world-2 update against JAX's one-device step on the whole batch

@pytest.fixture(scope="module")
def coco7(tmp_path_factory):
    from test_torch_data import write_coco

    return write_coco(tmp_path_factory.mktemp("parallel_coco"), n_images=7)


def _tiny(root, tmp_path, **kw):
    from test_torch_trainer import tiny_config

    path = tmp_path / "exp.yaml"
    path.write_text(tiny_config(root, tmp_path / "save", **kw))
    return path


JAX_2D_OPTS = ["model_config.boxer2d.hidden_dim=64",
               "model_config.boxer2d.transformer.params.nhead=2",
               "optimizer.type=sgd", "optimizer.params.lr=10.0",
               "optimizer.params.lr_backbone=1.0", "scheduler.type=step",
               "scheduler.params.mode=epoch", "scheduler.params.step_size=1",
               "training.run_type=train"]


def _jax_update(cfg_path, opts, task, model, jax_cfg_path=None,
                static_3d=False, debug_grads=False):
    """The JAX side from the same yaml and dotlist: the JAX loader's first
    batch, seeded weights (the port's state_dict through the weight map),
    and a function that runs the jitted step on a batch from them:
    (stats, parameter updates by port name); with `debug_grads` the stats
    hold JAX's pre-clip gradients under `_grads`."""
    import jax
    import jax.numpy as jnp
    from test_torch_boxer3d import _spread
    from test_torch_modules import random_variables

    from boxer_tpu.criterion.losses import build_loss as j_loss
    from boxer_tpu.criterion.metrics import build_metrics as j_metrics
    from boxer_tpu.dataset import build_dataloader as j_loader
    from boxer_tpu.dataset import build_dataset as j_dataset
    from boxer_tpu.models import build_model as j_model
    from boxer_tpu.optim import build_optimizer as j_optimizer
    from boxer_tpu.optim import build_schedule as j_schedule
    from boxer_tpu.parallel.steps import create_train_state, make_train_step
    from boxer_tpu.utils.config import Configuration as JConfiguration
    from boxer_tpu_torch.utils.weights import jax_to_torch_state, \
        load_jax_params

    port = _trainer(cfg_path, opts, task, model)
    cfg = JConfiguration(str(jax_cfg_path or cfg_path), opts=list(opts), extra={
        "task": task, "model": model}).get_config()
    model_cfg = cfg.model_config[model]
    dataset = j_dataset(task, cfg.dataset_config[task], "train")
    rc = cfg.training
    loader = j_loader(dataset, "train", batch_size=rc.batch_size,
                      num_workers=1, iter_per_update=rc.iter_per_update,
                      seed=port.seed)
    batch = next(iter(loader))
    batch.pop("meta")
    jm = j_model(model_cfg, dataset.get_answer_size())
    if static_3d:
        static = {"grid_shape": batch.pop("grid_shape"),
                  "batch_size": rc.batch_size // rc.iter_per_update}
        batch.pop("batch_size")
        v = _spread(random_variables(jm, 0, *(jnp.asarray(batch[k][0]) for k in (
            "voxels", "coordinates", "num_points_per_voxel")),
            static["grid_shape"], static["batch_size"], train=False))
        kw, max_norm = {"static": static}, 1.0
    else:
        v = random_variables(jm, 0, jnp.asarray(batch["image"][0]),
                             jnp.asarray(batch["mask"][0]), train=False)
        kw, max_norm = {}, 0.1
    assert load_jax_params(port.state.model, v) == ([], [])
    opt_cfg = cfg.optimizer.to_dict()
    opt_cfg["params"]["deform_lr_multi"] = model_cfg.deform_lr_multi
    sched_cfg = cfg.scheduler.to_dict()
    sched_cfg["params"]["_steps_per_epoch"] = len(loader)
    tx, _ = j_optimizer(opt_cfg, v["params"],
                        j_schedule(sched_cfg, opt_cfg["params"]["lr"]))
    jstep = jax.jit(make_train_step(
        jm, j_loss(model_cfg.loss, dataset.get_answer_size()), tx,
        max_norm=max_norm, metrics=j_metrics(model_cfg.metric),
        debug_grads=debug_grads, **kw))
    j_before, _ = jax_to_torch_state({"params": v["params"]})

    def step(host_batch):
        arrays = {k: v for k, v in host_batch.items()
                  if k not in ("grid_shape", "batch_size")}
        state, stats = jstep(
            create_train_state(v["params"], v.get("constants"), tx),
            jax.tree_util.tree_map(jnp.asarray, arrays),
            jax.random.PRNGKey(0))
        after, _ = jax_to_torch_state({"params": state.params})
        return stats, {n: after[n] - j_before[n] for n in after}

    weights = port.state.model.state_dict()

    def port_step(host_batch, dtype=torch.float32):
        """The port's single-process update; in `dtype` (parameters and
        floating inputs) for the float64 reference."""
        single = _trainer(cfg_path, opts, task, model)
        single.state.model.load_state_dict(weights)
        single.state.model.to(dtype)
        share = _to_torch(_share(host_batch, 0, 1))
        for parent in (share, share["targets"]):
            for k, v in parent.items():
                if torch.is_tensor(v) and v.is_floating_point():
                    parent[k] = v.to(dtype)
        stats = single._train_step(single.state, share)[1]
        return stats, {n: p.detach() - weights[n] for n, p in
                       single.state.model.named_parameters()}

    if static_3d:
        batch["grid_shape"] = static["grid_shape"]
        batch["batch_size"] = static["batch_size"]
    return batch, weights, step, port_step


def _held_against_jax(got, weights, want, deltas, grad_tol, single,
                      param_tol=2e-3, single_tol=1e-3):
    """Rank 0's update `got` against JAX's (`want`, `deltas`) and against
    the port's single-process update of the same whole batch (`single`:
    stats, deltas), whose parameters it must match within `single_tol`
    (the ranks only sum in another order; at most 4.5e-4 seen at dp)."""
    from test_torch_modules import _rel_err

    stats = got["stats"][0]
    keys = [k for k in want if k.startswith("loss_")]
    assert sorted(keys) == sorted(k for k in stats if k.startswith("loss_"))
    for k in keys + ["total_loss", "num_boxes", "accuracy"]:
        assert _rel_err(stats[k], want[k]) <= 1e-4, k
    assert _rel_err(stats["grad_norm"], want["grad_norm"]) <= grad_tol
    assert stats["skipped"] == 0.0 and got["step"] == 1
    assert got["lrs"] == {"backbone": 1.0, "transformer": 10.0,
                          "deform": 10.0 * 0.1}
    update = {n: (p - weights[n]).numpy() for n, p in got["params"].items()}
    worst = max(_rel_err(u, deltas[n]) for n, u in update.items())
    assert worst <= param_tol, worst
    s_stats, s_deltas = single
    for k in keys + ["total_loss", "num_boxes", "accuracy", "grad_norm"]:
        assert _rel_err(stats[k], s_stats[k]) <= 1e-5, k
    worst = max(_rel_err(u, s_deltas[n].numpy()) for n, u in update.items())
    assert worst <= single_tol, worst


def _run_ranks_beside(fn, jax_work, *args, world=2):
    """The JAX side in a thread while `world` ranks run from this one (a
    spawned rank gets SIGINT when the thread that started it ends); the
    JAX side's failure raises here."""
    result = []

    def work():
        try:
            result.append(jax_work())
        except Exception as e:      # re-raised in the test's thread
            result.append(e)

    thread = threading.Thread(target=work)
    thread.start()
    try:
        _launch(fn, *args, world=world)
    finally:
        thread.join(TIMEOUT)
    assert not thread.is_alive() and len(result) == 1
    if isinstance(result[0], Exception):
        raise result[0]
    return result[0]


def _ranks_out(out_dir, world=2):
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.mark.parametrize("ipu", [1, 2], ids=["ipu1", "ipu2"])
def test_world2_update_matches_jax(coco7, tmp_path, ipu):
    """BoxeR-2D at a global batch of 2 x ipu: each rank 1 image a
    microbatch. At ipu 1 also a batch whose second image (rank 1's) has no
    valid target, and (AdamW, 2 updates) ZeRO-1 on against off and one
    rank's image non-finite."""
    cfg = _tiny(coco7, tmp_path, use_mask=False)
    opts = JAX_2D_OPTS + [f"training.batch_size={2 * ipu}",
                          f"training.iter_per_update={ipu}"]
    batch, weights, jax_step, port_step = _jax_update(cfg, opts, "detection",
                                                      "boxer2d")
    assert batch["image"].shape[:2] == (ipu, 2)
    empty = dict(batch, targets=dict(batch["targets"]))
    empty["targets"]["valid"] = batch["targets"]["valid"].copy()
    empty["targets"]["valid"][:, 1] = False
    runs = [{"tag": "update", "opts": opts}]
    if ipu == 1:
        adamw = JAX_2D_OPTS[:2] + ["training.batch_size=2",
                                   "training.run_type=train"]
        runs += [{"tag": "zero1", "opts": adamw, "steps": 2},
                 {"tag": "plain", "opts": adamw + ["distributed.zero1=false"],
                  "steps": 2},
                 {"tag": "nan", "opts": adamw, "nan_rank": 1}]
    tasks = {"update": batch}
    if ipu == 1:
        tasks["empty"] = empty
    outs = {}
    for name, b in tasks.items():
        path = tmp_path / f"{name}.pt"
        torch.save(dict(config=str(cfg), task="detection", model="boxer2d",
                        batch=b, weights=weights,
                        runs=runs if name == "update" else runs[:1]), path)
        out = tmp_path / name
        out.mkdir()
        want = _run_ranks_beside(_step_ranks, lambda b=b: jax_step(b),
                                 path, out)
        outs[name] = (_ranks_out(out), want)

    for name, (ranks, (want, deltas)) in outs.items():
        got = ranks[0]["update"]
        if name == "empty":
            assert want["num_boxes"] == float(batch["targets"]["valid"][
                :, 0].sum()) > 0
        _held_against_jax(got, weights, want, deltas, 1e-4,
                          port_step(tasks[name]))
        for n, p in ranks[1]["update"]["params"].items():
            assert torch.equal(p, got["params"][n]), n
    if ipu == 2:
        return
    ranks = outs["update"][0]
    zero, plain = ranks[0]["zero1"], ranks[0]["plain"]
    assert (zero["sharded"], plain["sharded"]) == (
        "ZeroRedundancyOptimizer", "AdamW")
    assert [s["total_loss"] for s in zero["stats"]] == [
        s["total_loss"] for s in plain["stats"]]
    assert all(torch.equal(p, plain["params"][n])
               for n, p in zero["params"].items())
    assert len(zero["optimizer"]["state"]) == len(zero["params"])
    assert _state_equal(zero["optimizer"], plain["optimizer"])
    assert ranks[1]["zero1"]["optimizer"] is None
    for r in ranks:
        nan = r["nan"]
        assert nan["stats"][0]["skipped"] == 1.0 and nan["step"] == 0
        assert not np.isfinite(nan["stats"][0]["grad_norm"])
        assert nan["optimizer"] is None or nan["optimizer"]["state"] == {}
        assert all(torch.equal(p, weights[n])
                   for n, p in nan["params"].items())


@pytest.fixture(scope="module")
def waymo7(tmp_path_factory):
    from test_torch_waymo import write_waymo_small

    return write_waymo_small(tmp_path_factory.mktemp("parallel_waymo"),
                             val=3)


@pytest.fixture
def two_pass_pfn(monkeypatch):
    """`test_torch_boxer3d.pfn_two_pass`: the JAX pillar net's GroupNorm
    with the two-pass variance."""
    from test_torch_boxer3d import _TwoPassLinen

    from boxer_tpu.nn import point_pillar

    monkeypatch.setattr(point_pillar, "nn", _TwoPassLinen())


@pytest.mark.usefixtures("two_pass_pfn")
@pytest.mark.parametrize("ipu", [1, 2], ids=["ipu1", "ipu2"])
def test_world2_update_3d_matches_jax(waymo7, tmp_path, ipu):
    """BoxeR-3D at a global batch of 2 x ipu frames, one frame a rank and
    microbatch, as `test_trainer_3d_update_matches_jax` (without the db
    sampler, which raises in the JAX package on 9-column boxes), whose
    tolerances hold at ipu 1. At ipu 2 the parameter updates are held at
    3e-3: on these 4 frames the port's own single-process f32 update is
    over 2e-3 from JAX's on one leaf (an encoder `linear_box_weight`), and
    JAX's f32 update is farther from the port's float64 update than the
    port's f32 one (held here, worst leaf against worst leaf): f32
    rounding of a piecewise gradient, as that test says, not a fault of
    data parallel. The world-2 update is held within 1e-3 of the
    single-process one in both cases."""
    from test_torch_modules import _rel_err
    from test_torch_trainer import waymo_opts

    opts = waymo_opts(waymo7, tmp_path / "save", db=False) + [
        "model_config.boxer3d.hidden_dim=64", "optimizer.type=sgd",
        "optimizer.params.lr=10.0", "optimizer.params.lr_backbone=1.0",
        "scheduler.params.use_warmup=false", "training.run_type=train",
        f"training.batch_size={2 * ipu}", f"training.iter_per_update={ipu}"]
    batch, weights, jax_step, port_step = _jax_update(
        WAYMO_CONFIG, opts, "detection3d", "boxer3d",
        jax_cfg_path=REPO / "boxer_tpu/config/Waymo-Detection/"
        "boxer3d_pointpillar.yaml", static_3d=True)
    assert batch["targets"]["valid"].shape[:2] == (ipu, 2)
    assert int(batch["targets"]["valid"].sum()) >= 4
    path = tmp_path / "task.pt"
    torch.save(dict(config=str(WAYMO_CONFIG), task="detection3d",
                    model="boxer3d", batch=batch, weights=weights,
                    runs=[{"tag": "update", "opts": opts}]), path)
    out = tmp_path / "out"
    out.mkdir()
    want, deltas = _run_ranks_beside(_step_ranks, lambda: jax_step(batch),
                                     path, out)
    ranks = _ranks_out(out)
    single = port_step(batch)
    _held_against_jax(ranks[0]["update"], weights, want, deltas, 2e-3,
                      single, 2e-3 if ipu == 1 else 3e-3)
    assert "loss_rad_enc_0" in want
    # the 3e-3 rests on this: JAX's f32 update is farther from the port's
    # float64 update than the port's own f32 update is
    exact = port_step(batch, torch.float64)[1]
    port_err = max(_rel_err(single[1][n].double().numpy(), exact[n].numpy())
                   for n in exact)
    jax_err = max(_rel_err(deltas[n], exact[n].numpy()) for n in exact)
    assert jax_err > port_err, (jax_err, port_err)
    for n, p in ranks[1]["update"]["params"].items():
        assert torch.equal(p, ranks[0]["update"]["params"][n]), n


# ---------------------------------------------------------------------------
# the trainer at world 2: checkpoint, resume, eval

def test_checkpoint_resume_and_eval_at_world2(coco7, tmp_path):
    cfg = _tiny(coco7, tmp_path)
    # a world-1 checkpoint at update 2, for the ranks to resume
    _trainer(cfg, ["training.run_type=train", "training.max_update=2",
                   "training.checkpoint_interval=2",
                   f"training.save_dir={tmp_path}/one_to_two"]).train()
    w1 = torch.load(tmp_path / "one_to_two/checkpoints/model_2.pth",
                    weights_only=True)
    _launch(_resume_ranks, cfg, tmp_path)
    ranks = _ranks_out(tmp_path)
    for r in ranks:
        step, params, opt = r["one_restored"]
        assert step == 2 and r["one_step"] == 3
        assert all(torch.equal(p, w1["model"][n]) for n, p in params.items())
    assert _state_equal(ranks[0]["one_restored"][2], w1["optimizer"])
    for r in ranks:
        assert r["steps"] == (4, 4) and r["position"] == (2, 0, 2)
        assert all(torch.equal(p, r["whole"][n])
                   for n, p in r["resumed"].items())
        assert all(torch.equal(p, ranks[0]["whole"][n])
                   for n, p in r["whole"].items())
    assert _state_equal(ranks[0]["whole_opt"], ranks[0]["resumed_opt"])
    assert ranks[1]["whole_opt"] is None

    # the files: one log, one checkpoint, the model's own keys and a plain
    # optimizer's state_dict
    whole = tmp_path / "whole"
    assert len(list(whole.glob("train_*.log"))) == 1
    assert sorted(os.listdir(whole / "checkpoints")) == ["model_4.pth"]
    ckpt = torch.load(tmp_path / "cut/checkpoints/model_2.pth",
                      weights_only=True)
    plain = _trainer(cfg, ["training.run_type=train"])
    assert sorted(ckpt["model"]) == sorted(plain.state.model.state_dict())
    want_groups = plain.state.optimizer.state_dict()["param_groups"]
    assert ckpt["optimizer"]["param_groups"] == [
        dict(g, lr=ckpt["optimizer"]["param_groups"][i]["lr"])
        for i, g in enumerate(want_groups)]
    assert sorted(ckpt["optimizer"]["state"]) == list(range(
        len(list(plain.state.model.parameters()))))
    assert ckpt["extra"]["world_size"] == 2 and "draw_states" not in \
        ckpt["extra"]

    # the world-2 checkpoint resumed at world 1, one more update
    os.makedirs(tmp_path / "one/checkpoints")
    shutil.copy(tmp_path / "cut/checkpoints/model_2.pth",
                tmp_path / "one/checkpoints")
    one = _trainer(cfg, ["training.run_type=train", "training.resume=true",
                         "training.max_update=3",
                         f"training.save_dir={tmp_path}/one"])
    assert one.state.step == 2 and (one.current_epoch,
                                    one.epoch_batches_done) == (0, 2)
    assert all(torch.equal(p, ckpt["model"][n])
               for n, p in one.state.model.state_dict().items())
    assert _state_equal(one.state.optimizer.state_dict(), ckpt["optimizer"])
    one.train()
    assert one.state.step == 3

    # val and test of the world-2 run's final weights at world 1 (batch 1,
    # as each rank's)
    evaluator = _trainer(cfg, ["training.run_type=val_test",
                               "training.batch_size=1",
                               f"training.save_dir={tmp_path}/w1"])
    evaluator.state.model.load_state_dict(
        torch.load(whole / "model_final", weights_only=True))
    val = evaluator.evaluate("val")
    assert {k: v.tolist() for k, v in val.items()} == ranks[0]["val"] == \
        ranks[1]["val"]
    evaluator.inference()
    got = json.loads((whole / "test_result.json").read_text())
    want = json.loads((tmp_path / "w1/test_result.json").read_text())
    assert sorted({r["image_id"] for r in got}) == list(range(1, 8))
    key = lambda r: (r["image_id"], r["score"], r["category_id"])
    assert sorted(got, key=key) == sorted(want, key=key)


@pytest.fixture(scope="module")
def waymo_run(waymo7, tmp_path_factory):
    from test_torch_trainer import waymo_opts

    root = tmp_path_factory.mktemp("parallel_waymo_run")
    opts = [o for o in waymo_opts(waymo7, None)
            if not o.startswith("training.max_update")]
    _launch(_waymo_ranks, opts, root)
    return opts, root, _ranks_out(root)


def _draws_equal(a, b):
    return sorted(a) == sorted(b) and all(
        torch.equal(o.cpu(), b[n][0].cpu()) and i == b[n][1]
        for n, (o, i) in a.items())


def test_waymo_trainer_at_world2(waymo_run):
    opts, root, ranks = waymo_run
    for r in ranks:
        assert all(torch.equal(p, r["whole"][n])
                   for n, p in r["resumed"].items())
        assert all(torch.equal(p, ranks[0]["whole"][n])
                   for n, p in r["whole"].items())
        assert _draws_equal(r["draws"], r["resumed_draws"])
    assert not _draws_equal(ranks[0]["draws"], ranks[1]["draws"])
    assert _state_equal(ranks[0]["whole_opt"], ranks[0]["resumed_opt"])

    ckpt = torch.load(root / "cut/checkpoints/model_2.pth",
                      weights_only=True)
    saved = ckpt["extra"]["draw_states"]
    assert len(saved) == 2
    for rank, r in enumerate(ranks):
        assert _draws_equal(r["restored"], saved[rank])
    tokens = [i["token"] for i in _trainer(
        WAYMO_CONFIG, opts + ["training.run_type=val",
                              f"training.save_dir={root}/val"],
        "detection3d", "boxer3d").datasets["val"].infos]
    assert len(tokens) == 3
    for name in ("whole/results.pkl", "test_results.pkl"):
        with open(root / name, "rb") as f:
            assert sorted(pickle.load(f)) == sorted(tokens), name


def test_waymo_checkpoint_of_two_ranks_refuses_one(waymo_run, tmp_path):
    opts, root, _ = waymo_run
    shutil.copytree(root / "cut", tmp_path / "cut")
    with pytest.raises(ValueError, match="draws of 2 data shards; this run has 1"):
        _trainer(WAYMO_CONFIG, opts + [
            "training.max_update=4", "training.run_type=train",
            "training.resume=true", f"training.save_dir={tmp_path}/cut"],
            "detection3d", "boxer3d")


# ---------------------------------------------------------------------------
# the loader's seeds, the helpers, the launcher

@pytest.mark.parametrize("replicas", [1, 2])
def test_loader_seeds(replicas):
    """One replica: the JAX loader's seeds (the batch's RandomState a
    scalar seed, its draws' [seed, 1]), bitwise as before; two: each
    rank's own, neither the one-replica seed."""
    from boxer_tpu_torch.dataset.helper.loader import DataLoader
    from boxer_tpu_torch.dataset.helper.sampler import DistributedSampler

    def loader(rank):
        sampler = DistributedSampler(8, num_replicas=replicas, rank=rank)
        sampler.set_epoch(3)
        return DataLoader(None, sampler, batch_size=2, seed=50511)

    def state(seed):
        return np.random.RandomState(seed).get_state()[1]

    seed = (50511 * 100003 + 5 * 1009 + 3) % 2 ** 32
    if replicas == 1:
        assert loader(0)._seed(5) == seed
        assert np.array_equal(state(loader(0)._seed(5, 1)), state([seed, 1]))
        return
    streams = [state(loader(r)._seed(5, *s)) for r in (0, 1) for s in
               ((), (1,))] + [state(seed), state([seed, 1])]
    assert all(not np.array_equal(a, b) for i, a in enumerate(streams)
               for b in streams[i + 1:])


def test_distributed_helpers(tmp_path):
    _launch(_helpers_ranks, tmp_path)
    ranks = _ranks_out(tmp_path)
    for rank, r in enumerate(ranks):
        assert (r["rank"], r["world"], r["master"], r["grouped"]) == (
            rank, 2, rank == 0, True)
        assert r["gathered"] == [{"r": 0}, {"r": 1}]
        assert r["gather"] == ([0, 10] if rank == 0 else [])
        assert r["scalar"] == 5 and r["mean"] == {"x": 0.5}
        assert r["total"] == {"x": 1.0}
        assert r["summed"] == [3.0] * 3 and r["broadcast"] == [2.0] * 3
    assert ranks[0]["seed"] == ranks[1]["seed"]


def test_launch_kills_ranks_past_timeout():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        _launch(_sleeping_ranks, 600, timeout=3)
    assert time.monotonic() - t0 < 60


def test_launch_raises_when_a_rank_fails():
    with pytest.raises(Exception, match="rank 1 fails"):
        _launch(_failing_ranks)


@pytest.mark.parametrize("threads,each", [(1, 1), (2, 1), (4, 2)])
def test_cpu_ranks_share_the_launchers_threads(tmp_path, threads, each):
    """Two CPU ranks take half the launching process's threads, at least
    one each, whatever the machine's core count."""
    with torch_threads.threads(threads):
        _launch(_threads_ranks, tmp_path)
    assert _ranks_out(tmp_path) == [each, each]


def test_worker_holds_its_thread_budget():
    """The CPUs this process may run on, shared among xdist's workers."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    want = max(1, len(os.sched_getaffinity(0)) // workers)
    assert torch.get_num_threads() == want
    assert os.environ["OMP_NUM_THREADS"] == str(want)
