"""The port's trainer and CLI (`boxer_tpu_torch.tools.run`) on the CPU, on
a synthetic on-disk COCO (`test_torch_data.write_coco`: 8 images, polygon
masks, non-contiguous category ids), with the tiny model of
`tests/test_trainer_e2e.py` on resnet10, segm (use_mask) unless said.

- The scenario of `tests/test_trainer_e2e.py`: 3 updates, the checkpoint
  at update 3, `model_final`, `config.yaml`, val bbox and segm AP in
  [0, 1], `test_result.json` with records of every test image, and a
  resumed trainer at update 3.
- Exact replay: updates stopped and resumed equal an uninterrupted run,
  parameters and optimizer state bitwise: mid-epoch (2 + 2 of 4, AdamW,
  multi-step) and at an epoch's end (4 + 2 of 6, SGD, a step schedule on
  the epoch clock, whose LR falls at the boundary).
- `training.jax_profile` writes a torch.profiler trace of updates 6-9.
- The CLI as a subprocess with `--device cpu` (rc 0, files written), and
  the same command without it, on this card-less machine: a non-zero exit
  with the "no CUDA device" error and nothing built. The layouts the
  port does not run raise NotImplementedError. Two CPU ranks
  through the CLI (`distributed.dp=2`), and more ranks than cards
  refused.
- BoxeR-3D (`--task detection3d`) from the shipped Waymo config, cut by
  dotlist to the tiny model of `tests/test_torch_boxer3d.py` (hidden 32)
  and to `tests/test_torch_waymo.py`'s generated frame directory (±5.12 m,
  9-column boxes, the port's GT database): 3 updates with the db sampler,
  the checkpoint at update 2, val metrics equal to `evaluate_results` of
  the port and of the JAX package on the records in `results.pkl` (one a
  frame), and `python -m boxer_tpu_torch.evaluate.waymo_eval` on them; an
  exact resume (3 + 2 of 5 updates, across an epoch) with the db
  sampler's draws; the CLI with `--device cpu`; and one update against
  JAX's step from the same yaml (without the db sampler, which raises in
  the JAX package on 9-column boxes), as for 2D below.
- One detection update against the JAX package's (the segm step and the
  segm batches are held against JAX in `test_torch_train.py` and
  `test_torch_data.py`; the detection step compiles in half the time): the
  port's trainer starts from the
  JAX model's seeded weights (`load_jax_params`) and takes its loader's
  first batch; the JAX step (`make_train_step`, jitted, with the same
  criterion, metrics, SGD and schedule from the same yaml) takes the JAX
  loader's first batch, which is the same. Loss terms, accuracy and the
  gradient norm within rel 1e-4, the LR exactly, and the parameter updates
  within a worst-leaf rel err of 2e-3 (`tests/test_torch_train.py`'s
  tolerance for the gradients; the first SGD step is linear in them). The
  LR is 10 (1 for the backbone) so that an update of the clipped gradient
  stands well above the f32 spacing of its parameter: at 0.01 the worst
  leaf's update is 7e-7 and one ulp of the parameter is 4e-3 of it.
  Hidden 64 in 2 heads, as there: with one channel a GroupNorm group, the
  input projections' conv biases have no gradient but rounding noise.
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget)
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_boxer3d import _spread, pfn_two_pass  # noqa: F401
from test_torch_data import write_coco
from test_torch_modules import _rel_err, random_variables
from test_torch_waymo import PC_RANGE, VOXEL_SIZE, write_waymo_small

REPO = Path(__file__).resolve().parents[1]


def tiny_config(root, save_dir, use_mask=True):
    """The tiny config of `tests/test_trainer_e2e.py` on resnet10, with a
    test split, segm by default."""
    mask = "true" if use_mask else "false"
    norm = """                        - type: to_tensor
                          params: {}
                        - type: normalize
                          params:
                              mean: [0.485, 0.456, 0.406]
                              std: [0.229, 0.224, 0.225]"""
    splits = "".join(f"""
            {s}:
                anno_file: {root}/{s}.json
                image_folder: {root}/images""" for s in ("train", "val", "test"))
    return f"""
training:
    batch_size: 2
    max_update: 3
    checkpoint_interval: 3
    evaluation_interval: 1000000
    log_interval: 1
    max_norm: 0.1
    run_type: train_val_test
    save_dir: {save_dir}
    seed: 7
    num_workers: 2
    mixed_precision: none

dataset_config:
    detection:
        use_mask: {mask}
        max_boxes: 8
        canvas_size: [128, 128]
        imdb_files:{splits}
        processors:
            image_train_processor:
                type: compose
                params:
                    preprocessors:
                        - type: random_horizontal_flip
                          params: {{prob: 0.5}}
                        - type: random_resize
                          params: {{min_size: 96, max_size: 128}}
{norm}
            image_test_processor:
                type: compose
                params:
                    preprocessors:
                        - type: random_resize
                          params: {{min_size: 96, max_size: 128}}
{norm}

model_config:
    boxer2d:
        type: boxer2d
        hidden_dim: 32
        aux_loss: true
        deform_lr_multi: 0.1
        use_mask: {mask}
        ref_size: 4
        loss:
            type: boxer2d
            params:
                bbox_loss_coef: 5
                giou_loss_coef: 2
                class_loss_coef: 2
                mask_loss_coef: 5
                dice_loss_coef: 5
                use_mask: {mask}
                matcher:
                    type: hungarian
                    params:
                        class_weight: 2
                        bbox_weight: 5
                        giou_weight: 2
                        focal_label: true
        metric:
            - type: accuracy
              params: {{}}
        backbone:
            type: resnet10
            params:
                pretrained: false
                pretrained_path: null
                position_encoding: fixed_box
                return_interm_layers: [layer2, layer3, layer4]
                hidden_dim: ${{model_config.boxer2d.hidden_dim}}
                ref_size: 4
        transformer:
            type: box_transformer
            params:
                hidden_dim: ${{model_config.boxer2d.hidden_dim}}
                nhead: 4
                nlevel: 4
                enc_layers: 1
                dec_layers: 2
                dim_feedforward: 64
                dropout: 0
                num_queries: 12
                use_mask: {mask}
                ref_size: 4
                residual_mode: v1

optimizer:
    type: adamw
    params:
        lr: 1.0e-4
        lr_backbone: 1.0e-5
        weight_decay: 1.0e-4

scheduler:
    type: multi_step
    params:
        use_warmup: false
        lr_steps: [1000]
        lr_ratio: 0.1
        mode: iter

distributed:
    dp: null
    mp: 1
    zero1: true
"""


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    return write_coco(tmp_path_factory.mktemp("torch_trainer_coco"))


def _config_path(coco_root, tmp_path, **kw):
    path = tmp_path / "exp.yaml"
    path.write_text(tiny_config(coco_root, tmp_path / "save", **kw))
    return str(path)


def _trainer(cfg_path, opts=()):
    from boxer_tpu_torch.trainer import build_trainer
    from boxer_tpu_torch.utils.config import Configuration

    configuration = Configuration(cfg_path, opts=list(opts), extra={
        "task": "detection", "model": "boxer2d"}, device="cpu")
    trainer = build_trainer(configuration, device="cpu")
    trainer.load()
    return trainer


def test_trainer_end_to_end(coco_root, tmp_path):
    save = tmp_path / "save"
    cfg = _config_path(coco_root, tmp_path)
    trainer = _trainer(cfg)
    assert trainer.num_classes == 3 and trainer.device.type == "cpu"
    stats = {}
    evaluate = trainer.evaluate
    trainer.evaluate = lambda split: stats.setdefault(split, evaluate(split))
    trainer.train()
    assert trainer.current_update == 3 == trainer.state.step
    assert trainer.checkpoint.latest_step() == 3
    assert os.path.exists(save / "model_final")
    assert os.path.exists(save / "config.yaml")
    for k in ("coco_eval_bbox", "coco_eval_segm"):
        assert 0.0 <= stats["val"][k][0] <= 1.0, (k, stats["val"][k])
    records = json.loads((save / "test_result.json").read_text())
    assert {r["image_id"] for r in records} == set(range(1, 9))
    assert all("segmentation" in r for r in records)
    final = torch.load(save / "model_final", weights_only=True)
    for n, p in trainer.state.model.state_dict().items():
        assert torch.equal(final[n], p), n

    trainer2 = _trainer(cfg, ["training.resume=true",
                              "training.max_update=4"])
    assert trainer2.current_update == 3 and trainer2.state.step == 3
    assert (trainer2.current_epoch, trainer2.epoch_batches_done) == (0, 3)


def _run(cfg, opts):
    trainer = _trainer(cfg, ["training.run_type=train"] + opts)
    trainer.train()
    return trainer


@pytest.mark.parametrize("stop,total,extra", [
    (2, 4, []),
    (4, 6, ["optimizer.type=sgd", "optimizer.params.momentum=0.9",
            "scheduler.type=step", "scheduler.params.mode=epoch",
            "scheduler.params.step_size=1", "scheduler.params.lr_ratio=0.5"]),
], ids=["mid_epoch_adamw", "epoch_end_sgd_step"])
def test_resume_replays_exactly(coco_root, tmp_path, stop, total, extra):
    """4 updates make an epoch (8 images, batch 2)."""
    cfg = _config_path(coco_root, tmp_path)
    whole = _run(cfg, extra + [f"training.max_update={total}",
                               f"training.save_dir={tmp_path}/whole"])
    _run(cfg, extra + [f"training.max_update={stop}",
                       f"training.checkpoint_interval={stop}",
                       f"training.save_dir={tmp_path}/cut"])
    resumed = _trainer(cfg, extra + [
        "training.run_type=train", "training.resume=true",
        f"training.max_update={total}", f"training.save_dir={tmp_path}/cut"])
    assert resumed.current_update == stop
    assert (resumed.current_epoch, resumed.epoch_batches_done) == divmod(
        stop, 4)
    resumed.train()
    assert resumed.state.step == whole.state.step == total
    assert resumed.current_epoch == whole.current_epoch
    a, b = whole.state.model.state_dict(), resumed.state.model.state_dict()
    assert all(torch.equal(a[n], b[n]) for n in a)
    oa = whole.state.optimizer.state_dict()
    ob = resumed.state.optimizer.state_dict()
    assert [g["lr"] for g in oa["param_groups"]] == [
        g["lr"] for g in ob["param_groups"]]
    for i, s in oa["state"].items():
        assert all(torch.equal(v, ob["state"][i][k]) for k, v in s.items())


def test_profile_window_writes_a_trace(coco_root, tmp_path):
    """`training.jax_profile` (the JAX key, kept) records updates 6-9 with
    torch.profiler into <dir>/trace.json."""
    cfg = _config_path(coco_root, tmp_path)
    trace = tmp_path / "trace"
    trainer = _run(cfg, ["training.max_update=9", "training.log_interval=5",
                         f"training.jax_profile={trace}"])
    assert trainer.state.step == 9
    events = json.loads((trace / "trace.json").read_text())["traceEvents"]
    assert sum(e.get("name") == "aten::addmm" for e in events) > 0


def _cli(args, tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "boxer_tpu_torch.tools.run", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def test_run_cli(coco_root, tmp_path):
    cfg = _config_path(coco_root, tmp_path)
    proc = _cli(["--config", cfg, "--task", "detection", "--model",
                 "boxer2d", "--device", "cpu", "training.max_update=2",
                 "training.run_type=train", "training.log_interval=1"],
                tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "update 2/2" in proc.stdout
    assert os.path.exists(tmp_path / "save" / "config.yaml")
    assert os.path.exists(tmp_path / "save" / "model_final")


def test_run_cli_without_card_refuses(coco_root, tmp_path):
    cfg = _config_path(coco_root, tmp_path)
    proc = _cli(["--config", cfg, "--task", "detection", "--model",
                 "boxer2d"], tmp_path)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not os.path.exists(tmp_path / "save")


def test_run_cli_two_cpu_ranks(coco_root, tmp_path):
    """`--device cpu distributed.dp=2`: two ranks over gloo, the global
    batch of 2 split into one image a rank; rank 0 writes one log, one
    checkpoint and a test_result.json whose records cover every test image
    once (the ranks' records gathered)."""
    from collections import Counter

    cfg = _config_path(coco_root, tmp_path)
    proc = _cli(["--config", cfg, "--task", "detection", "--model",
                 "boxer2d", "--device", "cpu", "distributed.dp=2",
                 "training.max_update=2", "training.checkpoint_interval=2",
                 "training.log_interval=1"], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ranks=2" in proc.stdout and "update 2/2" in proc.stdout
    save = tmp_path / "save"
    assert len(list(save.glob("train_*.log"))) == 1
    assert os.listdir(save / "checkpoints") == ["model_2.pth"]
    per_image = Counter(r["image_id"] for r in json.loads(
        (save / "test_result.json").read_text()))
    assert sorted(per_image) == list(range(1, 9))
    assert len(set(per_image.values())) == 1


def test_run_refuses_more_ranks_than_cards(coco_root, tmp_path, monkeypatch):
    """`distributed.dp=2` on cuda with one card raises before anything is
    spawned or built (the card count patched: this machine has none)."""
    from boxer_tpu_torch.tools import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(RuntimeError, match="2 processes .* 1 CUDA cards"):
        run.run(["--config", _config_path(coco_root, tmp_path), "--task",
                 "detection", "--model", "boxer2d", "distributed.dp=2"])
    assert not os.path.exists(tmp_path / "save")


@pytest.mark.parametrize("model", ["boxer3d", "detr"],
                         ids=["boxer3d_sp2", "detr_sp2"])
def test_unported_layouts_raise(coco_root, tmp_path, model):
    """distributed.sp=2 on BoxeR-3D and on DETR raises before anything is
    built, as the JAX package rejects `seq_shard` for them (its BoxeR-3D's
    and DETR's `from_config` take none)."""
    from boxer_tpu_torch.trainer import build_trainer
    from boxer_tpu_torch.utils.config import Configuration

    cfg = (REPO / "boxer_tpu_torch/config/Waymo-Detection/"
           "boxer3d_pointpillar.yaml" if model == "boxer3d" else
           REPO / "boxer_tpu_torch/config/COCO-Detection/detr_r50.yaml")
    configuration = Configuration(
        str(cfg), opts=["distributed.sp=2"],
        extra={"task": "detection3d" if model == "boxer3d" else "detection",
               "model": model}, device="cpu")
    with pytest.raises(ValueError, match=f"{model} has no sequence "
                       "parallelism"):
        build_trainer(configuration, device="cpu")


def test_trainer_update_matches_jax(coco_root, tmp_path):
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

    opts = ["model_config.boxer2d.hidden_dim=64",
            "model_config.boxer2d.transformer.params.nhead=2",
            "optimizer.type=sgd", "optimizer.params.lr=10.0",
            "optimizer.params.lr_backbone=1.0",
            "scheduler.type=step", "scheduler.params.mode=epoch",
            "scheduler.params.step_size=1", "training.run_type=train"]
    cfg_path = _config_path(coco_root, tmp_path, use_mask=False)
    trainer = _trainer(cfg_path, opts)

    cfg = JConfiguration(cfg_path, opts=opts, extra={
        "task": "detection", "model": "boxer2d"}).get_config()
    model_cfg = cfg.model_config.boxer2d
    dataset = j_dataset("detection", cfg.dataset_config.detection, "train")
    loader = j_loader(dataset, "train", batch_size=2, num_workers=1,
                      seed=trainer.seed)
    j_batch = next(iter(loader))
    j_batch.pop("meta")
    t_batch = next(iter(trainer.loaders["train"]))
    t_batch.pop("meta")
    assert np.abs(t_batch["image"].numpy() - j_batch["image"]).max() <= 1e-6
    for k, v in j_batch["targets"].items():
        assert np.array_equal(t_batch["targets"][k].numpy(), v), k

    jm = j_model(model_cfg, dataset.get_answer_size())
    v = random_variables(jm, 0, jnp.asarray(j_batch["image"][0]),
                         jnp.asarray(j_batch["mask"][0]), train=False)
    assert load_jax_params(trainer.state.model, v) == ([], [])
    opt_cfg = cfg.optimizer.to_dict()
    opt_cfg["params"]["deform_lr_multi"] = model_cfg.deform_lr_multi
    sched_cfg = cfg.scheduler.to_dict()
    sched_cfg["params"]["_steps_per_epoch"] = len(loader)
    tx, _ = j_optimizer(opt_cfg, v["params"],
                        j_schedule(sched_cfg, opt_cfg["params"]["lr"]))
    jstep = jax.jit(make_train_step(
        jm, j_loss(model_cfg.loss, dataset.get_answer_size()), tx,
        max_norm=0.1, metrics=j_metrics(model_cfg.metric)))
    jstate, want = jstep(create_train_state(v["params"], v["constants"], tx),
                         jax.tree_util.tree_map(jnp.asarray, j_batch),
                         jax.random.PRNGKey(0))

    before = {n: p.detach().clone()
              for n, p in trainer.state.model.named_parameters()}
    _, got = trainer._train_step(trainer.state, t_batch)
    keys = [k for k in want if k.startswith("loss_")]
    assert sorted(keys) == sorted(k for k in got if k.startswith("loss_"))
    for k in keys + ["total_loss", "grad_norm", "num_boxes", "accuracy"]:
        assert _rel_err(got[k], want[k]) <= 1e-4, k
    assert got["skipped"] == 0.0 and trainer.state.step == 1
    base = {"backbone": 1.0, "transformer": 10.0, "deform": 10.0 * 0.1}
    assert {g["name"]: g["lr"] for g in trainer.state.optimizer.param_groups
            } == base

    j_params, _ = jax_to_torch_state({"params": jstate.params})
    j_before, _ = jax_to_torch_state({"params": v["params"]})
    assert sorted(j_params) == sorted(before)
    worst = max(_rel_err(
        (p.detach() - before[n]).numpy(), j_params[n] - j_before[n])
        for n, p in trainer.state.model.named_parameters())
    assert worst <= 2e-3, worst


# ---------------------------------------------------------------------------
# BoxeR-3D from a Waymo frame directory

WAYMO_CONFIG = "Waymo-Detection/boxer3d_pointpillar.yaml"


@pytest.fixture(scope="module")
def waymo_root(tmp_path_factory):
    return write_waymo_small(tmp_path_factory.mktemp("torch_trainer_waymo"))


def waymo_opts(root, save_dir, db=True):
    """Dotlist cuts of the shipped Waymo config: the generated directory
    (val and test on the val frames, every one of them), its range and
    512 voxels of 8 points a frame, 40 boxes, the tiny model, batch 2, 3
    updates, a checkpoint every 2, f32."""
    ds = "dataset_config.detection3d"
    m = "model_config.boxer3d"
    splits = [f"{ds}.imdb_files.{s}.{k}={v}"
              for s, info in (("train", "train"), ("val", "val"),
                              ("test", "val"))
              for k, v in (("root_path", root),
                           ("info_path", f"{root}/infos/infos_{info}.pkl"),
                           ("load_interval", 1))]
    db_path = (f"{root}/infos/dbinfos_infos_train.pkl" if db else None)
    db_opt = (f"{ds}.imdb_files.train.db_sampler.db_info_path={db_path}"
              if db else f"{ds}.imdb_files.train.db_sampler=None")
    vox = "params.preprocessors[{}].params".format
    return splits + [db_opt] + [
        f"{ds}.pc_range={PC_RANGE}", f"{ds}.voxel_size={VOXEL_SIZE}",
        f"{ds}.max_boxes=40",
        f"{ds}.processors.train_processor.{vox(5)}.max_voxel_num=512",
        f"{ds}.processors.train_processor.{vox(5)}.max_points_per_voxel=8",
        f"{ds}.processors.test_processor.{vox(1)}.max_voxel_num=512",
        f"{ds}.processors.test_processor.{vox(1)}.max_points_per_voxel=8",
        f"{m}.hidden_dim=32",
        f"{m}.backbone.params.reader.num_filters=[16,32]",
        f"{m}.backbone.params.neck.num_layers=[1,1,1]",
        f"{m}.backbone.params.neck.ds_filters=[32,64,64]",
        f"{m}.transformer.params.enc_layers=1",
        f"{m}.transformer.params.dim_feedforward=64",
        f"{m}.transformer.params.num_queries=60",
        "training.batch_size=2", "training.max_update=3",
        "training.checkpoint_interval=2", "training.log_interval=1",
        "training.run_type=train_val_test", f"training.save_dir={save_dir}",
        "training.seed=7", "training.num_workers=2",
        "training.mixed_precision=none"]


def _trainer_3d(opts):
    from boxer_tpu_torch.trainer import build_trainer
    from boxer_tpu_torch.utils.config import Configuration

    configuration = Configuration(
        str(REPO / "boxer_tpu_torch" / "config" / WAYMO_CONFIG),
        opts=list(opts), extra={"task": "detection3d", "model": "boxer3d"},
        device="cpu")
    trainer = build_trainer(configuration, device="cpu")
    trainer.load()
    return trainer


def _as_seven_columns(records):
    return {t: dict(r, boxes3d=np.concatenate(
        [r["boxes3d"][:, :6], r["boxes3d"][:, -1:]], 1))
        for t, r in records.items()}


def test_trainer_3d_end_to_end(waymo_root, tmp_path):
    import pickle

    from boxer_tpu.evaluate.waymo_eval import evaluate_results as j_eval
    from boxer_tpu_torch.evaluate.waymo_eval import evaluate_results

    save = tmp_path / "save"
    trainer = _trainer_3d(waymo_opts(waymo_root, save))
    assert trainer.num_classes == 5 and trainer.device.type == "cpu"
    assert trainer.datasets["train"].db_sampler is not None
    stats = {}
    evaluate = trainer.evaluate
    trainer.evaluate = lambda split: stats.setdefault(split, evaluate(split))
    trainer.train()
    assert trainer.current_update == 3 == trainer.state.step
    assert trainer.checkpoint.latest_step() == 2
    for f in ("config.yaml", "model_final", "checkpoints/model_2.pth"):
        assert os.path.exists(save / f), f
    with open(save / "results.pkl", "rb") as f:
        records = pickle.load(f)
    tokens = [i["token"] for i in trainer.datasets["val"].infos]
    assert sorted(records) == sorted(tokens) and len(tokens) == 2
    for r in records.values():
        assert r["pred_boxes3d"].shape == (125, 7)
        assert r["boxes3d"].shape[1] == 9
    metrics = stats["val"]
    assert metrics == evaluate_results(records)
    assert metrics == j_eval(_as_seven_columns(records))
    assert len(metrics) >= 4 and all(np.isfinite(v) for v in
                                     metrics.values())
    proc = subprocess.run(
        [sys.executable, "-m", "boxer_tpu_torch.evaluate.waymo_eval",
         "--result", str(save / "results.pkl")], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.splitlines() == [f"{k}: {v}"
                                        for k, v in metrics.items()]

    resumed = _trainer_3d(waymo_opts(waymo_root, save) + [
        "training.resume=true", "training.max_update=4"])
    assert resumed.current_update == 2 and resumed.state.step == 2
    assert (resumed.current_epoch, resumed.epoch_batches_done) == (1, 0)
    assert resumed.loaders["train"].draw_state is not None

    # how a trained model is evaluated: the checkpoint (which carries the
    # db sampler's draws) into a run with no train loader
    evaluator = _trainer_3d(waymo_opts(waymo_root, save) + [
        "training.resume=true", "training.run_type=val"])
    assert "train" not in evaluator.loaders and evaluator.state.step == 2
    assert evaluator.evaluate("val") == resumed.evaluate("val")


def _run_3d(root, opts):
    trainer = _trainer_3d(waymo_opts(root, None) + ["training.run_type=train"]
                          + opts)
    trainer.train()
    return trainer


def test_resume_3d_replays_exactly(waymo_root, tmp_path):
    """2 updates make an epoch (4 frames, batch 2): 3 updates, then 2 after
    a resume, equal 5 uninterrupted ones bitwise, parameters, optimizer
    state and the db sampler's draws."""
    whole = _run_3d(waymo_root, ["training.max_update=5",
                                 f"training.save_dir={tmp_path}/whole"])
    _run_3d(waymo_root, ["training.max_update=3",
                         "training.checkpoint_interval=3",
                         f"training.save_dir={tmp_path}/cut"])
    resumed = _trainer_3d(waymo_opts(waymo_root, None) + [
        "training.run_type=train", "training.resume=true",
        "training.max_update=5", f"training.save_dir={tmp_path}/cut"])
    assert (resumed.current_update, resumed.current_epoch,
            resumed.epoch_batches_done) == (3, 1, 1)
    resumed.train()
    assert resumed.state.step == whole.state.step == 5
    a, b = whole.state.model.state_dict(), resumed.state.model.state_dict()
    assert all(torch.equal(a[n], b[n]) for n in a)
    oa = whole.state.optimizer.state_dict()
    ob = resumed.state.optimizer.state_dict()
    for i, s in oa["state"].items():
        assert all(torch.equal(v, ob["state"][i][k]) for k, v in s.items())
    da = whole.loaders["train"].draw_state
    db = resumed.loaders["train"].draw_state
    assert sorted(da) == sorted(db)
    for name, (order, idx) in da.items():
        assert torch.equal(order, db[name][0]) and idx == db[name][1]
    assert da["VEHICLE"][1] > 0 and da["PEDESTRIAN"][1] > 0


def test_run_cli_3d(waymo_root, tmp_path):
    proc = _cli(["--config", str(REPO / "boxer_tpu_torch" / "config" /
                                 WAYMO_CONFIG),
                 "--task", "detection3d", "--model", "boxer3d",
                 "--device", "cpu", *waymo_opts(waymo_root, tmp_path / "save"),
                 "training.max_update=2"], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "update 2/2" in proc.stdout
    assert "val VEHICLE_LEVEL_1_AP" in proc.stdout
    for f in ("config.yaml", "model_final", "results.pkl"):
        assert os.path.exists(tmp_path / "save" / f), f


@pytest.mark.usefixtures("pfn_two_pass")
def test_trainer_3d_update_matches_jax(waymo_root, tmp_path):
    """One BoxeR-3D update of the port's trainer against the JAX step from
    the same yaml and dotlist, on the loaders' first batch (equal), from
    the JAX model's seeded weights with the sampling offsets spread (as
    `tests/test_torch_boxer3d.py` does): loss terms and accuracy within
    rel 1e-4, the LRs exactly (the cosine schedule's first step, no
    warmup); the gradient norm and the parameter updates (SGD at LR 10, 1
    for the backbone, as the 2D case) within the gradients' tolerance of
    that file, 2e-3. On a loader's frames the gradient is piecewise: a
    pillar's max over its points and the sampling's pixel floor switch
    under rounding, so the two frameworks' f32 steps differ there by more
    than their losses do. Hidden 64 in 8 heads: with one
    channel a GroupNorm group, the input projections' conv biases have no
    gradient but rounding noise."""
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

    opts = waymo_opts(waymo_root, tmp_path / "save", db=False) + [
        "model_config.boxer3d.hidden_dim=64", "optimizer.type=sgd", "optimizer.params.lr=10.0",
        "optimizer.params.lr_backbone=1.0",
        "scheduler.params.use_warmup=false", "training.run_type=train"]
    trainer = _trainer_3d(opts)

    cfg = JConfiguration(str(REPO / "boxer_tpu" / "config" / WAYMO_CONFIG),
                         opts=opts, extra={"task": "detection3d",
                                           "model": "boxer3d"}).get_config()
    model_cfg = cfg.model_config.boxer3d
    dataset = j_dataset("detection3d", cfg.dataset_config.detection3d,
                        "train")
    loader = j_loader(dataset, "train", batch_size=2, num_workers=1,
                      seed=trainer.seed)
    j_batch = next(iter(loader))
    j_batch.pop("meta")
    static = {k: j_batch.pop(k) for k in ("grid_shape", "batch_size")}
    t_batch = next(iter(trainer.loaders["train"]))
    t_batch.pop("meta")
    assert (t_batch["grid_shape"], t_batch["batch_size"]) == (
        static["grid_shape"], static["batch_size"]) == ((32, 32), 2)
    for k in ("voxels", "coordinates", "num_points_per_voxel"):
        assert np.array_equal(t_batch[k].numpy(), j_batch[k]), k
    for k, v in j_batch["targets"].items():
        assert np.array_equal(t_batch["targets"][k].numpy(), v), k
    assert int(j_batch["targets"]["valid"].sum()) >= 4

    jm = j_model(model_cfg, dataset.get_answer_size())
    v = _spread(random_variables(
        jm, 0, *(jnp.asarray(j_batch[k][0]) for k in (
            "voxels", "coordinates", "num_points_per_voxel")),
        static["grid_shape"], 2, train=False))
    assert load_jax_params(trainer.state.model, v) == ([], [])
    opt_cfg = cfg.optimizer.to_dict()
    opt_cfg["params"]["deform_lr_multi"] = model_cfg.deform_lr_multi
    sched_cfg = cfg.scheduler.to_dict()
    sched_cfg["params"]["_steps_per_epoch"] = len(loader)
    tx, _ = j_optimizer(opt_cfg, v["params"],
                        j_schedule(sched_cfg, opt_cfg["params"]["lr"]))
    jstep = jax.jit(make_train_step(
        jm, j_loss(model_cfg.loss, dataset.get_answer_size()), tx,
        max_norm=1.0, metrics=j_metrics(model_cfg.metric), static=static))
    jstate, want = jstep(create_train_state(v["params"], None, tx),
                         jax.tree_util.tree_map(jnp.asarray, j_batch),
                         jax.random.PRNGKey(0))

    before = {n: p.detach().clone()
              for n, p in trainer.state.model.named_parameters()}
    _, got = trainer._train_step(trainer.state, t_batch)
    keys = [k for k in want if k.startswith("loss_")]
    assert "loss_rad_enc_0" in keys
    assert sorted(keys) == sorted(k for k in got if k.startswith("loss_"))
    for k in keys + ["total_loss", "num_boxes", "accuracy"]:
        assert _rel_err(got[k], want[k]) <= 1e-4, k
    assert _rel_err(got["grad_norm"], want["grad_norm"]) <= 2e-3
    assert got["skipped"] == 0.0 and trainer.state.step == 1
    base = {"backbone": 1.0, "transformer": 10.0, "deform": 10.0 * 0.1}
    assert {g["name"]: g["lr"] for g in trainer.state.optimizer.param_groups
            } == base

    j_params, _ = jax_to_torch_state({"params": jstate.params})
    j_before, _ = jax_to_torch_state({"params": v["params"]})
    assert sorted(j_params) == sorted(before)
    worst = max(_rel_err(
        (p.detach() - before[n]).numpy(), j_params[n] - j_before[n])
        for n, p in trainer.state.model.named_parameters())
    assert worst <= 2e-3, worst
