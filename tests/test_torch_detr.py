"""DETR on the port (`models/detr.py`, `nn/transformer.py`, the softmax
label loss and matcher cost, the weight bridge, the CLI) against the JAX
package, on the CPU.

- Forward: a tiny DETR (r10, hidden 32 in 4 heads, 1 encoder and 2
  decoder layers, 12 queries, 7 classes) on a 64x96 image, weights from a
  numpy seed through the bridge (no leaf left over, no tensor unfilled),
  at mask=None: the training outputs (every decoder layer) and the
  inference outputs within rel err 1e-4 of JAX's.
- The padding mask: the port's `Transformer` given a mask M equals JAX's
  given ~M (JAX's own polarity: it turns the mask round twice and flax
  attends where its mask is True), within rel 1e-5; JAX's all-False mask
  differs from its `None` by more than 0.1 (the fault: no key attended),
  the port's all-False mask equals its `None` bitwise.
- The criterion on `tests/test_optim.py:101`'s case, and the softmax
  matcher's cost matrix and matches, against JAX's (rel 1e-5, matches
  equal), the label loss over 2 microbatches divided by iter_per_update.
- One train step against JAX's `make_train_step` (jitted, the file's one
  JAX step) at dropout 0 and mask=None, the tiny model on a batch of 2:
  every loss term within rel 1e-4, the pre-clip gradients within a
  worst-leaf rel err of 2e-3 (`tests/test_torch_train.py`'s tolerance).
- Scoring: the COCO dataset's `format_for_evalai` on DETR's num_classes +
  1 columns equals JAX's, the no-object column's picks included; JAX's
  `prepare_for_evaluation` raises KeyError on such a pick, the port's
  leaves it out.
- The CLI (`--model detr --device cpu`) from the shipped-config layout cut
  to the tiny model, at the config's dropout 0.1: 3 updates with a
  checkpoint each, val AP in [0, 1], test_result.json; a resume from the
  checkpoint replays update 3 bitwise (the dropout key is a function of
  the update index); without `--device cpu` on this card-less machine it
  exits "no CUDA device".
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget)
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_data import write_coco
from test_torch_matcher_losses import _tree
from test_torch_modules import _j, _rel_err, _t, random_variables
from test_torch_trainer import tiny_config

from boxer_tpu_torch.parallel.mesh import Axis
from boxer_tpu_torch.utils.weights import jax_to_torch_state, load_jax_params

REPO = Path(__file__).resolve().parents[1]
H, W = 64, 96
TINY = dict(num_classes=7, hidden_dim=32, nhead=4, enc_layers=1,
            dec_layers=2, dim_feedforward=64, num_queries=12,
            backbone_arch="resnet10")


def _models(dropout=0.0, image=None, seed=0):
    from boxer_tpu.models.detr import DETR as JDETR
    from boxer_tpu_torch.models.detr import DETR

    if image is None:
        image = np.random.RandomState(seed).randn(1, H, W, 3).astype(
            np.float32)
    jm = JDETR(**TINY, dropout=dropout)
    v = random_variables(jm, seed, jnp.asarray(image), None, train=False)
    tm = DETR(**TINY, dropout=dropout).eval()
    assert load_jax_params(tm, v) == ([], [])
    return jm, v, tm, image


def _outputs_close(got, want, tol):
    assert sorted(got) == sorted(want)
    for k in ("pred_logits", "pred_boxes"):
        assert _rel_err(got[k], want[k]) <= tol, k
    for g, w in zip(got.get("aux_outputs", []), want.get("aux_outputs", [])):
        for k in ("pred_logits", "pred_boxes"):
            assert _rel_err(g[k], w[k]) <= tol, k


def test_detr_forward_matches_jax():
    jm, v, tm, image = _models()
    for inference in (False, True):
        want = jax.jit(lambda v, x: jm.apply(
            v, x, None, train=False, inference=inference))(
            v, jnp.asarray(image))
        with torch.no_grad():
            got = tm(torch.from_numpy(image), None, inference=inference)
        assert got["pred_logits"].shape == (1, 12, 8)
        assert len(got.get("aux_outputs", [])) == (0 if inference else 1)
        _outputs_close(got, want, 1e-4)


def test_transformer_mask_polarity():
    from boxer_tpu.nn.transformer import Transformer as JTransformer
    from boxer_tpu_torch.nn.transformer import Transformer

    rs = np.random.RandomState(3)
    src = rs.randn(2, 3, 4, 16).astype(np.float32)
    pos = rs.randn(2, 3, 4, 16).astype(np.float32)
    query = rs.randn(5, 16).astype(np.float32)
    mask = np.zeros((2, 3, 4), bool)
    mask[1, :, 3:] = True
    mask[1, 2:] = True
    jm = JTransformer(16, 2, 1, 1, 32, dropout=0.0)
    args = (_j(src), _j(mask), _j(query), _j(pos))
    v = random_variables(jm, 4, *args, train=False)
    arrays, _ = jax_to_torch_state({"params": {"transformer": v["params"]}})
    tm = Transformer(16, 2, 1, 1, 32, dropout=0.0)
    tm.load_state_dict({k[len("transformer."):]: torch.from_numpy(a)
                        for k, a in arrays.items()}, strict=True)

    def jax_run(m):
        return np.asarray(jm.apply(v, _j(src), m, _j(query), _j(pos),
                                   train=False))

    def port_run(m):
        with torch.no_grad():
            return tm(_t(src), m, _t(query), _t(pos)).numpy()

    assert _rel_err(port_run(_t(mask)), jax_run(_j(~mask))) <= 1e-5
    none = np.zeros_like(mask)
    assert np.abs(jax_run(_j(none)) - jax_run(None)).max() > 0.1
    assert np.array_equal(port_run(_t(none)), port_run(None))


def _criterion_case():
    rng = np.random.RandomState(0)
    b, nq, nt, ncls = 2, 12, 4, 5
    outputs = {
        "pred_logits": rng.randn(b, nq, ncls + 1).astype(np.float32),
        "pred_boxes": (rng.rand(b, nq, 4) * 0.5 + 0.25).astype(np.float32),
        "aux_outputs": [{
            "pred_logits": rng.randn(b, nq, ncls + 1).astype(np.float32),
            "pred_boxes": (rng.rand(b, nq, 4) * 0.5 + 0.25).astype(
                np.float32)}],
    }
    targets = {"labels": rng.randint(0, ncls, (b, nt)).astype(np.int32),
               "boxes": (rng.rand(b, nt, 4) * 0.5 + 0.25).astype(np.float32),
               "valid": np.ones((b, nt), bool)}
    targets["valid"][1, 3] = False
    return outputs, targets, ncls


@pytest.mark.parametrize("ipu", [1, 2])
def test_detr_criterion_and_matcher_match_jax(ipu):
    from boxer_tpu.criterion.losses import DETRCriterion as JCrit
    from boxer_tpu.nn.matcher import HungarianMatcher as JMatcher
    from boxer_tpu_torch.criterion.losses import DETRCriterion
    from boxer_tpu_torch.nn.matcher import HungarianMatcher

    out, tgt, ncls = _criterion_case()
    jm, tm = JMatcher(1, 5, 2, focal_label=False), HungarianMatcher(
        1, 5, 2, focal_label=False)
    assert _rel_err(tm.cost_matrix(_tree(out, _t), _tree(tgt, _t)),
                    jm.cost_matrix(_tree(out, _j), _tree(tgt, _j))) <= 1e-5
    got_m, _ = tm(_tree(out, _t), _tree(tgt, _t))
    want_m, _ = jm(_tree(out, _j), _tree(tgt, _j))
    valid = tgt["valid"]
    np.testing.assert_array_equal(got_m.numpy()[valid],
                                  np.asarray(want_m)[valid])

    wd = {"loss_ce": 1.0, "loss_bbox": 5.0, "loss_giou": 2.0}
    jc = JCrit(ncls, jm, wd, ["boxes", "labels"], eos_coef=0.1,
               iter_per_update=ipu)
    tc = DETRCriterion(ncls, tm, wd, ["boxes", "labels"], eos_coef=0.1,
                       iter_per_update=ipu, dp=Axis())
    want = jc(_tree(out, _j), _tree(tgt, _j))
    got = tc(_tree(out, _t), _tree(tgt, _t))
    assert sorted(got) == sorted(want)
    assert "loss_ce_0" in got and "loss_giou_0" in got
    for k in got:
        if not k.startswith("_"):
            assert _rel_err(got[k], want[k]) <= 1e-5, k


def _batch(n=2, seed=5):
    from boxer_tpu_torch.dataset.synthetic import synthetic_batch

    batch = synthetic_batch(n, H, W, num_targets=5,
                            num_classes=TINY["num_classes"], seed=seed,
                            iter_per_update=1)
    batch.pop("mask")
    return batch


def test_detr_train_step_matches_jax():
    from boxer_tpu.criterion.losses import DETRCriterion as JCrit
    from boxer_tpu.nn.matcher import HungarianMatcher as JMatcher
    from boxer_tpu.optim import build_optimizer as j_optimizer
    from boxer_tpu.optim import build_schedule as j_schedule
    from boxer_tpu.parallel.steps import create_train_state, make_train_step
    from boxer_tpu_torch.criterion.losses import DETRCriterion
    from boxer_tpu_torch.nn.matcher import HungarianMatcher
    from boxer_tpu_torch.optim import build_optimizer, build_schedule
    from boxer_tpu_torch.parallel.steps import TrainState
    from boxer_tpu_torch.parallel.steps import \
        make_train_step as t_make_train_step
    from test_torch_train import OPTIM, SCHEDULE

    batch = _batch()
    jm, v, tm, _ = _models(image=batch["image"][0])
    wd = {"loss_ce": 1.0, "loss_bbox": 5.0, "loss_giou": 2.0}
    n = TINY["num_classes"]
    crit = JCrit(n, JMatcher(1, 5, 2), wd, ["boxes", "labels"],
                 eos_coef=0.1)
    tx, _ = j_optimizer(OPTIM, v["params"],
                        j_schedule(SCHEDULE, base_lr=2e-4))
    jstep = jax.jit(make_train_step(jm, crit, tx, max_norm=0.1,
                                    debug_grads=True))
    _, want = jstep(create_train_state(v["params"], v["constants"], tx),
                    jax.tree_util.tree_map(jnp.asarray, batch),
                    jax.random.PRNGKey(0))

    state = TrainState(tm, build_optimizer(OPTIM, tm),
                       build_schedule(SCHEDULE, base_lr=2e-4))
    step = t_make_train_step(
        DETRCriterion(n, HungarianMatcher(1, 5, 2, focal_label=False), wd,
                      ["boxes", "labels"], eos_coef=0.1, dp=Axis()),
        max_norm=0.1, debug_grads=True)
    _, got = step(state, {k: ({kk: torch.from_numpy(vv)
                               for kk, vv in val.items()}
                              if isinstance(val, dict)
                              else torch.from_numpy(val))
                          for k, val in batch.items()})
    keys = [k for k in want if k.startswith("loss_")]
    assert "loss_ce_0" in keys
    assert sorted(keys) == sorted(k for k in got if k.startswith("loss_"))
    for k in keys + ["total_loss", "grad_norm", "num_boxes"]:
        assert _rel_err(got[k], want[k]) <= 1e-4, k
    j_grads, _ = jax_to_torch_state({"params": want["_grads"]})
    assert sorted(j_grads) == sorted(got["_grads"])
    worst = max(_rel_err(got["_grads"][n].numpy(), j_grads[n])
                for n in j_grads)
    assert worst <= 2e-3, worst


def test_detr_scores_mirror_jax(tmp_path):
    """Sigmoid top-100 over every (query, column) pair, no-object column
    included, as JAX scores every head."""
    from boxer_tpu.dataset import build_dataset as j_dataset
    from boxer_tpu.utils.config import Configuration as JConfiguration
    from boxer_tpu_torch.dataset import build_dataset
    from boxer_tpu_torch.utils.config import Configuration

    root = write_coco(tmp_path / "coco")
    cfg_path = tmp_path / "exp.yaml"
    cfg_path.write_text(tiny_config(root, tmp_path / "save", use_mask=False))
    extra = {"task": "detection", "model": "boxer2d"}
    jds = j_dataset("detection", JConfiguration(
        str(cfg_path), extra=extra).get_config().dataset_config.detection,
        "val")
    tds = build_dataset("detection", Configuration(
        str(cfg_path), extra=extra, device="cpu").get_config()
        .dataset_config.detection, "val")
    n = tds.get_answer_size()
    rs = np.random.RandomState(2)
    logits = rs.randn(2, 40, n + 1).astype(np.float32)
    logits[..., n] += 1.5                  # no object scores high, as DETR's
    out = {"pred_logits": logits,
           "pred_boxes": rs.uniform(0.2, 0.6, (2, 40, 4)).astype(np.float32)}
    metas = [{"image_id": i + 1, "orig_size": (96, 128), "size": (96, 128)}
             for i in range(2)]
    want = jds.format_for_evalai(out, metas)
    got = tds.format_for_evalai(out, metas)
    picked = 0
    for i in want:
        np.testing.assert_array_equal(got[i]["labels"], want[i]["labels"])
        np.testing.assert_array_equal(got[i]["scores"], want[i]["scores"])
        np.testing.assert_allclose(got[i]["boxes"], want[i]["boxes"],
                                   rtol=1e-6)
        picked += int((want[i]["labels"] == n).sum())
    assert picked > 0
    with pytest.raises(KeyError):
        jds.prepare_for_evaluation(want)
    records = tds.prepare_for_evaluation(got)
    assert len(records) == 2 * 100 - picked
    cats = set(tds.label_to_cat_id.values())
    assert all(r["category_id"] in cats for r in records)


def tiny_detr_config(root, save_dir, dropout=0.1):
    """`tests/test_torch_trainer.py:tiny_config`'s data and training parts
    (segm off) with the shipped DETR model layout cut to the tiny model."""
    head, rest = tiny_config(root, save_dir, use_mask=False).split(
        "model_config:")
    return head + f"""model_config:
    detr:
        type: detr
        hidden_dim: 32
        aux_loss: true
        loss:
            type: detr
            params:
                class_loss_coef: 1
                bbox_loss_coef: 5
                giou_loss_coef: 2
                eos_coef: 0.1
                matcher:
                    type: hungarian
                    params:
                        class_weight: 1
                        bbox_weight: 5
                        giou_weight: 2
                        focal_label: false
        metric:
            - type: accuracy
              params: {{}}
        backbone:
            type: resnet10
            params:
                pretrained: false
                pretrained_path: null
                position_encoding: fixed
                return_interm_layers: [layer4]
                hidden_dim: 32
                ref_size: 4
        transformer:
            type: transformer
            params:
                hidden_dim: 32
                nhead: 4
                enc_layers: 1
                dec_layers: 2
                dim_feedforward: 64
                dropout: {dropout}
                num_queries: 12

""" + rest[rest.index("optimizer:"):]


def _cli(args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "boxer_tpu_torch.tools.run", "--task",
         "detection", "--model", "detr", *args], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)


def test_detr_cli_trains_and_resumes_bitwise(tmp_path):
    from boxer_tpu_torch.trainer import build_trainer
    from boxer_tpu_torch.utils.config import Configuration

    root = write_coco(tmp_path / "coco")
    cfg = tmp_path / "detr.yaml"
    cfg.write_text(tiny_detr_config(root, tmp_path / "save"))
    proc = _cli(["--config", str(cfg), "--device", "cpu",
                 "training.checkpoint_interval=1",
                 "training.num_checkpoint=3", "training.log_interval=1"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "update 3/3" in proc.stdout
    ap = [float(line.split("AP=")[1].split()[0])
          for line in proc.stdout.splitlines() if "val coco_eval_bbox" in line]
    assert len(ap) == 1 and 0.0 <= ap[0] <= 1.0
    save = tmp_path / "save"
    records = json.loads((save / "test_result.json").read_text())
    assert {r["image_id"] for r in records} <= set(range(1, 9))
    assert sorted(os.listdir(save / "checkpoints")) == [
        "model_1.pth", "model_2.pth", "model_3.pth"]

    cut = tmp_path / "cut" / "checkpoints"
    cut.mkdir(parents=True)
    shutil.copy(save / "checkpoints" / "model_2.pth", cut)
    configuration = Configuration(str(cfg), opts=[
        "training.run_type=train", "training.resume=true",
        f"training.save_dir={cut.parent}"],
        extra={"task": "detection", "model": "detr"}, device="cpu")
    trainer = build_trainer(configuration, device="cpu")
    trainer.load()
    assert trainer.current_update == 2
    assert trainer.state.model.transformer.encoder.layers[0].dropout.rate \
        == 0.1
    trainer.train()
    assert trainer.state.step == 3
    whole = torch.load(save / "checkpoints" / "model_3.pth",
                       weights_only=True)
    state = trainer.state.model.state_dict()
    assert sorted(state) == sorted(whole["model"])
    assert all(torch.equal(state[k], v) for k, v in whole["model"].items())


def test_detr_cli_without_card_refuses(tmp_path):
    cfg = tmp_path / "detr.yaml"
    cfg.write_text(tiny_detr_config(tmp_path / "coco", tmp_path / "save"))
    proc = _cli(["--config", str(cfg)])
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not os.path.exists(tmp_path / "save")
