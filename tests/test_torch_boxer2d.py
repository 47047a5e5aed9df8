"""The whole inference slice: the port's BoxeR2D against the JAX package's
on the same weights, plus the weight bridges in both directions and the
port's import hygiene.

A tiny model (r10, hidden 32, 1 encoder and 2 decoder layers, 16 queries)
on a 64x96 canvas, f32 on the CPU, weights from a numpy seed (none zero, so
the ~128 proposal logits do not tie). Held: the encoder's proposal logits
(rel err <= 1e-4) and the selected proposal indices (exactly equal), then
scores within atol 1e-4, boxes within atol 1e-4 of the canvas size (the
pixel values reach ~100, where f32 noise alone is ~1e-5), identical labels,
and fewer than 1e-3 of mask pixels different. The same holds with the
JAX package under its m-major combine (its XLA formulation on the CPU),
against the port's one inference route, K9's plain version.
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget)
import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_modules import _rel_err, random_variables

from boxer_tpu_torch.utils.weights import load_jax_params

H, W = 64, 96
TINY = dict(num_classes=7, hidden_dim=32, nhead=4, num_level=4, enc_layers=1,
            dec_layers=2, dim_feedforward=64, num_queries=16,
            backbone_arch="resnet10")
POST = {"canvas_hw": (H, W), "topk": 10}


def _inputs(padded: bool):
    rs = np.random.RandomState(0)
    image = rs.randn(1, H, W, 3).astype(np.float32)
    mask = np.zeros((1, H, W), bool)
    if padded:
        mask[:, 48:, :] = True
        mask[:, :, 72:] = True
    return image, mask


def _models(use_mask, residual_mode, image, mask):
    from boxer_tpu.models.boxer2d import BoxeR2D as JaxBoxeR2D
    from boxer_tpu_torch.models.boxer2d import BoxeR2D

    kw = dict(TINY, use_mask=use_mask, residual_mode=residual_mode)
    jm = JaxBoxeR2D(**kw)
    v = random_variables(jm, 0, jnp.asarray(image), jnp.asarray(mask),
                         train=False)
    tm = BoxeR2D(**kw).eval()
    unused, unfilled = load_jax_params(tm, v)
    assert unused == [] and unfilled == []
    return jm, v, tm


def _spy_proposals(tm):
    """Record what the port's proposal selection saw and chose."""
    rec = {}
    orig = tm.transformer._get_enc_proposals

    def spy(enc_detector, output, src_mask, ref_windows):
        res = orig(enc_detector, output, src_mask, ref_windows)
        valid = ((ref_windows[..., :2] > 0.01)
                 & (ref_windows[..., :2] < 0.99)).all(-1)
        rec["mask"] = ~valid if src_mask is None else src_mask | ~valid
        rec["embed"], rec["indexes"] = res[0], res[3]
        return res

    tm.transformer._get_enc_proposals = spy
    tm.enc_detector.class_embed.register_forward_hook(
        lambda mod, inp, out: rec.__setitem__("logits", out[..., 0]))
    return rec


def _compare_outputs(got, want):
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(want["labels"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                               rtol=0, atol=1e-4)
    scale = np.array([W, H, W, H], np.float32)
    np.testing.assert_allclose(got["boxes"].numpy() / scale,
                               np.asarray(want["boxes"]) / scale,
                               rtol=0, atol=1e-4)
    if "masks" in want:
        assert got["masks"].shape == want["masks"].shape
        assert np.mean(got["masks"].numpy() != np.asarray(want["masks"])) < 1e-3


def _boxer2d_matches_jax(use_mask, residual_mode, padded):
    from boxer_tpu.nn.predictor import NEG_INF

    image, mask = _inputs(padded)
    jm, v, tm = _models(use_mask, residual_mode, image, mask)
    # jitted: one compile of the tiny model is ~6x faster than eager ops
    want, state = jax.jit(lambda v, x, m: jm.apply(
        v, x, m, train=False, inference=True, postprocess=POST,
        mutable=["intermediates"],
        capture_intermediates=lambda mdl, _: mdl.name in ("class_embed",
                                                          "enc_norm")))(
        v, jnp.asarray(image), jnp.asarray(mask))
    inter = state["intermediates"]["transformer"]
    rec = _spy_proposals(tm)
    with torch.no_grad():
        got = tm(torch.from_numpy(image), torch.from_numpy(mask),
                 postprocess=POST)

    # encoder output before the top-k, then the selected proposals
    j_logits = inter["enc_detector"]["class_embed"]["__call__"][0][..., 0]
    assert _rel_err(rec["logits"], j_logits) <= 1e-4
    masked = jnp.where(jnp.asarray(rec["mask"].numpy()), NEG_INF,
                       j_logits.astype(jnp.float32))
    _, j_idx = jax.lax.top_k(masked, TINY["num_queries"])
    np.testing.assert_array_equal(rec["indexes"].numpy(), np.asarray(j_idx))
    assert _rel_err(rec["embed"], inter["enc_norm"]["__call__"][0]) <= 1e-4

    assert set(got) == set(want)
    _compare_outputs(got, want)


@pytest.mark.parametrize("use_mask,residual_mode,padded", [
    (True, "v1", True),      # segm + deferred mask decode, padding mask
    (True, "v2", False),     # segm, the other residual mode, no padding
    (False, "v1", True),     # detection only
], ids=["segm-v1-padded", "segm-v2", "det-padded"])
def test_boxer2d_matches_jax(use_mask, residual_mode, padded):
    _boxer2d_matches_jax(use_mask, residual_mode, padded)


@pytest.mark.parametrize("use_mask", [True, False], ids=["segm", "det"])
def test_boxer2d_mmajor_combine_matches_jax(monkeypatch, use_mask):
    """The JAX package under its m-major combine against the port's one
    inference route: one K9 call (its plain version) for the encoder layer
    and for each decoder layer but a segm model's last (its dual-output
    instance attention is K4's), and not one K8 call at model level."""
    tb = importlib.import_module("boxer_tpu_torch.ops.box_attention")
    cr = importlib.import_module("boxer_tpu_torch.ops.combine_reduce")

    monkeypatch.setattr(importlib.import_module("boxer_tpu.ops.box_attention"),
                        "_COMBINE_IMPL", "mmajor")
    calls = []
    for mod, name in ((tb, "box_sample_reduce"),
                      (cr, "quad_sample_reduce_mmajor"),
                      (cr, "quad_sample_reduce_mmajor_plain")):
        monkeypatch.setattr(mod, name, lambda *a, f=getattr(mod, name), n=name:
                            calls.append(n) or f(*a))
    _boxer2d_matches_jax(use_mask, "v1", padded=True)
    assert calls == ["box_sample_reduce"] * (
        TINY["enc_layers"] + TINY["dec_layers"] - use_mask)


def test_port_weights_load_into_jax_model():
    """The reverse bridge: the port's state_dict through the JAX package's
    own reference-checkpoint loader (`apply_boxer2d_weights`) fills every
    JAX leaf, and the JAX model then gives the port's outputs."""
    from boxer_tpu.models.boxer2d import BoxeR2D as JaxBoxeR2D
    from boxer_tpu.utils.torch_port import apply_boxer2d_weights
    from boxer_tpu_torch.models.boxer2d import BoxeR2D

    image, mask = _inputs(True)
    kw = dict(TINY, use_mask=True)
    tm = BoxeR2D(**kw).init_weights(seed=3).eval()
    rs = np.random.RandomState(4)
    with torch.no_grad():          # spread the zero-initialised heads
        for name, p in tm.named_parameters():
            if name.endswith(("linear_box_weight", "linear_attn_weight",
                              "class_embed.bias")):
                p.add_(torch.from_numpy(
                    rs.randn(*p.shape).astype(np.float32) * 0.05))
    jm = JaxBoxeR2D(**kw)
    template = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(image), jnp.asarray(mask),
        train=False))
    v, unmatched = apply_boxer2d_weights(
        dict(template), tm.state_dict(), TINY["enc_layers"])
    assert unmatched == []
    leaves = jax.tree_util.tree_leaves(v)
    assert all(isinstance(x, jax.Array) for x in leaves), "unfilled JAX leaf"

    want = jax.jit(lambda v, x, m: jm.apply(
        v, x, m, train=False, inference=True, postprocess=POST))(
        v, jnp.asarray(image), jnp.asarray(mask))
    with torch.no_grad():
        got = tm(torch.from_numpy(image), torch.from_numpy(mask),
                 postprocess=POST)
    _compare_outputs(got, want)


def test_port_imports_no_jax():
    """Importing every module of the port leaves jax and the JAX package
    out of the process."""
    code = (
        "import pkgutil, importlib, sys, boxer_tpu_torch\n"
        "for m in pkgutil.walk_packages(boxer_tpu_torch.__path__, "
        "'boxer_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith("
        "('jax.', 'jaxlib', 'flax')) or n == 'boxer_tpu' "
        "or n.startswith('boxer_tpu.')]\n"
        "assert len(sys.modules) > 0 and not bad, bad\n"
        "print(sorted(n for n in sys.modules "
        "if n.startswith('boxer_tpu_torch')))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr
    assert "boxer_tpu_torch.models.boxer2d" in res.stdout
    assert "boxer_tpu_torch.models.boxer3d" in res.stdout
    assert "boxer_tpu_torch.models.detr" in res.stdout
    assert "boxer_tpu_torch.ops._build" in res.stdout
    assert "boxer_tpu_torch.tools.bench_combine" in res.stdout
    for name in ("trainer.base_trainer", "trainer.engine", "tools.run",
                 "dataset.coco", "dataset.helper.loader",
                 "dataset.processor.processors", "evaluate.coco_eval",
                 "criterion.metrics", "utils.checkpoint", "utils.config",
                 "nn.dropout", "nn.transformer", "nn.dense_attention",
                 "tools.trace_batch_split", "native", "utils.geometry",
                 "utils.visualization", "dataset.helper.image_dataset",
                 "tools.analyze", "tools.visualize",
                 "tools.examples.boxer2d_segmentation_demo"):
        assert f"boxer_tpu_torch.{name}" in res.stdout, name
