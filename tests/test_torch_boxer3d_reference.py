"""BoxeR-3D in the port against the benchmark's plain reference, the pillar
net's first layer in f32, and the 3D box attention's inference route, on
the CPU with no JAX.

- The port's `BoxeR3D` (its kernels through their plain versions) against
  `benchmark/reference/boxer3d.py` at a small size in f32, on the
  benchmark's seeded weights (`benchmark/harness/weights.py`: the heads a
  fresh model zeroes get weights too, so the boxes move their windows and
  the decoder's dθ turns its grid, which the test checks). Both sum in f32
  in another order (K9's plain version against explicit gathers, one
  GEMM against another), so the logits are held to abs 1e-4 and the
  normalized boxes to 1e-5; the proposals, the top-k's (query, class)
  pairs and labels are identical, its scores within 1e-5 and its metric
  boxes within 1e-3 m.
- The pillar net on frames whose points all lie 60-75 m out: with bf16
  weights, and with f32 weights under bf16 autocast, each pillar's
  features stay within 2% (the relative norm of the difference) of the f32
  run on the same weights; they read 0.3-0.5% here. The cast the first
  layer had before, raw x and y rounded to bf16 (0.5 m apart past 64 m),
  moves the far pillars by about 28% and fails the same bound.
- `Box3dAttention` with `fold=True` (K9's route) against `fold=None` (the
  per-tap route), at odd level sizes, with and without rotation, with one
  window a query or one a head: rel 1e-5.
- A 3D inference forward samples each box attention in one K9 call and
  never forms the per-tap route's taps; a training forward the reverse.
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget)
import importlib
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.append(str(Path(__file__).resolve().parents[1] / "benchmark"))

from harness import lidar, weights  # noqa: E402
from reference.boxer3d import BoxeR3D as Reference  # noqa: E402

from boxer_tpu_torch.dataset.waymo import format_for_evalai  # noqa: E402
from boxer_tpu_torch.models.boxer3d import BoxeR3D  # noqa: E402
from boxer_tpu_torch.nn import point_pillar  # noqa: E402
from boxer_tpu_torch.nn.attention import Box3dAttention  # noqa: E402

tb = importlib.import_module("boxer_tpu_torch.ops.box_attention")

PC = (-12.8, -12.8, -3.0, 12.8, 12.8, 5.0)
VOXEL = (0.32, 0.32, 12.0)
GRID = (80, 80)
BACKBONE = {"type": "pointpillar", "params": {
    "hidden_dim": 32, "position_encoding": "fixed", "ref_size": 4,
    "return_layers": 2,
    "reader": {"num_input_features": 5, "num_filters": [16, 32],
               "voxel_size": list(VOXEL), "pc_range": list(PC)},
    "neck": {"num_layers": [1, 1, 1], "ds_strides": [1, 2, 2],
             "ds_filters": [32, 64, 64]}}}
MODEL = dict(num_classes=2, hidden_dim=32, nhead=8, num_level=2,
             enc_layers=1, dec_layers=2, dim_feedforward=64, dropout=0.0,
             num_queries=16, aux_loss=True, ref_size=4)
TOPK = 20


def _frame(seed, pc=PC, points=6000, max_voxels=3000, max_points=8):
    pts = lidar.cloud(np.random.default_rng(seed), pc, points)
    return [torch.from_numpy(a) for a in lidar.voxelize(
        pts, VOXEL, pc, max_points, max_voxels, 0)]


def _port(seed):
    model = BoxeR3D(**MODEL, backbone_cfg=BACKBONE)
    return weights.fill_(model, seed, "cpu").eval()


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 9])
def test_port_matches_the_plain_reference(seed):
    port = _port(seed)
    ref = Reference(**MODEL, backbone_cfg=BACKBONE)
    ref.load_state_dict(port.state_dict(), strict=True)
    args = _frame(seed)
    seen = {}
    ref.detector.register_forward_hook(
        lambda mod, a, out: seen.__setitem__("heads", out))
    port.transformer.decoder.layers[0].multihead_attn.register_forward_hook(
        lambda mod, a, out: seen.__setitem__("query", a[0]))
    with torch.no_grad():
        out = port(*args, GRID, 1, inference=True)
        top = format_for_evalai(out["pred_logits"], out["pred_boxes"], PC,
                                topk=TOPK)
        got = ref(*args, GRID, 1, topk=TOPK)
        # the decoder's dθ turns its grid by more than 0.3 rad somewhere
        attn = port.transformer.decoder.layers[0].multihead_attn
        off = torch.nn.functional.linear(seen["query"], attn.linear_box_weight,
                                         attn.linear_box_bias)
        dtheta = off.reshape(*off.shape[:2], attn.num_head, attn.num_level,
                             5)[..., 4] / 16 * 2 * math.pi
    assert float(dtheta.abs().max()) > 0.3
    logits, boxes = seen["heads"]
    assert (out["pred_logits"] - logits).abs().max() <= 1e-4
    assert (out["pred_boxes"] - boxes).abs().max() <= 1e-5
    own = ref.transformer.seen
    assert torch.equal(own["topk"][0][1], top["pred_labels"])
    assert torch.equal(got["labels"], top["pred_labels"])
    assert (got["scores"] - top["pred_scores"]).abs().max() <= 1e-5
    assert (got["boxes"] - top["pred_boxes3d"]).abs().max() <= 1e-3
    assert got["boxes"][..., :2].abs().max() > 1.0     # boxes spread out


def _far_frame():
    """Pillars 60-75 m out in x or y, up to 20 points each."""
    pc = (-75.0, -75.0, -3.0, 75.0, 75.0, 5.0)
    pts = lidar.cloud(np.random.default_rng(7), pc, 60000)
    pts = pts[np.abs(pts[:, :2]).max(1) > 60][:20000]
    v, c, n = (torch.from_numpy(a) for a in lidar.voxelize(
        pts, VOXEL, pc, 20, 6000, 0))
    return pc, (v, n, c), c[:, 0] >= 0


def _pillar_err(out, want, live):
    """The largest relative norm of a live pillar's difference."""
    d = out[live].float() - want[live]
    return float((d.norm(dim=-1) / want[live].norm(dim=-1)).max())


@pytest.mark.parametrize("mode", ["bf16_weights", "autocast"])
def test_pillar_net_takes_raw_coordinates_in_f32(mode, monkeypatch):
    pc, args, live = _far_frame()
    net = point_pillar.PillarFeatureNet(5, (64, 128), VOXEL, pc)
    # bf16-exact weights: the difference is the activations' rounding alone
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in net.parameters():
            z = torch.randn(p.shape, generator=g)
            p.copy_((z / math.sqrt(p.shape[1]) if p.dim() == 2
                     else 1 + 0.1 * z).bfloat16().float())
        want = net(*args)
    served = net.to(torch.bfloat16) if mode == "bf16_weights" else net

    def run():
        with torch.no_grad(), torch.autocast(
                "cpu", dtype=torch.bfloat16, enabled=mode == "autocast"):
            return served(*args)

    fixed = _pillar_err(run(), want, live)
    assert fixed <= 0.02, fixed
    # the cast before the first layer that the port had: the decorated
    # points, raw coordinates among them, rounded to bf16
    real = point_pillar.PFNLayer.forward

    def cast_first(self, x, point_mask, weight=None):
        if weight is not None:
            x, weight = x.to(torch.bfloat16), weight.to(torch.bfloat16)
        return real(self, x, point_mask, weight)

    monkeypatch.setattr(point_pillar.PFNLayer, "forward", cast_first)
    rounded = _pillar_err(run(), want, live)
    assert rounded > 0.02, rounded


@pytest.mark.parametrize("with_rotation", [False, True], ids=["enc", "dec"])
@pytest.mark.parametrize("per_head", [False, True], ids=["shared", "heads"])
def test_box3d_attention_fold_true_matches_per_tap(with_rotation, per_head):
    shapes = ((7, 9), (4, 5))
    d, nh, b, lq = 64, 8, 2, 23
    s = sum(h * w for h, w in shapes)
    attn = Box3dAttention(d, len(shapes), nh, with_rotation)
    weights.fill_(attn, 5, "cpu")
    with torch.no_grad():
        attn.linear_box_weight.mul_(3.0)       # taps a pixel and more off
    g = torch.Generator().manual_seed(1)
    query = torch.randn(b, lq, d, generator=g)
    value = torch.randn(b, s, d, generator=g)
    ref = torch.rand((b, lq) + ((nh,) if per_head else ()) + (5,),
                     generator=g)
    ref[..., 2:4] = ref[..., 2:4] * 0.3 + 0.05
    with torch.no_grad():
        want, _ = attn(query, value, shapes, None, None, ref)
        got, _ = attn(query, value, shapes, None, None, ref, fold=True)
        gx, _ = attn._where_to_attend(query, None, ref)
    assert ((gx < 0) | (gx > 1)).any()          # some taps leave the level
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= 1e-5, err


def test_inference_forward_samples_through_k9(monkeypatch):
    """Each box attention of an inference forward is one K9 call and forms
    no per-tap taps; a training forward calls K9 never."""
    calls = {"k9": 0, "taps": 0}

    def counting(key, fn):
        def run(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return run

    monkeypatch.setattr(tb, "box_sample_reduce",
                        counting("k9", tb.box_sample_reduce))
    monkeypatch.setattr(tb, "_level_taps", counting("taps", tb._level_taps))
    model = _port(4)
    args = _frame(4)
    with torch.no_grad():
        model(*args, GRID, 1, inference=True)
    assert calls == {"k9": MODEL["enc_layers"] + MODEL["dec_layers"],
                     "taps": 0}
    calls.update(k9=0, taps=0)
    model.train()
    out = model(*args, GRID, 1, train=True, inference=False)
    out["pred_boxes"].sum().backward()
    assert calls["k9"] == 0
    assert calls["taps"] == MODEL["enc_layers"] + MODEL["dec_layers"]
