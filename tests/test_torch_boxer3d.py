"""The BoxeR-3D slice: the port's modules, model, matcher, losses, train step
and Waymo top-k against the JAX package's, on the same weights and inputs.

Weights come from a numpy seed at the JAX init shapes (`random_variables`:
nothing zero), so the heads JAX initialises to zero (`linear_box`,
`linear_attn`, the box MLPs' last layer) are perturbed; the sampling
offsets' kernels are scaled up besides (`_spread`), so the sampling points
move by more than a pixel and the decoder's dθ turns the grid, which each
attention case checks. f32 on the CPU, the port's kernels through their
plain versions. Tolerances: modules rel err 1e-4 (the pillar net 1e-3, as
its test says); the model's logits and
boxes abs 1e-3; the train step's loss terms rel 1e-4 and its worst gradient
leaf 2e-3 (those of the 2D step, `test_torch_train.py`); matches and
voxelizer arrays identical. Voxel coordinates never repeat a cell (the
voxelizer's output never does, and the scatter's winner is unspecified
otherwise).

The pillar net's GroupNorm is the one difference by design
(`boxer_tpu_torch/nn/point_pillar.py`): the port takes its variance in
two passes, flax by default in one, E[x²] - E[x]², which loses the digits
of a one-point pillar's near-constant groups. The port is held to flax's
own module run in float64 on frames full of one-point pillars
(`test_pillar_net_one_point_pillars_match_flax_in_f64`), and the tests
that compare with a JAX forward in f32 run flax's two-pass variance in the
pillar net only (`use_fast_variance=False`, the `pfn_two_pass` fixture);
the JAX package is not changed.
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget)
import functools
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import flax.linen
import jax
import jax.numpy as jnp

from test_torch_modules import _j, _rel_err, _t, load_submodule, \
    random_variables

from boxer_tpu_torch.utils.weights import jax_to_torch_state, load_jax_params

PC_RANGE = (-5.12, -5.12, -3.0, 5.12, 5.12, 3.0)
VOXEL = (0.32, 0.32, 6.0)
GRID = (32, 32)
BACKBONE = {"type": "pointpillar", "params": {
    "hidden_dim": 32, "position_encoding": "fixed", "ref_size": 4,
    "return_layers": 2,
    "reader": {"num_input_features": 5, "num_filters": [16, 32],
               "voxel_size": list(VOXEL), "pc_range": list(PC_RANGE)},
    "extractor": {"num_input_features": 32},
    "neck": {"num_layers": [1, 1, 1], "ds_strides": [1, 2, 2],
             "ds_filters": [32, 64, 64]}}}
# tests/test_boxer3d_forward.py's tiny model
TINY = dict(num_classes=2, hidden_dim=32, nhead=8, num_level=2, enc_layers=1,
            dec_layers=2, dim_feedforward=64, num_queries=16)
WEIGHTS = {"loss_ce": 2.0, "loss_bbox": 5.0, "loss_giou": 2.0,
           "loss_rad": 4.0}
SHAPES = ((6, 7), (3, 4))


class _TwoPassLinen:
    """flax.linen with a GroupNorm that takes the two-pass variance."""

    GroupNorm = functools.partial(flax.linen.GroupNorm,
                                  use_fast_variance=False)

    def __getattr__(self, name):
        return getattr(flax.linen, name)


@pytest.fixture
def pfn_two_pass(monkeypatch):
    """The JAX pillar net's GroupNorm with the two-pass variance; every
    other flax norm as it is."""
    from boxer_tpu.nn import point_pillar

    monkeypatch.setattr(point_pillar, "nn", _TwoPassLinen())


def _backbone(hidden):
    bb = {"type": "pointpillar", "params": dict(BACKBONE["params"],
                                                hidden_dim=hidden)}
    return bb


def _jax_model(**kw):
    from boxer_tpu.models.boxer3d import BoxeR3D, _flatten_cfg

    bb = _backbone(kw["hidden_dim"])
    return BoxeR3D(**kw, backbone_cfg=tuple(sorted(_flatten_cfg(bb).items())))


def _port_model(**kw):
    from boxer_tpu_torch.models.boxer3d import BoxeR3D

    return BoxeR3D(**kw, backbone_cfg=_backbone(kw["hidden_dim"]))


def _spread(variables, scale=3.0):
    """Scale every `linear_box` kernel: larger offsets, sizes and dθ."""
    def leaf(path, x):
        keys = [getattr(p, "key", None) for p in path]
        return x * scale if "linear_box" in keys and keys[-1] == "kernel" \
            else x
    return jax.tree_util.tree_map_with_path(leaf, variables)


def _cloud(seed, n=3000):
    """A seeded cloud in and around PC_RANGE, 5 features a point."""
    rs = np.random.RandomState(seed)
    return np.concatenate([rs.uniform(-5.5, 5.5, (n, 2)),
                           rs.uniform(-3.5, 3.5, (n, 1)),
                           rs.rand(n, 2)], axis=1).astype(np.float32)


def _clustered(seed, cells=300):
    """A frame of 1-8 points in each of `cells` distinct grid cells."""
    rs = np.random.RandomState(seed)
    pick = rs.choice(GRID[0] * GRID[1], cells, replace=False)
    per = rs.randint(1, 9, cells)
    cell = np.repeat(pick, per)
    n = len(cell)
    xy = (np.stack([cell % GRID[0], cell // GRID[0]], 1)
          + rs.uniform(0.05, 0.95, (n, 2))) * VOXEL[0] + PC_RANGE[0]
    return np.concatenate([xy, rs.uniform(-2.9, 2.9, (n, 1)),
                           rs.rand(n, 2)], axis=1).astype(np.float32)


def _voxel_batch(seeds, max_voxels=384, max_points=8):
    """Frames of 300 voxels of 1-8 points (about 38 of one point a frame)
    through the port's voxelizer and pad_voxels (the rest of max_voxels
    padding), concatenated: (voxels, coordinates [b, z, y, x], num_points),
    numpy."""
    from boxer_tpu_torch.dataset.processor.voxelizer import (pad_voxels,
                                                             points_to_voxel)

    parts = [pad_voxels(*points_to_voxel(_clustered(s), VOXEL, PC_RANGE,
                                         max_points=max_points,
                                         max_voxels=max_voxels), b,
                        max_voxels) for b, s in enumerate(seeds)]
    return tuple(np.concatenate(x) for x in zip(*parts))


def test_box3d_ops_match_jax():
    from boxer_tpu.utils import box3d_ops as jo
    from boxer_tpu_torch.utils import box3d_ops as to

    rs = np.random.RandomState(0)
    a = np.concatenate([rs.uniform(0, 1, (2, 7, 3)),
                        rs.uniform(0.05, 0.4, (2, 7, 3))], -1).astype(np.float32)
    b = np.concatenate([rs.uniform(0, 1, (2, 5, 3)),
                        rs.uniform(0.05, 0.4, (2, 5, 3))], -1).astype(np.float32)
    b[0, 0] = a[0, 0]                       # one identical pair: IoU 1
    xa, xb = (to.box_cxcyczlwh_to_xyxyxy(_t(x)) for x in (a, b))
    ja, jb = (jo.box_cxcyczlwh_to_xyxyxy(_j(x)) for x in (a, b))
    assert _rel_err(xa, ja) <= 1e-6
    assert _rel_err(to.box_vol_wo_angle(xa), jo.box_vol_wo_angle(ja)) <= 1e-5
    for t, w in zip(to.box_iou_wo_angle(xa, xb), jo.box_iou_wo_angle(ja, jb)):
        assert _rel_err(t, w) <= 1e-5
    giou = to.generalized_box3d_iou(xa, xb)
    assert giou.shape == (2, 7, 5)
    assert _rel_err(giou, jo.generalized_box3d_iou(ja, jb)) <= 1e-5
    assert abs(float(giou[0, 0, 0]) - 1.0) <= 1e-6
    assert _rel_err(to.elementwise_generalized_box3d_iou(xa[:, :5], xb),
                    jo.elementwise_generalized_box3d_iou(ja[:, :5], jb)) <= 1e-5
    ang = rs.uniform(-10, 10, 50).astype(np.float32)
    assert _rel_err(to.limit_period(_t(ang)), jo.limit_period(_j(ang))) <= 1e-6


@pytest.mark.parametrize("max_voxels,max_points", [(20000, 35), (300, 4)],
                         ids=["roomy", "truncating"])
def test_voxelizer_copy_matches_jax_package(max_voxels, max_points):
    from boxer_tpu.dataset.processor import voxelizer as jv
    from boxer_tpu_torch.dataset.processor import voxelizer as tv

    for seed in range(3):
        pts = _cloud(seed)
        want = jv.points_to_voxel(pts, VOXEL, PC_RANGE, max_points=max_points,
                                  max_voxels=max_voxels)
        got = tv.points_to_voxel(pts, VOXEL, PC_RANGE, max_points=max_points,
                                 max_voxels=max_voxels)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        lin = got[1] @ np.array([GRID[0] * GRID[1], GRID[0], 1])
        assert len(np.unique(lin)) == len(lin)            # no cell twice
        for g, w in zip(tv.pad_voxels(*got, 1, 2 * len(got[0])),
                        jv.pad_voxels(*want, 1, 2 * len(want[0]))):
            np.testing.assert_array_equal(g, w)


def test_grid_shape_covers_the_voxelizer():
    """A served frame runs at the voxelizer's own grid: every voxel of a
    cloud drawn past pc_range's edges lies inside it, its last row and
    column included. At the shipped config's 150 m of 0.32 m pillars that
    is 469 x 469, one more than tools/mfu_bench.py's 468, where the last
    column would fold into the next row."""
    from boxer_tpu_torch.dataset.processor.voxelizer import points_to_voxel
    from boxer_tpu_torch.dataset.waymo import grid_shape

    assert grid_shape((-75.0, -75.0, -3.0, 75.0, 75.0, 5.0),
                      (0.32, 0.32, 8.0)) == (469, 469)
    assert grid_shape(PC_RANGE, VOXEL) == GRID
    _, coords, _ = points_to_voxel(_cloud(5), VOXEL, PC_RANGE, max_points=4,
                                   max_voxels=5000)
    assert coords[:, 2].max() == GRID[0] - 1                       # x
    assert coords[:, 1].max() == GRID[1] - 1                       # y
    assert coords.min() >= 0


@pytest.mark.usefixtures("pfn_two_pass")
def test_pillar_feature_net_and_scatter_match_jax():
    """Two frames with padding voxels (b = -1): the reader's features and
    the dense BEV canvas."""
    from boxer_tpu.nn.point_pillar import (PillarFeatureNet as JPFN,
                                           PointPillarsScatter as JScatter)
    from boxer_tpu_torch.nn.point_pillar import (PillarFeatureNet,
                                                 PointPillarsScatter)

    vox, coords, npts = _voxel_batch([0, 1])
    assert (coords[:, 0] == -1).any()
    kw = dict(num_input_features=5, num_filters=(16, 32), voxel_size=VOXEL,
              pc_range=PC_RANGE)
    jm = JPFN(**kw)
    args = (_j(vox), _j(npts), _j(coords))
    v = random_variables(jm, 0, *args)
    want = jax.jit(jm.apply)(v, *args)
    tm = load_submodule(PillarFeatureNet(**kw), v, ("backbone", "reader"),
                        "backbone.reader.")
    with torch.no_grad():
        got = tm(_t(vox), _t(npts), _t(coords))
    assert got.shape == (len(vox), 32)
    # a padding voxel's feature is the masked max, -1e9, on both sides; the
    # live ones within 1e-3: a near-constant channel of a one-point voxel
    # (see the module docstring) divides f32 rounding by a small deviation
    live = coords[:, 0] >= 0
    assert (got[~live] == -1e9).all()
    assert _rel_err(got[live], np.asarray(want)[live]) <= 1e-3
    canvas = PointPillarsScatter()(got, _t(coords), 2, GRID)
    j_canvas = JScatter()(want, _j(coords), 2, GRID)
    assert canvas.shape == (2, GRID[1], GRID[0], 32)
    assert _rel_err(canvas, j_canvas) <= 1e-3
    assert int((canvas.abs().sum(-1) > 0).sum()) == int(live.sum())


def test_pillar_net_one_point_pillars_match_flax_in_f64():
    """The known difference, held to the unpatched reference: on frames of
    `_cloud`'s uniform points (over 400 one-point pillars), the port in f32
    agrees with flax's own pillar net run in float64 (rel 1e-3 on every
    live pillar), while flax's f32 one-pass variance is more than 0.1 of a
    normalized output off it on the one-point pillars."""
    from boxer_tpu.nn.point_pillar import PillarFeatureNet as JPFN
    from boxer_tpu_torch.dataset.processor.voxelizer import (pad_voxels,
                                                             points_to_voxel)
    from boxer_tpu_torch.nn.point_pillar import PillarFeatureNet

    parts = [pad_voxels(*points_to_voxel(_cloud(s), VOXEL, PC_RANGE,
                                         max_points=8, max_voxels=1200), b,
                        1200) for b, s in enumerate((0, 1))]
    vox, coords, npts = (np.concatenate(x) for x in zip(*parts))
    live = coords[:, 0] >= 0
    one = live & (npts == 1)
    assert one.sum() >= 400
    kw = dict(num_input_features=5, num_filters=(16, 32), voxel_size=VOXEL,
              pc_range=PC_RANGE)
    args = (vox, npts, coords)
    v = random_variables(JPFN(**kw), 0, *(_j(a) for a in args))
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(
            lambda x: jnp.asarray(np.asarray(x, np.float64)), v)
        exact = np.asarray(JPFN(**kw, dtype=jnp.float64).apply(
            v64, jnp.asarray(vox.astype(np.float64)), jnp.asarray(npts),
            jnp.asarray(coords)))
    assert exact.dtype == np.float64
    fast = np.asarray(JPFN(**kw).apply(v, *(_j(a) for a in args)))
    tm = load_submodule(PillarFeatureNet(**kw), v, ("backbone", "reader"),
                        "backbone.reader.")
    with torch.no_grad():
        got = tm(*(_t(a) for a in args)).numpy()
    assert _rel_err(got[live], exact[live]) <= 1e-3
    assert np.abs(fast[one] - exact[one]).max() > 0.1


def test_convnet_matches_jax():
    from boxer_tpu.nn.backbone3d import ConvNet as JConvNet
    from boxer_tpu_torch.nn.backbone3d import ConvNet

    x = np.random.RandomState(2).randn(2, 16, 16, 8).astype(np.float32)
    kw = dict(num_layers=(1, 2, 1), ds_strides=(1, 2, 2),
              ds_filters=(32, 64, 64))
    jm = JConvNet(**kw)
    v = random_variables(jm, 3, _j(x))
    want = jm.apply(v, _j(x))
    tm = load_submodule(ConvNet(8, **kw), v, ("backbone", "neck"),
                        "backbone.neck.")
    with torch.no_grad():
        got = tm(_t(x).permute(0, 3, 1, 2))
    for g, (w, _) in zip(got, want):
        assert _rel_err(g.permute(0, 2, 3, 1), w) <= 1e-4


def test_create_ref_windows_3d_matches_jax():
    from boxer_tpu.nn.box3d_transformer import create_ref_windows_3d as jref
    from boxer_tpu_torch.nn.box3d_transformer import create_ref_windows_3d

    feats = [np.zeros((2, h, w, 3), np.float32) for h, w in ((16, 12), (8, 6))]
    got = create_ref_windows_3d([_t(f) for f in feats], 4)
    want = jref([_j(f) for f in feats], 4)
    assert got.shape == (2, 16 * 12 + 8 * 6, 8, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-7)


def _attn_case(seed, per_head, lq=30, d_model=64, nh=8):
    rs = np.random.RandomState(seed)
    s = sum(h * w for h, w in SHAPES)
    query = rs.randn(1, lq, d_model).astype(np.float32)
    value = rs.randn(1, s, d_model).astype(np.float32)
    shape = (1, lq, nh) if per_head else (1, lq)
    ref = np.concatenate([rs.uniform(0.1, 0.9, shape + (2,)),
                          rs.uniform(0.1, 0.5, shape + (2,)),
                          rs.rand(*shape, 1)], -1).astype(np.float32)
    return query, value, ref


@pytest.mark.parametrize("with_rotation", [False, True],
                         ids=["encoder", "decoder"])
def test_box3d_attention_matches_jax(with_rotation):
    """The encoder's (per-head windows turned by their own angle, 4 box
    variables) and the decoder's (one window a query, dθ: 5 variables)."""
    from boxer_tpu.nn.attention import Box3dAttention as JBox3d
    from boxer_tpu_torch.nn.attention import Box3dAttention, _offsets

    query, value, ref = _attn_case(4, per_head=not with_rotation)
    jm = JBox3d(64, 2, 8, with_rotation=with_rotation)
    args = (_j(query), _j(value), SHAPES, None, None, _j(ref))
    v = _spread(random_variables(jm, 5, *args))
    want = jax.jit(lambda v, q, x, r: jm.apply(v, q, x, SHAPES, None, None,
                                               r))(v, *args[:2], args[-1])
    path = (("transformer", "decoder_layer0", "cross_attn") if with_rotation
            else ("transformer", "encoder_layer0", "self_attn"))
    prefix = ("transformer.decoder.layers.0.multihead_attn." if with_rotation
              else "transformer.encoder.layers.0.self_attn.")
    tm = load_submodule(Box3dAttention(64, 2, 8, with_rotation), v, path,
                        prefix)
    assert tm.linear_box_weight.shape[0] == 8 * 2 * (5 if with_rotation else 4)
    with torch.no_grad():
        got = tm(_t(query), _t(value), SHAPES, None, None, _t(ref))
        gx, gy = tm._where_to_attend(_t(query), None, _t(ref))
        off = _offsets(tm, _t(query))
        tm.linear_box_weight.zero_()
        gx0, gy0 = tm._where_to_attend(_t(query), None, _t(ref))
    for g, w in zip(got, want):
        assert _rel_err(g, w) <= 1e-4
    # the predicted offsets move sampling points by more than a pixel of
    # level 0, and the decoder's dθ turns the grid by more than 0.3 rad
    px = torch.maximum((gx - gx0).abs() * SHAPES[0][1],
                       (gy - gy0).abs() * SHAPES[0][0])
    assert float(px.max()) > 1.0
    if with_rotation:
        dtheta = off[:, :, :, 4] / 16 * 2 * math.pi
        assert float(dtheta.abs().max()) > 0.3


def _heads_case(seed, nl=2, l=10, c=32):
    rs = np.random.RandomState(seed)
    x = rs.randn(nl, 2, l, c).astype(np.float32)
    ref = rs.uniform(0.05, 0.95, (2, l, 7)).astype(np.float32)
    ref_m = rs.uniform(0.05, 0.95, (2, l, 8, 5)).astype(np.float32)
    ref_m[:, :3, 0, 0] = 0.0005                 # outside: masked
    return x, ref, ref_m


def test_detector3d_heads_match_jax():
    from boxer_tpu.nn.predictor import (Detector3d as JDet,
                                        MultiDetector3d as JMulti)
    from boxer_tpu_torch.nn.predictor import Detector3d, MultiDetector3d

    x, ref, ref_m = _heads_case(6)
    jd = JDet(32, 3, aux_loss=True)
    v = random_variables(jd, 7, _j(x), _j(ref))
    want = jax.jit(jd.apply)(v, _j(x), _j(ref))
    td = load_submodule(Detector3d(32, 3, True), v, ("detector",),
                        "detector.")
    jm = JMulti(32, 1, 3, aux_loss=True)
    vm = random_variables(jm, 8, _j(x), _j(ref_m))
    want_m = jax.jit(jm.apply)(vm, _j(x), _j(ref_m))
    tmh = load_submodule(MultiDetector3d(32, 1, 3, True), vm,
                         ("transformer", "enc_detector"), "enc_detector.")
    with torch.no_grad():
        got = td(_t(x), _t(ref))
        got_m = tmh(_t(x), _t(ref_m))
    for g, w in ((got, want), (got_m, want_m)):
        assert len(g["aux_outputs"]) == len(w["aux_outputs"]) == 1
        for a, b in [(g, w), (g["aux_outputs"][0], w["aux_outputs"][0])]:
            for k in ("pred_logits", "pred_boxes"):
                assert a[k].shape == b[k].shape
                assert _rel_err(a[k], b[k]) <= 1e-4, k
    assert got_m["pred_boxes"].shape == (2, 30, 7)
    assert float(got_m["pred_logits"][0, 0, 0]) == -65504.0


def _models(seed=0, **kw):
    vox, coords, npts = _voxel_batch([10, 11])
    jm = _jax_model(**kw)
    args = (_j(vox), _j(coords), _j(npts), GRID, 2)
    v = _spread(random_variables(jm, seed, *args, train=False))
    tm = _port_model(**kw).eval()
    unused, unfilled = load_jax_params(tm, v)
    assert unused == [] and unfilled == []
    return jm, v, tm, (vox, coords, npts)


@pytest.fixture(scope="module")
def tiny():
    return _models(**TINY)


@pytest.mark.usefixtures("pfn_two_pass")
def test_boxer3d_forward_matches_jax(tiny):
    """Inference, then the training dict (every decoder layer, the encoder
    head over all 3 x 320 proposals)."""
    jm, v, tm, (vox, coords, npts) = tiny
    fwd = jax.jit(lambda v, a, b, c: (
        jm.apply(v, a, b, c, GRID, 2, train=False, inference=True),
        jm.apply(v, a, b, c, GRID, 2, train=False, inference=False)))
    want_inf, want_train = fwd(v, _j(vox), _j(coords), _j(npts))
    with torch.no_grad():
        got_inf = tm(_t(vox), _t(coords), _t(npts), GRID, 2)
        got_train = tm(_t(vox), _t(coords), _t(npts), GRID, 2, train=True,
                       inference=False)
    assert "enc_outputs" not in got_inf and "enc_outputs" in got_train
    assert got_inf["pred_boxes"].shape == (2, 16, 7)

    def close(g, w):
        for k in ("pred_logits", "pred_boxes"):
            assert g[k].shape == w[k].shape, k
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       rtol=0, atol=1e-3, err_msg=k)

    close(got_inf, want_inf)
    close(got_train, want_train)
    assert len(got_train["aux_outputs"]) == 1
    close(got_train["aux_outputs"][0], want_train["aux_outputs"][0])
    enc = got_train["enc_outputs"][0]
    assert enc["pred_logits"].shape == (2, 3 * (16 * 16 + 8 * 8), 1)
    close(enc, want_train["enc_outputs"][0])
    boxes = got_inf["pred_boxes"].numpy()
    assert np.isfinite(boxes).all() and boxes.min() >= 0 and boxes.max() <= 1


def test_top125_matches_format_for_evalai(tiny):
    """The served path's last stage against `WaymoDetection.
    format_for_evalai(..., local_eval=False)` on a stand-in that holds
    pc_range; JAX's top-k is unordered, so both are compared sorted by
    score."""
    from boxer_tpu.dataset.waymo import WaymoDetection
    from boxer_tpu_torch.dataset.waymo import format_for_evalai

    _, _, tm, (vox, coords, npts) = tiny
    with torch.no_grad():
        out = tm(_t(vox), _t(coords), _t(npts), GRID, 2)
    k = 20                             # of 16 queries x 2 classes
    got = format_for_evalai(out["pred_logits"], out["pred_boxes"], PC_RANGE,
                            topk=k)
    stand_in = SimpleNamespace(pc_range=np.asarray(PC_RANGE, np.float32))
    want = WaymoDetection.format_for_evalai(
        stand_in, {n: out[n].numpy() for n in ("pred_logits", "pred_boxes")},
        [{"token": "a"}, {"token": "b"}], topk=k, local_eval=False)
    for i, token in enumerate("ab"):
        w = want[token]
        order = np.argsort(-w["pred_scores"], kind="stable")
        np.testing.assert_allclose(got["pred_scores"][i].numpy(),
                                   w["pred_scores"][order], rtol=1e-6)
        np.testing.assert_array_equal(got["pred_labels"][i].numpy(),
                                      w["pred_labels"][order])
        np.testing.assert_allclose(got["pred_boxes3d"][i].numpy(),
                                   w["pred_boxes3d"][order], rtol=0,
                                   atol=1e-5)
    metric = got["pred_boxes3d"]
    assert float(metric[..., :2].abs().max()) <= 5.12


def _targets(seed, b=2, nt=6, num_classes=2):
    rs = np.random.RandomState(seed)
    boxes = np.concatenate([rs.uniform(0.2, 0.8, (b, nt, 3)),
                            rs.uniform(0.02, 0.2, (b, nt, 3)),
                            rs.uniform(0, 1, (b, nt, 1))], -1).astype(np.float32)
    valid = np.ones((b, nt), bool)
    valid[1, -2:] = False
    return {"labels": rs.randint(0, num_classes, (b, nt)).astype(np.int32),
            "boxes": boxes, "valid": valid}


def test_hungarian_matcher3d_matches_jax():
    from boxer_tpu.nn.matcher import HungarianMatcher3d as JMatcher
    from boxer_tpu_torch.nn.matcher import build_matcher

    rs = np.random.RandomState(9)
    outputs = {"pred_logits": rs.randn(2, 40, 2).astype(np.float32),
               "pred_boxes": rs.rand(2, 40, 7).astype(np.float32)}
    targets = _targets(10)
    for nq in (40, 12):                 # pruned (NQ > 4 NT) and not
        out = {k: v[:, :nq] for k, v in outputs.items()}
        qi, valid = jax.jit(JMatcher(2, 5, 2, 4).__call__)(
            {k: _j(v) for k, v in out.items()},
            {k: _j(v) for k, v in targets.items()})
        got_qi, got_valid = build_matcher({"type": "hungarian3d", "params": {
            "class_weight": 2, "bbox_weight": 5, "giou_weight": 2,
            "rad_weight": 4}})({k: _t(v) for k, v in out.items()},
                               {k: _t(v) for k, v in targets.items()})
        m = np.asarray(valid)
        np.testing.assert_array_equal(got_valid.numpy(), m)
        np.testing.assert_array_equal(got_qi.numpy()[m], np.asarray(qi)[m])


TRAIN = dict(TINY, hidden_dim=64)       # 2 channels a GroupNorm group


def _to_torch(batch):
    return {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else torch.from_numpy(v))
            for k, v in batch.items()}


def _port_step(model, debug_grads=True, matcher=None):
    from boxer_tpu_torch.criterion.losses import Boxer3DCriterion
    from boxer_tpu_torch.nn.matcher import HungarianMatcher3d
    from boxer_tpu_torch.optim import build_optimizer, build_schedule
    from boxer_tpu_torch.parallel.steps import TrainState, make_train_step

    crit = Boxer3DCriterion(TRAIN["num_classes"],
                            matcher or HungarianMatcher3d(2, 5, 2, 4),
                            WEIGHTS, ["boxes", "focal_labels"])
    optim = {"type": "adamw", "params": {"lr": 1e-4, "weight_decay": 1e-4}}
    sched = {"type": "multi_step", "params": {
        "lr_steps": [10 ** 9], "lr_ratio": 0.1, "use_warmup": False}}
    state = TrainState(model, build_optimizer(optim, model),
                       build_schedule(sched, base_lr=1e-4))
    return crit, state, make_train_step(crit, max_norm=1.0,
                                        debug_grads=debug_grads)


class _Recording:
    """A matcher that keeps every match it returns, -1 at invalid rows."""

    def __init__(self, matcher):
        self.matcher, self.calls = matcher, []

    def __call__(self, outputs, targets):
        qi, valid = self.matcher(outputs, targets)
        self.calls.append(torch.where(valid, qi, -1).numpy())
        return qi, valid


def _jax_matches(jm, crit, v, batch):
    """The JAX criterion's matches on its own training forward: the
    encoder's (binary labels), then every decoder layer's in one stacked
    call, as its criterion makes them."""
    from boxer_tpu.criterion.losses import match_layers

    def run(v, vox, coords, npts, targets):
        out = jm.apply(v, vox, coords, npts, GRID, 2, train=True,
                       inference=False)
        bin_t = dict(targets, labels=jnp.zeros_like(targets["labels"]))
        calls = [crit.matcher(out["enc_outputs"][0], bin_t)]
        final = {k: out[k] for k in ("pred_logits", "pred_boxes")}
        qis, valids = match_layers(crit.matcher,
                                   out["aux_outputs"] + [final], targets)
        calls.append((jnp.stack(qis).reshape(-1, qis[0].shape[-1]),
                      jnp.stack(valids).reshape(-1, qis[0].shape[-1])))
        return [jnp.where(valid, qi, -1) for qi, valid in calls]

    return [np.asarray(x) for x in jax.jit(run)(
        v, *(_j(batch[k][0]) for k in ("voxels", "coordinates",
                                       "num_points_per_voxel")),
        {k: _j(x[0]) for k, x in batch["targets"].items()})]


def _train_variables(batch, seed=1):
    """The JAX model at TRAIN's width and its seeded, spread variables."""
    jm = _jax_model(**TRAIN)
    return jm, _spread(random_variables(jm, seed, *(_j(batch[k][0]) for k in (
        "voxels", "coordinates", "num_points_per_voxel")), GRID, 2,
        train=False))


def _whole_batch(seeds=(20, 21)):
    """Two frames as one microbatch of 2 (A=1, B=2)."""
    vox, coords, npts = _voxel_batch(list(seeds))
    return {"voxels": vox[None], "coordinates": coords[None],
            "num_points_per_voxel": npts[None],
            "targets": {k: v[None] for k, v in _targets(22).items()}}


@pytest.mark.usefixtures("pfn_two_pass")
def test_train_step_matches_jax():
    """One update: every loss term, the matches (the encoder's binary
    matches included) and the pre-clip gradients, and a non-zero gradient
    on every attention's offset and weight projections."""
    from boxer_tpu.criterion.losses import Boxer3DCriterion as JCrit
    from boxer_tpu.nn.matcher import HungarianMatcher3d as JMatcher
    from boxer_tpu.optim import build_optimizer
    from boxer_tpu.parallel.steps import create_train_state, make_train_step
    from boxer_tpu_torch.nn.matcher import HungarianMatcher3d

    batch = _whole_batch()
    jm, v = _train_variables(batch)
    crit = JCrit(TRAIN["num_classes"], JMatcher(2, 5, 2, 4), WEIGHTS,
                 ["boxes", "focal_labels"])
    tx, _ = build_optimizer({"type": "adamw", "params": {
        "lr": 1e-4, "weight_decay": 1e-4}}, v["params"])
    jstep = jax.jit(make_train_step(jm, crit, tx, max_norm=1.0,
                                    debug_grads=True,
                                    static={"grid_shape": GRID,
                                            "batch_size": 2}))
    _, want = jstep(create_train_state(v["params"], None, tx),
                    jax.tree_util.tree_map(jnp.asarray, batch),
                    jax.random.PRNGKey(0))
    want_matches = _jax_matches(jm, crit, v, batch)

    model = _port_model(**TRAIN)
    unused, unfilled = load_jax_params(model, v)
    assert unused == [] and unfilled == []
    rec = _Recording(HungarianMatcher3d(2, 5, 2, 4))
    _, state, step = _port_step(model, matcher=rec)
    _, got = step(state, dict(_to_torch(batch), grid_shape=GRID,
                              batch_size=2))

    assert len(rec.calls) == len(want_matches) == 2
    for g, w in zip(rec.calls, want_matches):
        np.testing.assert_array_equal(g, w)
    loss_keys = [k for k in want if k.startswith("loss_")]
    assert "loss_rad_enc_0" in loss_keys and "loss_rad_0" in loss_keys
    assert sorted(loss_keys) == sorted(k for k in got if k.startswith("loss_"))
    for k in loss_keys + ["total_loss", "grad_norm", "num_boxes"]:
        assert _rel_err(got[k], want[k]) <= 1e-4, k
    assert state.step == 1 and got["skipped"] == 0.0
    j_grads, _ = jax_to_torch_state({"params": want["_grads"]})
    assert sorted(j_grads) == sorted(got["_grads"])
    worst = max(_rel_err(got["_grads"][n].numpy(), j_grads[n])
                for n in j_grads)
    assert worst <= 2e-3, worst
    watched = [n for n in got["_grads"] if n.endswith(
        ("value_proj.weight", "linear_box_weight", "linear_attn_weight"))]
    assert len(watched) == 3 * (TRAIN["enc_layers"] + TRAIN["dec_layers"])
    for n in watched:
        assert float(got["_grads"][n].abs().max()) > 0, n


def test_train_step_one_point_pillars_f32_matches_f64():
    """The port's gradients on a batch with one-point pillars are
    well-conditioned: one f32 step against the same step in float64,
    every loss term within rel 1e-4 and the worst gradient leaf, the
    pillar net's included, within 2e-3, which torch's fused GroupNorm
    backward in the pillar net misses (`nn/point_pillar.py:group_norm`)."""
    batch = _whole_batch()
    assert (batch["num_points_per_voxel"] == 1).sum() >= 50
    _, v = _train_variables(batch)
    res = []
    for dtype in (torch.float32, torch.float64):
        model = _port_model(**TRAIN)
        load_jax_params(model, v)
        model = model.to(dtype)
        _, state, step = _port_step(model)
        b = _to_torch(batch)
        b["voxels"] = b["voxels"].to(dtype)
        b["targets"]["boxes"] = b["targets"]["boxes"].to(dtype)
        res.append(step(state, dict(b, grid_shape=GRID, batch_size=2))[1])
    got, exact = res
    for k in [k for k in exact if k.startswith("loss_")] + ["grad_norm"]:
        assert _rel_err(got[k], exact[k]) <= 1e-4, k
    errs = {n: _rel_err(got["_grads"][n].numpy(), exact["_grads"][n].numpy())
            for n in exact["_grads"]}
    assert any(n.startswith("backbone.reader.") for n in errs)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 2e-3, (worst, errs[worst])


def test_microbatches_equal_one_batch():
    """Two frames split into 2 microbatches of 1 (A=2, B=1: each frame's
    fixed voxel block, its batch index renumbered to 0, as the loader
    splits them) give the gradients of the one batch of two (A=1, B=2):
    both normalise by the update's global target count."""
    whole = _whole_batch()
    per = whole["voxels"].shape[1] // 2              # one frame's block
    coords = whole["coordinates"].reshape(2, per, 4).copy()
    coords[1, coords[1, :, 0] >= 0, 0] = 0           # its own batch index
    split = {"voxels": whole["voxels"].reshape(2, per, 8, 5),
             "coordinates": coords,
             "num_points_per_voxel": whole["num_points_per_voxel"].reshape(
                 2, per),
             "targets": {k: v.reshape((2, 1) + v.shape[2:])
                         for k, v in whole["targets"].items()}}
    res = []
    for batch, b in ((split, 1), (whole, 2)):
        model = _port_model(**TRAIN).init_weights(3)
        _, state, step = _port_step(model)
        _, stats = step(state, dict(_to_torch(batch), grid_shape=GRID,
                                    batch_size=b))
        res.append(stats)
    micro, one = res
    assert micro["num_boxes"] == one["num_boxes"] == 10.0
    for k in ("total_loss", "loss_ce", "loss_rad_0", "loss_giou_enc_0"):
        assert _rel_err(micro[k], one[k]) <= 1e-5, k
    worst = max(_rel_err(micro["_grads"][n].numpy(), one["_grads"][n].numpy())
                for n in one["_grads"])
    assert worst <= 1e-4, worst
