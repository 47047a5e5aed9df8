"""The port's leaf modules against the JAX package's on the same inputs, on
the CPU: `utils/general.py`'s level and sampling helpers (1e-6),
`utils/box3d_ops.py`'s corner geometry and `utils/geometry.py` (equal
masks), `utils/visualization.py` (byte-equal images),
`dataset/helper/image_dataset.py` (as `tests/test_image_dataset.py`), and
the tools: `tools/analyze.py` (parameter counts equal to the JAX tool's for
a tiny config, FLOPs > 0, one structure line a parameter),
`tools/visualize.py` and the segmentation demo with `--device cpu`
(a PNG of the image's size).
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget)
import importlib.util
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from test_torch_modules import _rel_err

ROOT = Path(__file__).resolve().parents[1]
# the shipped detection yaml cut to a tiny r10 model (hidden 32 in one head
# of 32, 1 encoder and 2 decoder layers, 16 queries)
TINY_OPTS = ["model_config.boxer2d.hidden_dim=32",
             "model_config.boxer2d.transformer.params.nhead=1",
             "model_config.boxer2d.transformer.params.enc_layers=1",
             "model_config.boxer2d.transformer.params.dec_layers=2",
             "model_config.boxer2d.transformer.params.dim_feedforward=64",
             "model_config.boxer2d.transformer.params.num_queries=16",
             "model_config.boxer2d.backbone.type=resnet10"]
DET_YAML = "config/COCO-Detection/boxer2d_r50_3x.yaml"
SEGM_YAML = "config/COCO-InstanceSegmentation/boxer2d_r50_3x.yaml"


def _close(got, want, tol=1e-6):
    assert got.shape == tuple(want.shape)
    assert _rel_err(got.detach().numpy() if torch.is_tensor(got) else got,
                    np.asarray(want)) <= tol


# --- utils/general.py ------------------------------------------------------

SHAPES = ((5, 7), (3, 4), (2, 2))


def test_level_split_and_view():
    from boxer_tpu.utils import general as jg
    from boxer_tpu_torch.utils import general as tg

    rs = np.random.RandomState(0)
    s = sum(h * w for h, w in SHAPES)
    flat = rs.randn(2, s, 3).astype(np.float32)
    mask = rs.rand(2, s) > 0.5
    assert tg.level_sizes(SHAPES) == jg.level_sizes(SHAPES)
    for fn in ("split_with_shape", "view_with_shape"):
        got = getattr(tg, fn)(torch.from_numpy(flat), torch.from_numpy(mask),
                              SHAPES)
        want = getattr(jg, fn)(jnp.asarray(flat), jnp.asarray(mask), SHAPES)
        for g, w in zip(got[0] + got[1], want[0] + want[1]):
            assert g.shape == w.shape
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert getattr(tg, fn)(None, None, SHAPES) == (None, None)


def test_samplers_match_jax():
    from boxer_tpu.utils import general as jg
    from boxer_tpu_torch.utils import general as tg

    rs = np.random.RandomState(1)
    img = rs.randn(2, 5, 7, 3).astype(np.float32)
    grid = rs.uniform(-1.3, 1.3, (2, 4, 6, 2)).astype(np.float32)
    loc = rs.uniform(-0.2, 1.2, (2, 11, 2)).astype(np.float32)
    _close(tg.grid_sample_nhwc(torch.from_numpy(img), torch.from_numpy(grid)),
           jg.grid_sample_nhwc(jnp.asarray(img), jnp.asarray(grid)))
    _close(tg.bilinear_sample_norm01(torch.from_numpy(img),
                                     torch.from_numpy(loc)),
           jg.bilinear_sample_norm01(jnp.asarray(img), jnp.asarray(loc)))
    # and torch's own grid_sample, as the JAX package is held
    want = torch.nn.functional.grid_sample(
        torch.from_numpy(img).permute(0, 3, 1, 2), torch.from_numpy(grid),
        align_corners=False).permute(0, 2, 3, 1)
    _close(tg.grid_sample_nhwc(torch.from_numpy(img), torch.from_numpy(grid)),
           want.numpy(), 1e-5)


@pytest.mark.parametrize("align_corners,roi_align,masked",
                         [(False, False, True), (True, False, False),
                          (False, True, True)])
def test_extract_and_paste_grid_match_jax(align_corners, roi_align, masked):
    from boxer_tpu.utils import general as jg
    from boxer_tpu_torch.utils import general as tg

    rs = np.random.RandomState(2)
    x = rs.randn(2, 12, 10, 4).astype(np.float32)
    x_mask = np.zeros((2, 12, 10), bool)
    x_mask[1, 9:] = x_mask[1, :, 7:] = True
    boxes = np.concatenate([rs.uniform(0.2, 0.8, (2, 3, 2)),
                            rs.uniform(0.1, 0.5, (2, 3, 2))], -1).astype(
        np.float32)
    args = (x, x_mask if masked else None, boxes)
    got = tg.extract_grid(*(None if a is None else torch.from_numpy(a)
                            for a in args), grid_size=5,
                          align_corners=align_corners, roi_align=roi_align)
    want = jg.extract_grid(*(None if a is None else jnp.asarray(a)
                             for a in args), grid_size=5,
                           align_corners=align_corners, roi_align=roi_align)
    assert tuple(got.shape) == (2, 3, 5, 5, 4)
    _close(got, want)

    seg = rs.rand(3, 7, 7).astype(np.float32)
    xyxy = np.array([[2, 3, 20, 15], [0, 0, 31, 23], [10.5, 4, 12, 30]],
                    np.float32)
    _close(tg.paste_grid(torch.from_numpy(seg), torch.from_numpy(xyxy),
                         (24, 32)),
           jg.paste_grid(jnp.asarray(seg), jnp.asarray(xyxy), (24, 32)))


# --- utils/box3d_ops.py and utils/geometry.py ------------------------------

def _boxes3d(rs, n):
    return np.concatenate([rs.uniform(-4, 4, (n, 3)),
                           rs.uniform(0.5, 3, (n, 3)),
                           rs.uniform(-np.pi, np.pi, (n, 1))], 1).astype(
        np.float32)


def test_box3d_corner_geometry_matches_jax():
    from boxer_tpu.utils import box3d_ops as jb
    from boxer_tpu_torch.utils import box3d_ops as tb

    rs = np.random.RandomState(3)
    boxes = _boxes3d(rs, 9)
    pts = rs.randn(9, 5, 4).astype(np.float32)
    _close(tb.rotate_points_along_z(torch.from_numpy(pts),
                                    torch.from_numpy(boxes[:, 6])),
           jb.rotate_points_along_z(jnp.asarray(pts),
                                    jnp.asarray(boxes[:, 6])))
    _close(tb.boxes_to_corners_3d(torch.from_numpy(boxes)),
           jb.boxes_to_corners_3d(jnp.asarray(boxes)))
    limit = [-3.0, -3.0, -2.0, 3.0, 3.0, 2.0]
    got = tb.mask_boxes_outside_range(torch.from_numpy(boxes), limit)
    want = np.asarray(jb.mask_boxes_outside_range(jnp.asarray(boxes), limit))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < len(want)


def test_geometry_matches_jax():
    from boxer_tpu.utils import geometry as jgeo
    from boxer_tpu.utils.box3d_ops import boxes_to_corners_3d
    from boxer_tpu_torch.utils import geometry as tgeo

    rs = np.random.RandomState(4)
    boxes = _boxes3d(rs, 6)
    points = rs.uniform(-6, 6, (3000, 4)).astype(np.float32)
    got = tgeo.points_in_rbbox(points, boxes)
    want = jgeo.points_in_rbbox(points, boxes)
    np.testing.assert_array_equal(got, want)
    assert got.any(axis=0).all()
    np.testing.assert_array_equal(tgeo.points_count_rbbox(points, boxes),
                                  jgeo.points_count_rbbox(points, boxes))
    corners = np.asarray(boxes_to_corners_3d(jnp.asarray(boxes)))
    surfaces = tgeo.corner_to_surfaces_3d(corners)
    np.testing.assert_array_equal(surfaces,
                                  jgeo.corner_to_surfaces_3d(corners))
    for g, w in zip(tgeo.surface_equ_3d(surfaces),
                    jgeo.surface_equ_3d(surfaces)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        tgeo.points_in_convex_polygon_3d(points[:, :3], surfaces),
        jgeo.points_in_convex_polygon_3d(points[:, :3], surfaces))
    polygons = corners[:, :4, :2]
    got2 = tgeo.points_in_convex_polygon_2d(points[:, :2], polygons)
    np.testing.assert_array_equal(
        got2, jgeo.points_in_convex_polygon_2d(points[:, :2], polygons))
    assert got2.any()


# --- utils/visualization.py ------------------------------------------------

def test_drawings_are_byte_equal_to_jax():
    from boxer_tpu.utils import visualization as jv
    from boxer_tpu_torch.utils import visualization as tv

    rs = np.random.RandomState(5)
    image = (rs.rand(48, 64, 3) * 255).astype(np.uint8)
    boxes = np.array([[2, 3, 30, 40], [10, 5, 60, 20], [0, 0, 8, 8]],
                     np.float32)
    labels, scores = np.array([1, 4, 2]), np.array([0.9, 0.5, 0.2])
    for fn, args, kw in (
            ("draw_boxes", (image, boxes), dict(labels=labels, scores=scores,
                                                class_names=list("abcde"))),
            ("draw_boxes", (image, boxes), {}),
            ("draw_masks", (image, rs.rand(3, 48, 64) > 0.6),
             dict(labels=labels)),
            ("draw_masks", (image, rs.rand(2, 48, 64) > 0.6), {}),
            ("draw_bev_boxes", (_boxes3d(rs, 4), [-5, -5, -3, 5, 5, 3]),
             dict(canvas_size=96, labels=np.arange(4),
                  scores=np.array([0.9, 0.1, 0.5, 0.7]),
                  points=rs.uniform(-6, 6, (500, 4)),
                  gt_boxes3d=_boxes3d(rs, 2)))):
        got = getattr(tv, fn)(*args, **kw)
        want = getattr(jv, fn)(*args, **kw)
        assert got.dtype == want.dtype == np.uint8
        assert got.tobytes() == want.tobytes(), fn
        assert not np.array_equal(got, args[0]) if fn != "draw_bev_boxes" \
            else got.shape == (96, 96, 3)


# --- dataset/helper/image_dataset.py ---------------------------------------

def test_image_dataset_matches_jax(tmp_path):
    from boxer_tpu.dataset.helper.image_dataset import \
        ImageDataset as JaxImageDataset
    from boxer_tpu_torch.dataset.helper.image_dataset import ImageDataset

    for i in range(3):
        Image.fromarray(np.full((4, 4, 3), i * 40, np.uint8)).save(
            os.path.join(tmp_path, f"im{i}.png"))
    imdb = [{"img_path": f"im{i}.png"} for i in range(3)]
    ds = ImageDataset([str(tmp_path)], imdb, max_img_cache=2)
    ref = JaxImageDataset([str(tmp_path)], imdb, max_img_cache=2)
    assert len(ds) == len(ref) == 2           # the reference drops the last
    item = ds[1]
    assert np.asarray(item["image"]).shape == (4, 4, 3)
    assert np.asarray(item["image"])[0, 0, 0] == 40
    np.testing.assert_array_equal(np.asarray(item["image"]),
                                  np.asarray(ref[1]["image"]))
    ds[0], ds[1], ds[0]
    assert len(ds._cache) == 2                # bounded cache
    with pytest.raises(AttributeError):
        ImageDataset([str(tmp_path)], [{}, {}])[0]


# --- tools -----------------------------------------------------------------

def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_analyze_matches_the_jax_tool(capsys):
    from boxer_tpu.models import build_model as jax_build_model
    from boxer_tpu.utils.config import Configuration as JaxConfiguration

    from boxer_tpu_torch.tools import analyze

    got = analyze.main(["--tasks", "parameter", "flop", "structure",
                        "--config", str(ROOT / "boxer_tpu_torch" / DET_YAML),
                        "--height", "64", "--width", "96", "--device", "cpu",
                        "--no-bf16", *TINY_OPTS])
    port_out = capsys.readouterr().out

    # the JAX tool's task_parameter on the same config's variable shapes
    cfg = JaxConfiguration(config_path=str(ROOT / "boxer_tpu" / DET_YAML),
                           opts=TINY_OPTS,
                           extra={"task": "detection", "model": "boxer2d"})
    jm = jax_build_model(cfg.get_config().model_config["boxer2d"], 91,
                         dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3)),
        jnp.zeros((1, 64, 96), bool), train=False))
    _jax_tool("analyze").task_parameter(jm, shapes)
    jax_line = capsys.readouterr().out.strip()

    def count(tree):
        return sum(int(np.prod(x.shape))
                   for x in jax.tree_util.tree_leaves(tree))

    assert got["parameter"] == (count(shapes["params"]),
                                count(shapes["constants"]))
    port_line = next(line for line in port_out.splitlines()
                     if line.startswith("parameters:"))
    assert port_line.startswith(jax_line)
    assert got["flop"] > 0 and "FlopCounterMode" in port_out
    lines = [line for line in port_out.splitlines()
             if re.fullmatch(r"[\w.]+ +\([\d, ]*\) +[\d,]+", line)]
    assert got["structure"] == len(lines) > 0
    assert sum(int(line.split()[-1].replace(",", "")) for line in lines) \
        == got["parameter"][0]


def test_visualize_and_demo_write_a_png(tmp_path):
    from boxer_tpu_torch.tools import visualize
    from boxer_tpu_torch.tools.examples import boxer2d_segmentation_demo

    src = tmp_path / "photo.png"
    Image.fromarray((np.random.RandomState(6).rand(90, 120, 3) * 255)
                    .astype(np.uint8)).save(src)
    out, _ = visualize.main([
        "--config", str(ROOT / "boxer_tpu_torch" / SEGM_YAML),
        "--image", str(src), "--min-size", "64", "--max-size", "96",
        "--out", str(tmp_path / "viz.png"), "--threshold", "0.0",
        "--device", "cpu", *TINY_OPTS])
    assert Image.open(out).size == (85, 64)      # 120x90 at a short side 64
    out, _ = boxer2d_segmentation_demo.main(
        ["--size", "128", "--out", str(tmp_path / "demo.png"), "--threshold",
         "0.0", "--device", "cpu"],
        model_kwargs=dict(hidden_dim=32, nhead=1, enc_layers=1, dec_layers=2,
                          dim_feedforward=64, num_queries=16,
                          backbone_arch="resnet10"))
    assert Image.open(out).size == (128, 128)


# --- utils/box_ops.py, nn/resnet.py:build_resnet, the package exports -----

def test_box_ops_match_jax():
    from boxer_tpu.utils import box_ops as jb
    from boxer_tpu_torch.utils import box_ops as tb

    rs = np.random.RandomState(12)
    xy = rs.rand(2, 9, 2).astype(np.float32)
    boxes = np.concatenate([xy, xy + rs.rand(2, 9, 2).astype(np.float32)],
                           -1)
    boxes[0, 0] = [0.5, 0.5, 0.5, 0.9]                 # zero area
    _close(tb.box_xyxy_to_cxcywh(torch.from_numpy(boxes)),
           jb.box_xyxy_to_cxcywh(jnp.asarray(boxes)))
    a, b = boxes[0], boxes[1]
    for g, w in zip(tb.elementwise_box_iou(torch.from_numpy(a),
                                           torch.from_numpy(b)),
                    jb.elementwise_box_iou(jnp.asarray(a), jnp.asarray(b))):
        _close(g, w)
    _close(tb.elementwise_generalized_box_iou(torch.from_numpy(a),
                                              torch.from_numpy(b)),
           jb.elementwise_generalized_box_iou(jnp.asarray(a),
                                              jnp.asarray(b)))
    masks = rs.rand(4, 7, 11) > 0.8
    masks[1] = False                                    # empty: a zero box
    masks[2] = False
    masks[2, 3, 5] = True                               # one pixel
    got = tb.masks_to_boxes(torch.from_numpy(masks))
    want = np.asarray(jb.masks_to_boxes(jnp.asarray(masks)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want[1], 0)
    np.testing.assert_array_equal(want[2], [5, 3, 6, 4])


@pytest.mark.parametrize("layers,encoding,ref_size", [
    (["layer4"], "fixed", None),                        # DETR's surface
    (["layer2", "layer3", "layer4"], "fixed_box", 2)])  # BoxeR-2D's
def test_build_resnet_matches_jax(layers, encoding, ref_size):
    """`build_resnet` reads the config surface as JAX's does: the same
    arch, returned layers, encoding, width and ref_size, and JAX's
    parameters at their init shapes load into it strictly (the forward of
    `BackBone` against JAX's: `test_torch_modules.py::
    test_r10_backbone_with_padding_mask`)."""
    from test_torch_modules import load_submodule, random_variables

    from boxer_tpu.nn.resnet import build_resnet as j_build
    from boxer_tpu_torch.nn.resnet import BackBone, build_resnet

    params = {"return_interm_layers": layers,
              "position_encoding": encoding, "hidden_dim": 32}
    if ref_size is not None:
        params["ref_size"] = ref_size
    config = {"type": "resnet10", "params": params}
    jm, tm = j_build(config), build_resnet(config)
    assert isinstance(tm, BackBone)
    assert tm.return_layers == tuple(jm.return_layers)
    assert (tm.position_encoding, tm.hidden_dim, tm.ref_size) == (
        jm.position_encoding, jm.hidden_dim, jm.ref_size)
    image = jnp.zeros((1, 32, 32, 3))
    v = random_variables(jm, 14, image, jnp.zeros((1, 32, 32), bool))
    load_submodule(tm, v, ("backbone",), "backbone.")
    with torch.no_grad():
        feats, pos = tm(torch.zeros(1, 32, 32, 3),
                        torch.zeros(1, 32, 32, dtype=torch.bool))
    assert [f.shape[-1] for f, _ in feats] == tm.num_channels
    assert [p.shape[-1] for p in pos] == [32] * len(layers)
    assert next(build_resnet(config, torch.bfloat16).parameters()).dtype \
        == torch.bfloat16


@pytest.mark.parametrize("package", ["nn", "dataset.reader"])
def test_package_exports_match_jax(package):
    """Every name of the JAX package's `__all__` is exported by the port's
    package of the same path, as the port's own object of that name; the
    package's import loads none of its modules (so `import
    boxer_tpu_torch.nn` builds no kernel)."""
    import subprocess
    import sys

    jmod = importlib.import_module(f"boxer_tpu.{package}")
    tmod = importlib.import_module(f"boxer_tpu_torch.{package}")
    assert sorted(tmod.__all__) == sorted(jmod.__all__)
    for name in jmod.__all__:
        obj = getattr(tmod, name)
        assert obj.__module__.startswith("boxer_tpu_torch."), name
        assert obj.__name__ == name
    probe = (f"import sys, boxer_tpu_torch.{package} as p; "
             f"print(sorted(m for m in sys.modules if m.startswith("
             f"'boxer_tpu_torch.{package}.')))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, check=True, cwd=ROOT).stdout
    assert out.strip() == "[]"
    with pytest.raises(AttributeError):
        getattr(tmod, "NoSuchName")
