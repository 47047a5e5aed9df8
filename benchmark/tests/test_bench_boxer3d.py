"""The 3D cell's parts on the CPU: the cell, mix, configuration and its
two metrics found by files; the accepted `.infer` readers reported in both
cells; the FLOP count against torch's counter; the lidar
frames and the voxelizer against the port's; and, at a small 3D cell, the
check: the program passes, the control fails, and a bf16 cast of the raw
coordinates before the pillar net, or an altered frame, fails.

The small cell keeps the shipped configuration's structure at small
widths (hidden 32, 8 heads, 1 encoder and 2 decoder layers, a neck of one
conv a stage) over a 38.4 m square whose pillars all lie 38-77 m from the
sensor, where bf16's spacing is 0.25-0.5 m against a 0.32 m pillar.
"""

import json
import shutil

import numpy as np
import pytest
import torch
from conftest import BENCH, ROOT, run_cell
from torch.utils.flop_counter import FlopCounterMode

import counts
from counts.boxer3d import boxer3d_forward
from harness import lidar, spec

CELL = "pp3d.infer_b4"
METRICS = ("pillars_ms.pp3d", "neck_ms.pp3d")
UNLISTED = ("idle_pct.infer", "mfu.infer", "sampling_roofline.infer",
            "dispatch_ms.infer")
# accepted readers whose spans the 3D forward opens, listed for both cells
LISTED = ("backbone_ms.infer", "encoder_ms.infer", "decoder_ms.infer",
          "sampling_ms.infer", "forward_idle_ms.infer",
          "forward_launches.infer")
# the small cell's limits, on the keys of the shipped configuration's,
# between the readings it gave on the CPU at the seeds below (program, the
# larger of its two seeds / the bf16 coordinate cast at seed 11 / the fp8
# control, the smaller of its two): proposal_gap 0.0246 / 0.0487 / 1.18,
# center_err_p95_m 0.559 / 0.594 / 4.57 m, heading_err 0.018 / 0.029 / 0.12
SMALL_LIMITS = {"proposal_gap": 0.04, "center_err_p95_m": 1.6,
                "heading_err": 0.06}
SEEDS = (11, 3)


def small_config():
    cfg = json.loads((BENCH / "configs/boxer3d_pointpillar.json").read_text())
    cfg["model"].update(hidden_dim=32, enc_layers=1, dim_feedforward=64,
                        num_queries=30)
    params = cfg["backbone"]["params"]
    params.update(hidden_dim=32)
    params["reader"].update(num_filters=[16, 32],
                            pc_range=[38.4, 38.4, -3.0, 76.8, 76.8, 5.0])
    params["neck"].update(num_layers=[1, 1, 1], ds_filters=[32, 64, 64])
    cfg["voxelizer"] = {"max_points": 8, "max_voxels": 4000,
                        "grid": [120, 120]}
    cfg["limits"] = dict(SMALL_LIMITS)
    mix = json.loads((BENCH / "traffic/closed_b4_waymo60k.json").read_text())
    mix.update(batch=2, points=8000, topk=20, pool=2, warmup=1,
               trace_batches=1, check={"batches": 1, "samples": 2,
                                       "within": 1})
    return cfg, mix


@pytest.fixture
def bench3d(tmp_path):
    """The benchmark copied beside a BENCHMARK.json of the small cell."""
    folder = tmp_path / "benchmark"
    shutil.copytree(BENCH, folder, ignore=shutil.ignore_patterns(
        ".cache", "tests", "__pycache__"))
    cfg, mix = small_config()
    (folder / "configs" / "tiny3d.json").write_text(json.dumps(cfg))
    (folder / "traffic" / "tiny3d.json").write_text(json.dumps(mix))
    spec_ = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec_["configs"] = [{"name": "tiny3d", "source": "test",
                         "file": "benchmark/configs/tiny3d.json",
                         "reduced": [], "why": "test"}]
    spec_["workloads"] = [{"name": CELL, "config": "tiny3d",
                           "traffic": "tiny3d", "chips": 1, "why": "test"}]
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(spec_))
    return path


def test_cell_mix_config_and_metrics_are_found_by_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = spec.load_cell(ROOT / "BENCHMARK.json", CELL)
    assert cell.workload["chips"] == 1
    assert cell.traffic["driver"] == "infer_closed_loop"
    assert cell.config["family"] == "boxer3d"
    assert cell.config["reduced"] == []
    assert (BENCH / "families" / "boxer3d.py").is_file()
    assert {m["name"] for m in cell.end_to_end} == {
        "infer_samples_s", "infer_ms_p95", "peak_gib", "setup_s"}
    names = [m["name"] for m in cell.per_layer]
    assert set(METRICS) <= set(names)
    for m in bench["per_layer"]:
        if m["name"] in METRICS:
            assert m["workloads"] == [CELL]
            assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for w in bench["workloads"]:
        assert len(w["why"]) <= 200


def test_the_infer_metrics_report_in_both_cells():
    """The four metrics with no list report in every cell of the metric
    they move, and the six span readers list the 3D cell after the segm
    cell: one reader a quantity, in the segm cell and the 3D cell alike."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    by_name = {m["name"]: m for m in bench["per_layer"]}
    for cell in ("segm_r50.infer_b16", CELL):
        got = {m["name"] for m in spec.load_cell(
            ROOT / "BENCHMARK.json", cell).per_layer}
        assert set(UNLISTED) | set(LISTED) <= got, cell
    for name in UNLISTED:
        assert "workloads" not in by_name[name]
    for name in LISTED:
        assert by_name[name]["workloads"] == ["segm_r50.infer_b16", CELL]
    segm = {m["name"] for m in spec.load_cell(
        ROOT / "BENCHMARK.json", "segm_r50.infer_b16").per_layer}
    assert not segm & set(METRICS)


def test_the_configuration_keeps_the_published_widths():
    cfg = json.loads((BENCH / "configs/boxer3d_pointpillar.json").read_text())
    m, p = cfg["model"], cfg["backbone"]["params"]
    assert (m["hidden_dim"], m["nhead"], m["num_level"], m["enc_layers"],
            m["dec_layers"], m["dim_feedforward"], m["num_queries"],
            m["ref_size"], m["num_classes"]) == (256, 8, 2, 2, 2, 1024, 300,
                                                 4, 2)
    assert p["reader"] == {"num_input_features": 5, "num_filters": [64, 128],
                           "voxel_size": [0.32, 0.32, 12.0],
                           "pc_range": [-75.0, -75.0, -3.0, 75.0, 75.0, 5.0]}
    assert p["neck"] == {"num_layers": [2, 4, 2], "ds_strides": [1, 2, 2],
                         "ds_filters": [256, 512, 1024]}
    assert p["return_layers"] == 2
    assert cfg["voxelizer"] == {"max_points": 20, "max_voxels": 60000,
                                "grid": [469, 469]}
    assert lidar.grid_of(p["reader"]["pc_range"],
                         p["reader"]["voxel_size"])[:2] == (469, 469)


def test_frames_and_voxelizer_match_the_port():
    """The benchmark's voxelizer gives the port's arrays on its frames, and
    a frame fills its block."""
    from boxer_tpu_torch.dataset.processor.voxelizer import (pad_voxels,
                                                             points_to_voxel)

    pc = (-75.0, -75.0, -3.0, 75.0, 75.0, 5.0)
    vs = (0.32, 0.32, 12.0)
    pts = lidar.cloud(np.random.default_rng(2 ** 33 + 5), pc, 180000)
    assert pts.dtype == np.float32 and pts.shape == (180000, 5)
    assert (np.abs(pts[:, :2]) > 60).any(1).mean() > 0.03
    mine = lidar.voxelize(pts, vs, pc, 20, 60000, 1)
    theirs = pad_voxels(*points_to_voxel(pts, vs, pc, max_points=20,
                                         max_voxels=60000), 1, 60000)
    for a, b in zip(mine, theirs):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert (mine[1][:, 0] == 1).all()            # the block is full


def test_boxer3d_flops_match_torch():
    from boxer_tpu_torch.models.boxer3d import BoxeR3D

    cfg, _ = small_config()
    model = BoxeR3D(**cfg["model"], backbone_cfg=cfg["backbone"])
    model = model.init_weights(0).eval()
    grid, vox = (120, 120), (500, 8)
    rng = np.random.default_rng(0)
    pts = lidar.cloud(rng, cfg["backbone"]["params"]["reader"]["pc_range"],
                      2000)
    arrays = lidar.voxelize(pts, (0.32, 0.32, 12.0),
                            cfg["backbone"]["params"]["reader"]["pc_range"],
                            vox[1], vox[0], 0)
    args = [torch.from_numpy(a) for a in arrays]
    with torch.no_grad(), FlopCounterMode(display=False) as mode:
        model(*args, grid, 1, inference=True)
    got = {"conv": 0, "matmul": 0}
    for op, n in mode.get_flop_counts()["Global"].items():
        name = str(op).split(".")[-1]
        if name == "convolution":
            got["conv"] += n
        elif name in ("mm", "addmm", "bmm", "baddbmm"):
            got["matmul"] += n
    want = boxer3d_forward(cfg, grid, vox)
    assert got["conv"] == counts.total(want, {"conv"})
    assert got["matmul"] == counts.total(want, {"matmul"})


def _readings(bench_json, seed, control):
    import run

    cell = spec.load_cell(bench_json, CELL, bench_json.parent / "benchmark")
    family = spec.load_module("families", cell.config["family"],
                              bench_json.parent / "benchmark")
    driver = spec.load_module("drivers", cell.traffic["driver"],
                              bench_json.parent / "benchmark")
    out = driver.run(cell, family, seed, 0.3, False, "cpu", 0.0,
                     run.CACHE / "scratch")
    recs = out["records"]
    if control:
        recs = family.control_records(cell.config, cell.traffic, "cpu", seed,
                                      recs)
    return family.judge(cell.config, cell.traffic, "cpu", seed, recs)


def test_control_fails_and_program_passes(bench3d):
    for seed in SEEDS:
        prog = _readings(bench3d, seed, control=False)
        ctl = _readings(bench3d, seed, control=True)
        assert all(prog[k] <= lim for k, lim in SMALL_LIMITS.items()), prog
        assert any(ctl[k] > lim for k, lim in SMALL_LIMITS.items()), ctl


def test_raw_coordinates_cast_to_bf16_fail(bench3d, monkeypatch):
    """The pillar net as it was before its first layer ran in f32: the
    decorated points, raw x and y among them, cast to the weights' bf16."""
    from boxer_tpu_torch.nn import point_pillar

    def cast_first(self, x, point_mask, weight=None):
        return real(self, x.to(self.linear.weight.dtype), point_mask)

    real = point_pillar.PFNLayer.forward
    monkeypatch.setattr(point_pillar.PFNLayer, "forward", cast_first)
    got = _readings(bench3d, SEEDS[0], control=False)
    assert any(got[k] > lim for k, lim in SMALL_LIMITS.items()), got


def test_an_altered_frame_fails(bench3d, capsys, monkeypatch):
    """The frames reach the model shifted by a pillar's width in x: the
    reference judges them as they were sent."""
    from boxer_tpu_torch.models.boxer3d import BoxeR3D

    real = BoxeR3D.forward

    def shifted(self, voxels, *args, **kw):
        voxels = voxels.clone()
        voxels[..., 0] += 0.32
        return real(self, voxels, *args, **kw)

    monkeypatch.setattr(BoxeR3D, "forward", shifted)
    rc, res = run_cell(bench3d, CELL, seed=SEEDS[0], capsys=capsys)
    assert rc == 0 and res["correct"] is False


def test_the_program_passes_and_reports_every_metric(bench3d, capsys):
    rc, res = run_cell(bench3d, CELL, trace=1, seed=SEEDS[1], capsys=capsys)
    assert rc == 0 and res["correct"] is True, res["check"]
    assert set(res["check"]) == set(SMALL_LIMITS)
    # no card: the readers of device operations find nothing; the host's
    # clock and the FLOP count still read
    for name in ("mfu.infer", "dispatch_ms.infer"):
        assert res["metrics"][name]["value"] > 0
