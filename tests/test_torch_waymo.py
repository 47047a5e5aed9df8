"""The port's Waymo data path and offline metrics against the JAX package,
on the CPU, on the same seeded inputs: numpy paths bitwise, metrics within
1e-3 (they agree exactly).

- The ten functions of `transforms_3d` on 7- and 9-column boxes (the
  heading last, the velocity in columns 6 and 7), and the shipped config's
  train and test processors through the registry.
- `read_points_with_sweeps` (nsweeps 1-3, pkl and npz) and the readers.
- `DataBaseSampler` on 7-column db infos: the same draws, cursors and
  outputs call after call. The column repair: on a 9-column frame with
  7-column db boxes the JAX sampler raises in `np.concatenate`, the port
  returns 9-column boxes; with the port's 9-column db the velocity is the
  db's.
- `create_gt_database` against the JAX tool: the same entries and object
  points, the boxes with all of the frame's columns (the JAX tool's 7 are
  the first 6 and the heading).
- `WaymoDetection` batches against JAX's on a generated directory (±5.12
  m, 512 voxels): train and val, iter_per_update 1 and 2, epochs 0 and 1,
  without a db sampler (the JAX one raises on the converter's boxes), the
  port with 1 and 2 workers. With a db sampler the port's batches are the
  same for 1 and 3 workers and after a cut at any batch.
- `evaluate_results` in both matchings and both `ap_mode`s against JAX on
  generated records, the fixtures of `tests/test_waymo_metrics.py` run on
  the port, and the 9-column GT the JAX evaluator misreads.
- `format_for_evalai`'s records against JAX's, as sets (the port's are
  sorted by score, JAX's are not), and `results.pkl`.
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget)
import copy
import os
import pickle
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import test_waymo_metrics

REPO = Path(__file__).resolve().parents[1]
PC_RANGE = [-5.12, -5.12, -3.0, 5.12, 5.12, 3.0]
VOXEL_SIZE = [0.32, 0.32, 6.0]
MAX_VOXELS = 512
DB_GROUPS = [{"VEHICLE": 15}, {"PEDESTRIAN": 10}]


def write_waymo_small(root, train=4, val=2, seed=0):
    """A Waymo directory at the JAX e2e test's size: ±5.12 m, about 3,000
    points and 4-12 objects (a quarter of real size) a frame, 9-column
    boxes; and the port's GT database of the train frames."""
    from boxer_tpu_torch.dataset.synthetic import write_waymo
    from boxer_tpu_torch.tools.preprocess.create_gt_database import \
        create_gt_database

    write_waymo(root, {"train": train, "val": val}, PC_RANGE, 3000, (4, 12),
                seed=seed, size_scale=0.25)
    create_gt_database(str(root), "infos/infos_train.pkl")
    return root


def processors(train, max_voxels=MAX_VOXELS, max_points=8):
    """The shipped config's train or test processors at PC_RANGE."""
    pre = []
    if train:
        pre += [{"type": "random_flip", "params": {}},
                {"type": "global_rotate", "params": {"rotation": 0.78539816}},
                {"type": "global_scale",
                 "params": {"min_scale": 0.95, "max_scale": 1.05}}]
    pre.append({"type": "filter_by_range", "params": {"pc_range": PC_RANGE}})
    if train:
        pre.append({"type": "shuffle_points", "params": {}})
    pre += [{"type": "voxelize", "params": {
                "voxel_size": VOXEL_SIZE, "pc_range": PC_RANGE,
                "max_points_per_voxel": max_points,
                "max_voxel_num": max_voxels}},
            {"type": "normalize3d", "params": {
                "pc_range": PC_RANGE, "normalize_angle": "sigmoid"}},
            {"type": "np_to_tensor", "params": {}}]
    return {"type": "compose", "params": {"preprocessors": pre}}


def dataset_config(root, db=False, max_boxes=40):
    """The `dataset_config.detection3d` node of the shipped config at the
    small size; with db the train split's GT-database sampler."""
    def split(name, with_db=False):
        imdb = {"root_path": str(root),
                "info_path": str(Path(root) / "infos" / f"infos_{name}.pkl"),
                "load_interval": 1}
        if with_db:
            imdb["db_sampler"] = {
                "db_info_path": str(Path(root) / "infos" /
                                    "dbinfos_infos_train.pkl"),
                "groups": DB_GROUPS, "min_points": 0, "difficulty": -1,
                "rate": 1.0}
        return imdb

    return {"nsweeps": 1, "normalize_angle": "sigmoid",
            "max_boxes": max_boxes, "pc_range": PC_RANGE,
            "voxel_size": VOXEL_SIZE, "min_points": 0,
            "classes": ["VEHICLE", "PEDESTRIAN"],
            "imdb_files": {"train": split("train", db), "val": split("val"),
                           "test": split("val")},
            "processors": {"train_processor": processors(True),
                           "test_processor": processors(False)}}


@pytest.fixture(scope="module")
def waymo_root(tmp_path_factory):
    return write_waymo_small(tmp_path_factory.mktemp("torch_waymo"))


# ---------------------------------------------------------------------------
# transforms and processors


def _frame(seed, ncols, n=600, m=9):
    rs = np.random.RandomState(seed)
    points = np.concatenate([rs.uniform(-6, 6, (n, 2)),
                             rs.uniform(-3.5, 3.5, (n, 1)),
                             rs.rand(n, 2)], 1).astype(np.float32)
    cols = [rs.uniform(-5.5, 5.5, (m, 2)), rs.uniform(-3.2, 3.2, (m, 1)),
            rs.uniform(0.5, 3, (m, 3))]
    if ncols == 9:
        cols.append(rs.normal(0, 3, (m, 2)))
    cols.append(rs.uniform(-4, 4, (m, 1)))
    boxes = np.concatenate(cols, 1).astype(np.float32)
    return ({"points": points},
            {"boxes": boxes, "labels": rs.randint(1, 5, m).astype(np.int64)})


def _equal(got, want):
    """Bitwise equal arrays of one dtype, in nested dicts, lists, tuples."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        return all(_equal(got[k], want[k]) for k in want)
    if isinstance(want, (tuple, list)):
        return len(got) == len(want) and all(
            _equal(g, w) for g, w in zip(got, want))
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    return np.array_equal(got, want)


TRANSFORMS = {
    "_rotate_z": lambda T, s, t, rng: T._rotate_z(s["points"], 0.7),
    "random_flip": lambda T, s, t, rng: T.random_flip(s, t, rng, prob=0.6),
    "global_rotation": lambda T, s, t, rng: T.global_rotation(s, t, rng, 0.8),
    "global_scaling": lambda T, s, t, rng: T.global_scaling(s, t, rng, 0.9,
                                                            1.1),
    "global_translate": lambda T, s, t, rng: T.global_translate(
        s, t, rng, [0.2, 0.2, 0.1]),
    "filter_by_pc_range": lambda T, s, t, rng: T.filter_by_pc_range(
        s, t, PC_RANGE),
    "shuffle_points": lambda T, s, t, rng: T.shuffle_points(s, t, rng),
    "limit_period_np": lambda T, s, t, rng: T.limit_period_np(
        t["boxes"][:, -1] * 3, 0.5, 2 * np.pi),
    "normalize3d_sigmoid": lambda T, s, t, rng: T.normalize3d(
        s, t, PC_RANGE, "sigmoid"),
    "normalize3d_sine": lambda T, s, t, rng: T.normalize3d(
        s, t, PC_RANGE, "sine"),
    "double_flip": lambda T, s, t, rng: T.double_flip(s, t),
}


@pytest.mark.parametrize("ncols", [7, 9])
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(name, ncols):
    from boxer_tpu.dataset.processor import transforms_3d as JT
    from boxer_tpu_torch.dataset.processor import transforms_3d as PT

    for seed in range(4):
        sample, target = _frame(seed, ncols)
        j_rng, p_rng = (np.random.RandomState(seed + 10) for _ in range(2))
        want = TRANSFORMS[name](JT, copy.deepcopy(sample),
                                copy.deepcopy(target), j_rng)
        got = TRANSFORMS[name](PT, sample, target, p_rng)
        assert _equal(got, want), (name, seed)
        assert j_rng.rand() == p_rng.rand()


def test_flip_and_rotation_move_velocity_and_heading():
    """The 9-column semantics: a y-mirror negates vy and the heading, an
    x-mirror vx and maps the heading to -(θ + π); a rotation turns the
    velocity with the centre and adds to the heading (the last column)."""
    from boxer_tpu_torch.dataset.processor import transforms_3d as T

    sample, target = _frame(0, 9)
    b = target["boxes"]

    class Coins:
        def __init__(self, values):
            self.values = list(values)

        def rand(self):
            return self.values.pop(0)

    _, t = T.random_flip(sample, target, Coins([0.0, 1.0]))
    np.testing.assert_array_equal(t["boxes"][:, [1, 7, 8]],
                                  -b[:, [1, 7, 8]])
    _, t = T.random_flip(sample, target, Coins([1.0, 0.0]))
    np.testing.assert_array_equal(t["boxes"][:, 6], -b[:, 6])
    np.testing.assert_array_equal(t["boxes"][:, 8], -(b[:, 8] + np.pi))
    rng = np.random.RandomState(3)
    angle = np.random.RandomState(3).uniform(-0.8, 0.8)
    _, t = T.global_rotation(sample, target, rng, 0.8)
    np.testing.assert_allclose(np.hypot(*t["boxes"][:, 6:8].T),
                               np.hypot(*b[:, 6:8].T), rtol=1e-5)
    np.testing.assert_allclose(t["boxes"][:, 8], b[:, 8] + angle, atol=1e-6)


@pytest.mark.parametrize("ncols", [7, 9])
@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_processors_match_jax(train, ncols):
    from boxer_tpu.dataset.processor.processors import build_processor as jb
    from boxer_tpu_torch.dataset.processor.processors import build_processor

    cfg = processors(train)
    for seed in range(3):
        sample, target = _frame(seed, ncols)
        j_rng, p_rng = (np.random.RandomState(seed) for _ in range(2))
        want = jb(cfg)(copy.deepcopy(sample), copy.deepcopy(target), j_rng)
        got = build_processor(cfg)(sample, target, p_rng)
        # the JAX voxelize also records the grid and the voxel cap, which
        # nothing reads (the dataset decides both); the port's does not
        for k in ("grid_shape", "max_voxel_num"):
            want[0].pop(k)
        assert _equal(got, want), seed
        assert got[1]["boxes"].shape[1] == 7


# ---------------------------------------------------------------------------
# readers


def _lidar_record(rs, n):
    return {"lidars": {
        "points_xyz": rs.uniform(-10, 10, (n, 3)).astype(np.float32),
        "points_feature": rs.uniform(0, 3, (n, 2)).astype(np.float32)}}


@pytest.mark.parametrize("fmt", ["pkl", "npz"])
@pytest.mark.parametrize("nsweeps", [1, 2, 3])
def test_read_points_with_sweeps_matches_jax(tmp_path, nsweeps, fmt):
    from boxer_tpu.dataset.reader.point_reader import WaymoReader as JReader
    from boxer_tpu.dataset.waymo import read_points_with_sweeps as j_read
    from boxer_tpu_torch.dataset.reader.point_reader import (PointReader,
                                                             WaymoReader)
    from boxer_tpu_torch.dataset.waymo import read_points_with_sweeps

    rs = np.random.RandomState(nsweeps)
    paths = []
    for i in range(3):
        rel = f"f{i}.{fmt}"
        rec = _lidar_record(rs, 50 + 10 * i)
        if fmt == "pkl":
            with open(tmp_path / rel, "wb") as f:
                pickle.dump(rec, f)
        else:
            np.savez(tmp_path / rel, points=np.concatenate(
                [rec["lidars"]["points_xyz"],
                 rec["lidars"]["points_feature"]], 1))
        paths.append(rel)
    tm = np.eye(4)
    tm[:3, 3] = [1.0, -2.0, 0.5]
    info = {"path": paths[0], "sweeps": [
        {"path": paths[1], "transform_matrix": tm, "time_lag": 0.1},
        {"path": str(tmp_path / paths[2]), "transform_matrix": None,
         "time_lag": 0.2}]}
    got = read_points_with_sweeps(info, str(tmp_path), nsweeps)
    want = j_read(info, str(tmp_path), nsweeps)
    assert _equal(got, want) and got.shape[1] == (5 if nsweeps == 1 else 6)
    assert _equal(WaymoReader()(str(tmp_path / paths[0])),
                  JReader()(str(tmp_path / paths[0])))
    raw = tmp_path / "raw.bin"
    want.tofile(raw)
    assert _equal(PointReader(want.shape[1])(str(raw)), want)


# ---------------------------------------------------------------------------
# the GT-database sampler


def _db(tmp_path, ncols, per_class=12, seed=0):
    """db infos of VEHICLE, PEDESTRIAN and CYCLIST objects of `ncols`
    columns around the origin, their points in npz files."""
    rs = np.random.RandomState(seed)
    db = {}
    for name in ("VEHICLE", "PEDESTRIAN", "CYCLIST"):
        for i in range(per_class):
            rel = f"db/{name}_{i}.npz"
            os.makedirs(tmp_path / "db", exist_ok=True)
            np.savez(tmp_path / rel, points=rs.uniform(
                -0.5, 0.5, (rs.randint(3, 9), 5)).astype(np.float32))
            cols = [rs.uniform(-30, 30, 2), [rs.uniform(-1, 1)],
                    rs.uniform(0.5, 4, 3)]
            if ncols == 9:
                cols.append(rs.normal(0, 2, 2))
            cols.append([rs.uniform(-np.pi, np.pi)])
            db.setdefault(name, []).append({
                "name": name, "path": rel,
                "box3d_lidar": np.concatenate(cols).astype(np.float32),
                "num_points_in_gt": int(rs.randint(0, 30)),
                "difficulty": int(rs.randint(0, 3))})
    return db


def _frames_for_sampler(ncols, n=6):
    out = []
    for seed in range(n):
        _, target = _frame(seed, ncols)
        names = np.asarray(["VEHICLE", "PEDESTRIAN", "CYCLIST",
                            "SIGN"])[target["labels"] - 1]
        boxes = target["boxes"].copy()
        boxes[:, :2] *= 4  # centres over ±22 m, among the db's objects
        out.append((boxes, names))
    return out


def _sample_all(sampler, root, boxes, names, rng):
    """The port's counterpart of the JAX sampler's `sample_all` (5 point
    features)."""
    return sampler.place(root, boxes, sampler.draw(names, rng), 5)


@pytest.mark.parametrize("min_points,difficulty,rate", [
    (0, -1, 1.0), (5, 1, 0.5)])
def test_database_sampler_matches_jax(tmp_path, min_points, difficulty, rate):
    from boxer_tpu.dataset.helper.database_sampler import DataBaseSampler as J
    from boxer_tpu_torch.dataset.helper.database_sampler import \
        DataBaseSampler

    db = _db(tmp_path, 7)
    groups = [{"VEHICLE": 8}, {"PEDESTRIAN": 6, "CYCLIST": 3}]
    want_s = J(copy.deepcopy(db), groups, min_points, difficulty, rate)
    got_s = DataBaseSampler(copy.deepcopy(db), groups, min_points,
                            difficulty, rate)
    assert _equal(got_s.db_infos, want_s.db_infos)
    j_rng, p_rng = np.random.RandomState(1), np.random.RandomState(1)
    placed = 0
    for _ in range(3):  # more draws than a class holds: the cursors cycle
        for boxes, names in _frames_for_sampler(7):
            want = want_s.sample_all(str(tmp_path), boxes, names, 5, j_rng)
            got = _sample_all(got_s, str(tmp_path), boxes, names, p_rng)
            assert (got is None) == (want is None)
            if want is not None:
                assert _equal(got, want)
                placed += len(want["gt_boxes"])
            for name, s in want_s.samplers.items():
                indices, idx = got_s.state()[name]
                assert idx == s._idx and np.array_equal(indices, s._indices)
    assert placed > 20
    assert j_rng.rand() == p_rng.rand()


def test_sampler_keeps_the_frames_columns(tmp_path):
    """A converted frame's 9-column boxes: the JAX sampler raises on the
    first accepted 7-column db box; the port's returns 9-column boxes,
    zero velocity for a 7-column db entry and the db's own for the port's
    9-column database."""
    from boxer_tpu.dataset.helper.database_sampler import DataBaseSampler as J
    from boxer_tpu_torch.dataset.helper.database_sampler import \
        DataBaseSampler

    boxes, names = _frames_for_sampler(9, n=1)[0]
    db7 = _db(tmp_path, 7)
    with pytest.raises(ValueError, match="along dimension 1"):
        J(copy.deepcopy(db7), DB_GROUPS).sample_all(
            str(tmp_path), boxes, names, 5, np.random.RandomState(0))
    got = _sample_all(DataBaseSampler(db7, DB_GROUPS), str(tmp_path), boxes,
                      names, np.random.RandomState(0))
    assert got["gt_boxes"].shape[1] == 9
    assert not got["gt_boxes"][:, 6:8].any()

    db9 = _db(tmp_path, 9, seed=1)
    got = _sample_all(DataBaseSampler(db9, DB_GROUPS), str(tmp_path), boxes,
                      names, np.random.RandomState(0))
    by_path = {i["path"]: i["box3d_lidar"] for v in db9.values() for i in v}
    assert got["gt_boxes"].shape[1] == 9 and got["gt_boxes"][:, 6:8].any()
    assert all(any(np.array_equal(b, v) for v in by_path.values())
               for b in got["gt_boxes"])


def test_create_gt_database_matches_jax(tmp_path):
    """The JAX tool's entries on the same frames (9-column boxes), all but
    the box: the port keeps the frame's 9 columns, the JAX tool the first
    6 and the heading; the object files hold the same points."""
    from boxer_tpu_torch.dataset.synthetic import write_waymo
    from boxer_tpu_torch.tools.preprocess import create_gt_database as tool

    port, jax_root = tmp_path / "port", tmp_path / "jax"
    write_waymo(port, {"train": 3}, PC_RANGE, 2000, (4, 10), seed=4,
                size_scale=0.25)
    shutil.copytree(port, jax_root)
    tool.main(["--root", str(port), "--info", "infos/infos_train.pkl"])
    sys.path.insert(0, str(REPO / "tools" / "preprocess"))
    try:
        import create_gt_database as j_tool
        argv = sys.argv
        sys.argv = ["create_gt_database.py", "--root", str(jax_root),
                    "--info", "infos/infos_train.pkl"]
        try:
            j_tool.main()
        finally:
            sys.argv = argv
    finally:
        sys.path.remove(str(REPO / "tools" / "preprocess"))
    load = lambda r: pickle.load(open(r / "infos" /
                                      "dbinfos_infos_train.pkl", "rb"))
    got, want = load(port), load(jax_root)
    assert sorted(got) == sorted(want) and sum(map(len, got.values())) > 10
    for name in want:
        assert len(got[name]) == len(want[name])
        for g, w in zip(got[name], want[name]):
            box = g.pop("box3d_lidar")
            assert box.shape == (9,)
            assert _equal(box[[0, 1, 2, 3, 4, 5, 8]], w.pop("box3d_lidar"))
            assert g == w
            assert _equal(np.load(port / g["path"])["points"],
                          np.load(jax_root / w["path"])["points"])


# ---------------------------------------------------------------------------
# the dataset and its loader


def _datasets(root, split, db=False):
    from boxer_tpu.dataset import build_dataset as j_dataset
    from boxer_tpu_torch.dataset import build_dataset

    cfg = dataset_config(root, db)
    return (j_dataset("detection3d", copy.deepcopy(cfg), split),
            build_dataset("detection3d", cfg, split))


def _flat(batch):
    out = {k: v for k, v in batch.items()
           if k not in ("targets", "meta", "grid_shape", "batch_size")}
    out.update({f"targets.{k}": v for k, v in batch["targets"].items()})
    return out


@pytest.mark.parametrize("split,ipu,epoch", [
    ("train", 1, 0), ("train", 1, 1), ("train", 2, 0), ("train", 2, 1),
    ("val", 1, 0), ("val", 2, 1)])
def test_waymo_batches_match_jax(waymo_root, split, ipu, epoch):
    from boxer_tpu.dataset import build_dataloader as j_loader
    from boxer_tpu_torch.dataset import build_dataloader

    j_ds, t_ds = _datasets(waymo_root, split)
    assert t_ds.get_answer_size() == j_ds.get_answer_size() == 5
    assert t_ds.grid_shape == j_ds.grid_shape == (32, 32)
    want_loader = j_loader(j_ds, split, batch_size=2, num_workers=1,
                           iter_per_update=ipu, seed=13)
    want_loader.sampler.set_epoch(epoch)
    want = list(want_loader)
    assert len(want) == len(t_ds) // 2
    for workers in (1, 2):
        loader = build_dataloader(t_ds, split, batch_size=2,
                                  num_workers=workers, iter_per_update=ipu,
                                  seed=13)
        loader.sampler.set_epoch(epoch)
        got = list(loader)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert _equal(g["meta"], w["meta"])
            assert g["grid_shape"] == w["grid_shape"]
            # the port's batch carries a microbatch's size, JAX's the batch's
            assert g["batch_size"] == w["batch_size"] // ipu
            gf, wf = _flat(g), _flat(w)
            assert sorted(gf) == sorted(wf)
            for k, v in wf.items():
                assert gf[k].shape[0] == ipu and _equal(gf[k].numpy(), v), k


def _batches(ds, workers, seed=3, epochs=(0, 1), start=None, state=None):
    """The port's train batches of `epochs` with the db sampler, each as
    (voxels, labels, valid); with start, epochs[0] from batch `start` on,
    the loader's draws restored from `state`."""
    from boxer_tpu_torch.dataset import build_dataloader

    loader = build_dataloader(ds, "train", batch_size=2, num_workers=workers,
                              seed=seed)
    loader.draw_state = state
    out, states = [], []
    for e in epochs:
        loader.sampler.set_epoch(e)
        it = loader.iterate(start if start and e == epochs[0] else 0)
        for b in it:
            out.append((b["voxels"], b["targets"]["labels"],
                        b["targets"]["valid"]))
            states.append(loader.draw_state)
    return out, states


def test_db_sampled_batches_do_not_depend_on_workers(tmp_path):
    """The db sampler's cursors move with every frame; the port's batches
    are a function of (seed, epoch, batch) and the draws before them: 1 and
    3 workers give the same, and a loader restarted at any batch from the
    recorded draw state gives what the whole run gives."""
    root = write_waymo_small(tmp_path, train=8, val=0, seed=2)
    _, ds = _datasets(root, "train", db=True)
    assert ds.db_sampler is not None
    whole, states = _batches(ds, 1)
    assert len(whole) == 8
    _, ds3 = _datasets(root, "train", db=True)
    again, _ = _batches(ds3, 3)
    assert len(again) == 8
    for (gv, gl, gm), (wv, wl, wm) in zip(again, whole):
        assert torch.equal(gv, wv) and torch.equal(gl, wl)
        assert torch.equal(gm, wm)
    # the sampler placed objects: more targets than without it
    _, plain_ds = _datasets(root, "train")
    plain, _ = _batches(plain_ds, 2)
    valid = lambda run: sum(int(m.sum()) for _, _, m in run)
    assert valid(whole) > valid(plain) + 8
    for cut in (1, 3, 5):
        _, ds_cut = _datasets(root, "train", db=True)
        epochs = (0, 1) if cut < 4 else (1,)
        tail, _ = _batches(ds_cut, 2, epochs=epochs, start=cut % 4,
                           state=states[cut - 1])
        assert len(tail) == 8 - cut
        for (gv, gl, _), (wv, wl, _) in zip(tail, whole[cut:]):
            assert torch.equal(gv, wv) and torch.equal(gl, wl), cut


# ---------------------------------------------------------------------------
# offline metrics and formatting


def _records(seed, frames=6, gt_cols=7):
    """Generated eval records: per frame GT boxes of classes 1-4 (some past
    100 m, some with few points or difficulty 2), detections near some of
    them with scores, some false positives."""
    rs = np.random.RandomState(seed)
    results = {}
    for f in range(frames):
        n = rs.randint(3, 12)
        gt = np.concatenate([rs.uniform(-110, 110, (n, 2)),
                             rs.uniform(-1, 1, (n, 1)),
                             rs.uniform(1, 5, (n, 3)),
                             rs.uniform(-np.pi, np.pi, (n, 1))], 1)
        labels = rs.randint(1, 5, n)
        hit = rs.rand(n) < 0.7
        det = gt[hit] + np.concatenate([
            rs.normal(0, 0.3, (hit.sum(), 3)),
            rs.normal(0, 0.2, (hit.sum(), 3)),
            rs.normal(0, 0.1, (hit.sum(), 1))], 1)
        fp = rs.randint(0, 5)
        det = np.concatenate([det, np.concatenate([
            rs.uniform(-80, 80, (fp, 2)), rs.uniform(-1, 1, (fp, 1)),
            rs.uniform(1, 5, (fp, 3)), rs.uniform(-3, 3, (fp, 1))], 1)])
        det_labels = np.concatenate([labels[hit], rs.randint(1, 5, fp)])
        if gt_cols == 9:
            gt = np.concatenate([gt[:, :6], rs.normal(0, 3, (n, 2)),
                                 gt[:, 6:]], 1)
        results[f"seg_frame_{f}"] = {
            "pred_boxes3d": det.astype(np.float32),
            "pred_scores": rs.rand(len(det)).astype(np.float32),
            "pred_labels": det_labels.astype(np.int64),
            "boxes3d": gt.astype(np.float32), "labels": labels,
            "difficulty": rs.randint(0, 3, n),
            "num_points_in_gt": rs.randint(0, 40, n)}
    return results


@pytest.mark.parametrize("ap_mode", ["cutoffs", "envelope"])
@pytest.mark.parametrize("matching", ["hungarian", "greedy"])
def test_evaluate_results_matches_jax(matching, ap_mode):
    from boxer_tpu.evaluate.waymo_eval import evaluate_results as j_eval
    from boxer_tpu_torch.evaluate.waymo_eval import evaluate_results

    for seed in range(3):
        records = _records(seed)
        want = j_eval(records, matching=matching, ap_mode=ap_mode)
        got = evaluate_results(records, matching=matching, ap_mode=ap_mode)
        assert sorted(got) == sorted(want) and len(want) == 8
        for k, v in want.items():
            assert abs(got[k] - v) <= 1e-3, (k, got[k], v)
        assert any(v > 0 for v in want.values())


def test_nine_column_gt_is_read_by_its_heading():
    """The trainer's records carry the frames' 9-column GT boxes: the port
    reads the heading in the last column and gives the metrics of the same
    boxes in 7 columns; the JAX evaluator takes the first 7 columns (vx as
    the heading) and gives others."""
    from boxer_tpu.evaluate.waymo_eval import evaluate_results as j_eval
    from boxer_tpu_torch.evaluate.waymo_eval import evaluate_results

    nine = _records(5, gt_cols=9)
    seven = {t: dict(r, boxes3d=r["boxes3d"][:, [0, 1, 2, 3, 4, 5, 8]])
             for t, r in nine.items()}
    want = j_eval(seven)
    assert evaluate_results(nine) == want == evaluate_results(seven)
    assert j_eval(nine) != want


def _port_metrics_module(monkeypatch):
    from boxer_tpu_torch.evaluate import waymo_eval

    monkeypatch.setitem(sys.modules, "boxer_tpu.evaluate.waymo_eval",
                        waymo_eval)
    for name in ("bev_iou", "compute_ap", "evaluate_results",
                 "relevel_difficulty"):
        monkeypatch.setattr(test_waymo_metrics, name,
                            getattr(waymo_eval, name))


@pytest.mark.parametrize("case", sorted(
    n for n in dir(test_waymo_metrics) if n.startswith("test_")))
def test_waymo_metrics_fixtures_on_the_port(monkeypatch, case):
    """Each test of `tests/test_waymo_metrics.py` with the port's
    evaluator in place of the JAX package's."""
    _port_metrics_module(monkeypatch)
    getattr(test_waymo_metrics, case)()


def test_format_for_evalai_matches_jax(waymo_root, tmp_path):
    """The records of a batch of random outputs: scores within 1e-6, the
    same (label, box) set in each frame, the same metadata; and
    `prepare_for_evaluation` writes them to results.pkl."""
    j_ds, t_ds = _datasets(waymo_root, "val")
    items = [t_ds.load(i, np.random.RandomState(i), None) for i in range(2)]
    metas = t_ds.collate(items)["meta"]
    rs = np.random.RandomState(0)
    output = {"pred_logits": rs.randn(2, 60, 5).astype(np.float32),
              "pred_boxes": rs.rand(2, 60, 7).astype(np.float32)}
    want = j_ds.format_for_evalai(output, metas)
    got = t_ds.format_for_evalai({k: torch.from_numpy(v)
                                  for k, v in output.items()}, metas)
    assert sorted(got) == sorted(want) == [m["token"] for m in metas]
    for token, w in want.items():
        g = got[token]
        assert sorted(g) == sorted(w)
        assert np.all(np.diff(g["pred_scores"]) <= 0)
        order = np.lexsort((w["pred_labels"], -w["pred_scores"]))
        g_order = np.lexsort((g["pred_labels"], -g["pred_scores"]))
        np.testing.assert_allclose(g["pred_scores"][g_order],
                                   w["pred_scores"][order], rtol=1e-6)
        assert np.array_equal(g["pred_labels"][g_order],
                              w["pred_labels"][order])
        np.testing.assert_allclose(g["pred_boxes3d"][g_order],
                                   w["pred_boxes3d"][order], rtol=1e-6,
                                   atol=1e-5)
        for k in ("metadata", "boxes3d", "labels", "difficulty",
                  "num_points_in_gt", "classes"):
            assert _equal(g[k], w[k]), k
    path = t_ds.prepare_for_evaluation(got, str(tmp_path))
    assert path == str(tmp_path / "results.pkl")
    with open(path, "rb") as f:
        assert _equal(pickle.load(f), got)
