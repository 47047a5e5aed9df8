"""Waymo Open 3D detection task; port of `boxer_tpu/dataset/waymo.py`.

Parity targets: reference `e2edet/dataset/waymo.py` — WaymoDetection
(pkl infos + per-frame lidar pkl, label map :28-35, class/min-points filter
WaymoPreparation :316-330), `format_for_evalai` pc_range denormalization +
top-125 (:232-313), `prepare_for_evaluation` (:162-230: `results.pkl`
always, the protobuf only where `waymo_open_dataset` imports; the pickle
is what `evaluate/waymo_eval.py` reads); plus `dataset/helper/
point_detection.py` (infos/load_interval/sweeps) and `collate_fn.py:115-196`
(collate3d).

Collate pads voxels to the processor's fixed `max_voxel_num` capacity with
batch-prefixed coords (padding batch = -1) and GT boxes to `max_boxes`
with a validity mask, as the JAX package does. The top-125 runs on the
outputs' device (`format_for_evalai`), sorted by score. A frame's
GT-database draws are taken apart from its load (`draw`, then
`load(..., drawn)`), which the loader does in batch order.
"""

import copy
import math
import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from boxer_tpu_torch.dataset.processor.processors import build_processor
from boxer_tpu_torch.dataset.processor.voxelizer import pad_voxels
from boxer_tpu_torch.utils.general import top_k
from boxer_tpu_torch.utils.registry import TASK_REGISTRY

LABEL_TO_IDX = {
    "UNKNOWN": 0,
    "VEHICLE": 1,
    "PEDESTRIAN": 2,
    "SIGN": 3,
    "CYCLIST": 4,
}
IDX_TO_LABEL = ("UNKNOWN", "VEHICLE", "PEDESTRIAN", "SIGN", "CYCLIST")


def read_lidar_points(path: str) -> np.ndarray:
    """Per-frame lidar pkl -> (N, 5) points with tanh-normalized intensity
    (reference `det3d/general.py:130-139`). Also accepts .npz with a
    'points' array (synthetic/test corpora)."""
    if path.endswith(".npz"):
        return np.load(path)["points"].astype(np.float32)
    with open(path, "rb") as f:
        obj = pickle.load(f)
    xyz = obj["lidars"]["points_xyz"]
    feat = obj["lidars"]["points_feature"].copy()
    feat[:, 0] = np.tanh(feat[:, 0])
    return np.concatenate([xyz, feat], axis=-1).astype(np.float32)


def read_sweep(sweep: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """One prior sweep: load, apply ego-motion transform, return
    (points (N, F), time_lag (N, 1)) — reference `det3d/general.py:142-163`."""
    pts = read_lidar_points(sweep["path"])
    tm = sweep.get("transform_matrix")
    if tm is not None:
        tm = np.asarray(tm, np.float32)
        homo = np.concatenate(
            [pts[:, :3], np.ones((len(pts), 1), np.float32)], axis=1)
        pts = pts.copy()
        pts[:, :3] = (homo @ tm.T)[:, :3]
    times = np.full((len(pts), 1), float(sweep.get("time_lag", 0.0)),
                    np.float32)
    return pts, times


def read_points_with_sweeps(info: Dict, root_path: str,
                            nsweeps: int) -> np.ndarray:
    """Concatenate the key frame with nsweeps-1 prior sweeps, appending a
    time-lag feature column (reference `det3d/general.py:39-70`)."""
    path = info["path"]
    if not os.path.isabs(path):
        path = os.path.join(root_path, path)
    points = read_lidar_points(path)
    if nsweeps <= 1:
        return points
    pts_list = [points]
    time_list = [np.zeros((len(points), 1), np.float32)]
    for sweep in info.get("sweeps", [])[: nsweeps - 1]:
        sweep = dict(sweep)
        if not os.path.isabs(sweep["path"]):
            sweep["path"] = os.path.join(root_path, sweep["path"])
        p, t = read_sweep(sweep)
        pts_list.append(p)
        time_list.append(t)
    return np.hstack([np.concatenate(pts_list, axis=0),
                      np.concatenate(time_list, axis=0)])


def grid_shape(pc_range, voxel_size):
    """(nx, ny): the voxelizer's BEV grid over pc_range, the rounded count
    of pillars as `WaymoDetection.grid_shape` takes it (469 x 469 for the
    shipped config's 150 m at 0.32 m). A model run at a smaller grid would
    fold the last column's pillars into the next row."""
    lo, hi = (np.asarray(pc_range[i:i + 3], np.float32) for i in (0, 3))
    size = np.round((hi - lo) / np.asarray(voxel_size, np.float32))
    return int(size[0]), int(size[1])


def format_for_evalai(pred_logits, pred_boxes, pc_range, topk: int = 125):
    """pred_logits (B, NQ, C); pred_boxes (B, NQ, 7) normalized (cx, cy, cz,
    l, w, h, angle); pc_range (x0, y0, z0, x1, y1, z1) in metres.

    Denormalizes the boxes (centre and size by pc_range, angle * 2π - π),
    takes the sigmoid and the top `topk` (query, class) pairs of each frame.
    Returns {"pred_scores" (B, K), "pred_labels" (B, K) int64, the class
    index, "pred_boxes3d" (B, K, 7) metric}, sorted by descending score
    (the JAX package's top-k is unordered)."""
    b, nq, c = pred_logits.shape
    lo = torch.tensor(pc_range[:3], dtype=torch.float32,
                      device=pred_boxes.device)
    size = torch.tensor(pc_range[3:6], dtype=torch.float32,
                        device=pred_boxes.device) - lo
    boxes = pred_boxes.float()
    boxes = torch.cat([boxes[..., :3] * size + lo, boxes[..., 3:6] * size,
                       boxes[..., 6:] * (2 * math.pi) - math.pi], dim=-1)
    prob = torch.sigmoid(pred_logits.float()).reshape(b, nq * c)
    scores, idx = top_k(prob, min(topk, nq * c))
    q = idx // c
    return {"pred_scores": scores, "pred_labels": idx % c,
            "pred_boxes3d": torch.gather(boxes, 1,
                                         q[..., None].expand(-1, -1, 7))}


class WaymoPreparation:
    """Class + min-points filter (reference `waymo.py:316-330`)."""

    def __init__(self, classes: List[int], min_points: int):
        self.classes = np.asarray(classes)
        self.min_points = min_points

    def __call__(self, target):
        keep = (target["labels"][:, None] == self.classes).any(axis=1)
        keep = keep & (target["num_points_in_gt"] >= self.min_points)
        out = dict(target)
        out["labels"] = target["labels"][keep]
        out["boxes"] = target["boxes"][keep]
        return out


@TASK_REGISTRY.register("detection3d")
class WaymoDetection:
    def __init__(self, config, dataset_type: str, imdb_file: Dict,
                 data_root=None):
        self.config = config
        self.dataset_type = dataset_type
        self.use_mask = False
        self.max_boxes = int(config.get("max_boxes", 250))
        self.nsweeps = int(config.get("nsweeps", 1))
        self.pc_range = np.asarray(config["pc_range"], np.float32)
        self.classes = list(config["classes"])
        self.class_ids = [LABEL_TO_IDX[c] for c in self.classes]

        root = data_root or os.environ.get("E2E_DATASETS", ".")
        self.root_path = self._abs(root, imdb_file["root_path"])
        info_path = self._abs(root, imdb_file["info_path"])
        with open(info_path, "rb") as f:
            infos_all = pickle.load(f)
        self.infos = infos_all[:: int(imdb_file.get("load_interval", 1))]

        self.db_sampler = None
        if imdb_file.get("db_sampler") is not None and dataset_type == "train":
            from boxer_tpu_torch.dataset.helper.database_sampler import \
                DataBaseSampler

            cfg = imdb_file["db_sampler"]
            db_info_path = self._abs(root, cfg["db_info_path"])
            if os.path.exists(db_info_path):
                with open(db_info_path, "rb") as f:
                    db_info = pickle.load(f)
                self.db_sampler = DataBaseSampler(
                    db_info, cfg["groups"],
                    min_points=cfg.get("min_points", 0),
                    difficulty=cfg.get("difficulty", -1),
                    rate=cfg.get("rate", 1.0))

        self.prepare = WaymoPreparation(self.class_ids,
                                        config.get("min_points", 0))
        procs = config.get("processors", {})
        key = "train_processor" if dataset_type == "train" else "test_processor"
        self.processor = build_processor(procs[key]) if key in procs else None
        self.max_voxel_num = _find_max_voxel_num(procs.get(key, {}))
        self.grid_shape = grid_shape(self.pc_range, config["voxel_size"])

    @staticmethod
    def _abs(root, p):
        return p if os.path.isabs(p) else os.path.join(root, p)

    def get_answer_size(self) -> int:
        return len(LABEL_TO_IDX)

    def __len__(self):
        return len(self.infos)

    def _target(self, info):
        """A frame's annotations after the class and min-points filter."""
        names = info.get("gt_names", [])
        target = {
            "metadata": {"token": info["token"]},
            "boxes": info.get("gt_boxes", np.zeros((0, 9), np.float32)
                              ).astype(np.float32),
            "labels": np.asarray([LABEL_TO_IDX[n] for n in names],
                                 np.int64).reshape(-1),
            "num_points_in_gt": np.asarray(
                info.get("num_points_in_gt", [1] * len(names)), np.int64),
            "difficulty": np.asarray(
                info.get("difficulty", [0] * len(names)), np.int8),
        }
        target["raw_boxes"] = target["boxes"].copy()
        target["raw_labels"] = target["labels"].copy()
        return self.prepare(target)

    @staticmethod
    def _names(target):
        return np.asarray([IDX_TO_LABEL[l] for l in target["labels"]])

    def draw(self, idx: int, rng: np.random.RandomState) -> Optional[List]:
        """Frame idx's GT-database draws (`DataBaseSampler.draw`), None
        without a db sampler. Advances the sampler's cursors."""
        if self.db_sampler is None:
            return None
        return self.db_sampler.draw(self._names(self._target(self.infos[idx])),
                                    rng)

    def draw_state(self):
        """The db sampler's cursors ({class: (order, cursor)}, the orders as
        tensors, as a checkpoint holds them), None without one."""
        if self.db_sampler is None:
            return None
        return {name: (torch.from_numpy(order), idx)
                for name, (order, idx) in self.db_sampler.state().items()}

    def set_draw_state(self, state):
        """Restore `draw_state()`'s cursors; the orders may lie on any
        device (a checkpoint restores them onto the trainer's)."""
        self.db_sampler.set_state({name: (order.cpu().numpy(), idx)
                                   for name, (order, idx) in state.items()})

    def load(self, idx: int, rng: np.random.RandomState,
             drawn: Optional[List]):
        """One frame through the db sampler and the processors: the db
        sampler places `drawn`, `draw`'s result for this frame (None
        without a db sampler); the processors draw from `rng`."""
        info = self.infos[idx]
        points = read_points_with_sweeps(info, self.root_path, self.nsweeps)
        target = self._target(info)

        if self.db_sampler is not None:
            sampled = self.db_sampler.place(self.root_path, target["boxes"],
                                            drawn, points.shape[1])
            if sampled is not None:
                target = dict(target)
                target["boxes"] = np.concatenate(
                    [target["boxes"], sampled["gt_boxes"]], axis=0)
                target["labels"] = np.concatenate(
                    [target["labels"],
                     np.asarray([LABEL_TO_IDX[n] for n in sampled["gt_names"]],
                                np.int64)], axis=0)
                points = np.concatenate([sampled["points"], points], axis=0)

        sample = {"points": points}
        if self.processor is not None:
            sample, target = self.processor(sample, target, rng)
        return sample, target

    # ------------------------------------------------------------------

    def collate(self, items: List[Tuple[Dict, Dict]]):
        b = len(items)
        nt = self.max_boxes
        mv = self.max_voxel_num

        all_v, all_c, all_n = [], [], []
        labels = np.zeros((b, nt), np.int32)
        boxes = np.zeros((b, nt, 7), np.float32)
        valid = np.zeros((b, nt), bool)
        metas = []
        for i, (sample, target) in enumerate(items):
            v, c, n = pad_voxels(sample["voxels"], sample["coordinates"],
                                 sample["num_points_per_voxel"], i, mv)
            all_v.append(v)
            all_c.append(c)
            all_n.append(n)

            tb = target.get("boxes")
            if tb is not None and len(tb) > 0:
                k = min(len(tb), nt)
                boxes[i, :k] = tb[:k, :7]
                labels[i, :k] = target["labels"][:k]
                valid[i, :k] = True
            metas.append({
                "token": target["metadata"]["token"],
                "raw_boxes": target.get("raw_boxes"),
                "raw_labels": target.get("raw_labels"),
                "difficulty": target.get("difficulty"),
                "num_points_in_gt": target.get("num_points_in_gt"),
            })

        return {
            "voxels": np.concatenate(all_v, axis=0),
            "coordinates": np.concatenate(all_c, axis=0),
            "num_points_per_voxel": np.concatenate(all_n, axis=0),
            "targets": {"labels": labels, "boxes": boxes, "valid": valid},
            "grid_shape": self.grid_shape,
            "batch_size": b,
            "meta": metas,
        }

    # ------------------------------------------------------------------

    def format_for_evalai(self, output: Dict, metas: List[Dict],
                          topk: int = 125, local_eval: bool = True):
        """{token: record} of a batch's outputs (tensors on any device):
        the top-`topk` scores, labels and metric boxes (`format_for_evalai`,
        on the outputs' device, then one copy each); with local_eval the
        frame's token, raw boxes, labels, difficulty, points per box and
        the classes, which the offline metrics read."""
        top = format_for_evalai(torch.as_tensor(output["pred_logits"]),
                                torch.as_tensor(output["pred_boxes"]),
                                self.pc_range.tolist(), topk)
        top = {k: v.cpu().numpy() for k, v in top.items()}
        results = {}
        for i, meta in enumerate(metas):
            out = {k: v[i] for k, v in top.items()}
            if local_eval:
                out.update({
                    "metadata": {"token": meta["token"]},
                    "boxes3d": meta.get("raw_boxes"),
                    "labels": meta.get("raw_labels"),
                    "difficulty": meta.get("difficulty"),
                    "num_points_in_gt": meta.get("num_points_in_gt"),
                    "classes": copy.copy(self.classes),
                })
            results[meta["token"]] = out
        return results

    def prepare_for_evaluation(self, predictions: Dict, result_path: str):
        """Writes `results.pkl` always; additionally writes the waymo
        `detection_pred.bin` protobuf when waymo_open_dataset is available
        (reference `waymo.py:162-230`). Returns the last path written."""
        os.makedirs(result_path, exist_ok=True)
        pkl_path = os.path.join(result_path, "results.pkl")
        with open(pkl_path, "wb") as f:
            pickle.dump(predictions, f)

        try:
            from waymo_open_dataset.protos import metrics_pb2
        except ImportError:
            return pkl_path

        objects = metrics_pb2.Objects()
        for token, pred in predictions.items():
            box3d = np.asarray(pred["pred_boxes3d"])
            scores = np.asarray(pred["pred_scores"])
            lbls = np.asarray(pred["pred_labels"])
            for i in range(len(box3d)):
                o = metrics_pb2.Object()
                o.context_name = token.split("_frame_")[0]
                det = box3d[i]
                o.object.box.center_x = float(det[0])
                o.object.box.center_y = float(det[1])
                o.object.box.center_z = float(det[2])
                o.object.box.length = float(det[3])
                o.object.box.width = float(det[4])
                o.object.box.height = float(det[5])
                o.object.box.heading = float(det[-1])
                o.score = float(scores[i])
                o.object.type = int(lbls[i])
                objects.objects.append(o)
        bin_path = os.path.join(result_path, "detection_pred.bin")
        with open(bin_path, "wb") as f:
            f.write(objects.SerializeToString())
        return bin_path


def _find_max_voxel_num(proc_cfg, default: int = 32000) -> int:
    """Extract max_voxel_num from the (possibly nested) processor config."""
    if not isinstance(proc_cfg, dict):
        return default
    if proc_cfg.get("type") == "voxelize":
        return int(proc_cfg.get("params", {}).get("max_voxel_num", default))
    params = proc_cfg.get("params", {})
    for sub in params.get("preprocessors", []) or []:
        found = _find_max_voxel_num(sub, -1)
        if found > 0:
            return found
    return default
