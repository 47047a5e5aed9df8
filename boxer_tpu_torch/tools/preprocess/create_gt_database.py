"""Build the GT-crop database for the GT-database sampler; port of
`tools/preprocess/create_gt_database.py`.

Parity target: reference `tools/preprocess/create_gt_database.py`: crops
each annotated object's points (box frame, centered) into per-object files
and a db-info pkl grouped by class. Unlike the JAX package's tool, an
entry's `box3d_lidar` keeps all of the frame's `gt_boxes` columns (the
converter's 9: x, y, z, l, w, h, vx, vy, heading), which the sampler
places beside the frame's boxes.

Layout: `<root>/<info>` is the infos pkl (a list of frames, each with
`token`, `path` of its lidar pkl or npz, relative to root or absolute,
`gt_boxes`, `gt_names` and optionally `difficulty`); the object points go
to `<root>/<out>/<token>_<index>_<class>.npz` and the db infos to
`<root>/infos/dbinfos_<basename of info>`.

Usage:
  python -m boxer_tpu_torch.tools.preprocess.create_gt_database \
      --root <processed_root> --info infos/infos_train.pkl --out gt_database
"""

import argparse
import math
import os
import pickle

import numpy as np

from boxer_tpu_torch.dataset.waymo import read_lidar_points


def points_in_box(points, box):
    """Axis-align points into the box frame (box: x, y, z, l, w, h, ...,
    heading last); return mask + centered points."""
    c, s = math.cos(-box[-1]), math.sin(-box[-1])
    local = points[:, :3] - box[:3]
    x = local[:, 0] * c - local[:, 1] * s
    y = local[:, 0] * s + local[:, 1] * c
    z = local[:, 2]
    keep = ((np.abs(x) <= box[3] / 2) & (np.abs(y) <= box[4] / 2)
            & (np.abs(z) <= box[5] / 2))
    out = points[keep].copy()
    out[:, :3] -= box[:3]
    return keep, out


def create_gt_database(root: str, info: str, out: str = "gt_database"):
    """Write the object files and the db infos; returns the db infos' path
    and {class: entries}."""
    with open(os.path.join(root, info), "rb") as f:
        infos = pickle.load(f)

    os.makedirs(os.path.join(root, out), exist_ok=True)
    db = {}
    for frame in infos:
        path = frame["path"]
        if not os.path.isabs(path):
            path = os.path.join(root, path)
        points = read_lidar_points(path)
        difficulty = frame.get("difficulty", [0] * len(frame["gt_names"]))
        for gi, (box, name) in enumerate(zip(frame["gt_boxes"],
                                             frame["gt_names"])):
            _, obj_points = points_in_box(points, box)
            if len(obj_points) == 0:
                continue
            rel = f"{out}/{frame['token']}_{gi}_{name}.npz"
            np.savez(os.path.join(root, rel), points=obj_points)
            db.setdefault(str(name), []).append({
                "name": str(name),
                "path": rel,
                "box3d_lidar": np.asarray(box, np.float32),
                "num_points_in_gt": int(len(obj_points)),
                "difficulty": int(difficulty[gi]),
            })
    db_path = os.path.join(root, "infos", "dbinfos_" + os.path.basename(info))
    os.makedirs(os.path.dirname(db_path), exist_ok=True)
    with open(db_path, "wb") as f:
        pickle.dump(db, f)
    return db_path, db


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", required=True)
    parser.add_argument("--info", required=True)
    parser.add_argument("--out", default="gt_database")
    args = parser.parse_args(argv)
    db_path, db = create_gt_database(args.root, args.info, args.out)
    print({k: len(v) for k, v in db.items()}, "->", db_path)


if __name__ == "__main__":
    main()
