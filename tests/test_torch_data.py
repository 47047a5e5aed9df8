"""The port's config, data pipeline, COCO evaluator and event writer
against the JAX package, on the CPU.

- Config: every shipped yaml loads through the port's `Configuration` (its
  own copy of the tree, `${device_count:}` = 1 on the CPU) to the same
  dict as the JAX package's (its `jax.device_count` fixed to 1), with a
  dotlist; and the copied tree is byte-identical to `boxer_tpu/config/`.
- Batches: on a synthetic on-disk COCO (polygon masks, non-contiguous
  category ids), the port's `COCODetection` and loader give the JAX
  package's batches for the same seed, every batch of the epoch: the
  train processors (flip, random_select of resize or resize-crop-resize),
  the LSJ processors (resize_scale, fixed_size_crop) and the val
  processors, iter_per_update 1 and 2, an epoch after `set_epoch(1)`, and
  the instance-mask crops. Exact for integers, masks and crops; images and
  boxes within 1e-6.
- Eval: the port's `COCOEval`/`CocoEvaluator` give the JAX package's stats
  exactly on the cases of `tests/test_coco_eval.py` (bbox, and segm on the
  same boxes as RLE masks), the formatting round trip (`format_for_evalai`
  with masks, `prepare_for_evaluation`) gives the same records, and the
  merge and dedupe of gathered results agree.
- The TensorBoard event file round trip of `tests/test_tb_writer.py`.
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget)
import filecmp
import json
import os
import struct
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax

REPO = Path(__file__).resolve().parents[1]
JAX_CONFIG = REPO / "boxer_tpu" / "config"
PORT_CONFIG = REPO / "boxer_tpu_torch" / "config"
SHIPPED = sorted(str(p.relative_to(JAX_CONFIG))
                 for p in JAX_CONFIG.rglob("*.yaml"))
CATEGORIES = [{"id": 1, "name": "a"}, {"id": 3, "name": "b"},
              {"id": 7, "name": "c"}]
NORMALIZE = {"type": "normalize", "params": {
    "mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]}}
TO_TENSOR = {"type": "to_tensor", "params": {}}


def write_coco(root, n_images=8, seed=1, hw=(96, 128),
               categories=CATEGORIES, per_image=(2, 3)):
    """A COCO directory: n_images seeded JPEGs under images/, with 2-3
    polygon annotations each (a pentagon in a random box) in train.json and
    val.json, and the images alone in test.json."""
    root = Path(root)
    os.makedirs(root / "images", exist_ok=True)
    rng = np.random.RandomState(seed)
    h, w = hw
    images, annotations = [], []
    for img_id in range(1, n_images + 1):
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
            root / "images" / f"{img_id}.jpg")
        images.append({"id": img_id, "height": h, "width": w,
                       "file_name": f"{img_id}.jpg"})
        for _ in range(rng.randint(per_image[0], per_image[1] + 1)):
            bw = float(rng.randint(w // 6, w // 2))
            bh = float(rng.randint(h // 6, h // 2))
            x = float(rng.randint(0, w - int(bw)))
            y = float(rng.randint(0, h - int(bh)))
            poly = [x, y, x + bw, y, x + bw, y + bh, x + bw / 2,
                    y + 0.6 * bh, x, y + bh]
            annotations.append({
                "id": len(annotations) + 1, "image_id": img_id,
                "category_id": int(categories[rng.randint(
                    len(categories))]["id"]),
                "bbox": [x, y, bw, bh], "area": bw * bh, "iscrowd": 0,
                "segmentation": [poly]})
    anno = {"images": images, "annotations": annotations,
            "categories": categories}
    for split in ("train", "val"):
        with open(root / f"{split}.json", "w") as f:
            json.dump(anno, f)
    with open(root / "test.json", "w") as f:
        json.dump({"images": images, "categories": categories}, f)
    return root


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    return write_coco(tmp_path_factory.mktemp("torch_data_coco"))


# ---------------------------------------------------------------- config

def test_yaml_tree_is_a_copy():
    ported = sorted(str(p.relative_to(PORT_CONFIG))
                    for p in PORT_CONFIG.rglob("*.yaml"))
    assert ported == SHIPPED and len(SHIPPED) > 5
    match, mismatch, errors = filecmp.cmpfiles(JAX_CONFIG, PORT_CONFIG,
                                               SHIPPED, shallow=False)
    assert mismatch == [] and errors == [], (mismatch, errors)


@pytest.mark.parametrize("rel", SHIPPED)
def test_shipped_config_loads_as_jax(rel, monkeypatch):
    from boxer_tpu.utils.config import Configuration as JConfiguration
    from boxer_tpu_torch.utils.config import Configuration

    monkeypatch.setattr(jax, "device_count", lambda: 1)
    opts = ["training.batch_size=4", "model_config.boxer2d.hidden_dim=128",
            "optimizer.params.lr=3.0e-4"]
    extra = {"task": "detection", "model": "boxer2d"}
    want = JConfiguration(str(JAX_CONFIG / rel), opts=opts, extra=extra)
    got = Configuration(str(PORT_CONFIG / rel), opts=opts, extra=extra,
                        device="cpu")
    assert got.get_config().to_dict() == want.get_config().to_dict()
    assert got.get_config().distributed.world_size == 1
    got.freeze()
    with pytest.raises(AttributeError):
        got.get_config().task = "detection3d"


# ---------------------------------------------------------------- batches

def _processors(kind):
    if kind in ("test", "fixed"):               # no random draw
        preps = [{"type": "random_resize",
                  "params": {"min_size": 96, "max_size": 160}}]
    elif kind == "lsj":
        preps = [{"type": "random_horizontal_flip", "params": {"prob": 0.5}},
                 {"type": "resize_scale", "params": {
                     "min_scale": 0.5, "max_scale": 1.5,
                     "target_height": 160, "target_width": 160}},
                 {"type": "fixed_size_crop", "params": {
                     "crop_height": 160, "crop_width": 160}}]
    else:
        preps = [
            {"type": "random_horizontal_flip", "params": {"prob": 0.5}},
            {"type": "random_select", "params": {"probs": [0.5, 0.5],
                                                 "preprocessors": [
                {"type": "random_resize",
                 "params": {"min_size": [64, 97, 16], "max_size": 160}},
                {"type": "compose", "params": {"preprocessors": [
                    {"type": "random_resize",
                     "params": {"min_size": [80, 113, 16]}},
                    {"type": "random_size_crop",
                     "params": {"min_size": 48, "max_size": 96}},
                    {"type": "random_resize",
                     "params": {"min_size": [64, 97, 16],
                                "max_size": 160}}]}}]}}]
    return {"type": "compose",
            "params": {"preprocessors": preps + [TO_TENSOR, NORMALIZE]}}


def _dataset_config(root, kind):
    key = "image_test_processor" if kind == "test" else "image_train_processor"
    return {"use_mask": True, "max_boxes": 6, "canvas_size": [160, 160],
            "imdb_files": {s: {"anno_file": str(root / f"{s}.json"),
                               "image_folder": str(root / "images")}
                           for s in ("train", "val", "test")},
            "processors": {key: _processors(kind)}}


def _meta_equal(a, b):
    return len(a) == len(b) and all(
        x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
        for x, y in zip(a, b))


def _flat(batch):
    out = {k: v for k, v in batch.items() if k not in ("targets", "meta")}
    out.update({f"targets.{k}": v for k, v in batch["targets"].items()})
    return out


def _batches_equal(want, got, ipu=1):
    """A port batch against the JAX loader's: exact for integers, masks and
    crops, images and boxes within 1e-6. Returns whether it has a mask."""
    assert _meta_equal(got["meta"], want["meta"])
    w_flat, g_flat = _flat(want), _flat(got)
    assert sorted(g_flat) == sorted(w_flat)
    for k, w in w_flat.items():
        g = g_flat[k]
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu", k
        g = g.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, k
        assert g.shape[0] == ipu, k
        if np.issubdtype(w.dtype, np.floating) and k != \
                "targets.instance_masks":
            assert np.abs(g - w).max() <= 1e-6, k
        else:
            assert np.array_equal(g, w), k
    return w_flat["targets.instance_masks"].sum() > 0


# (split, processors, iter_per_update, epoch, data shards, cache_mode); the
# cache_mode cases take the shard-first sampler on both sides, the one at
# two shards with the draw-free processors (the port folds a rank into a
# batch's augmentation seed at more than one shard, the JAX loader does not)
LOADER_CASES = [
    pytest.param("train", "train", 1, 0, 1, False, id="train-train-1-0"),
    pytest.param("train", "train", 2, 1, 1, False, id="train-train-2-1"),
    pytest.param("train", "lsj", 1, 0, 1, False, id="train-lsj-1-0"),
    pytest.param("val", "test", 1, 0, 1, False, id="val-test-1-0"),
    pytest.param("train", "train", 1, 1, 1, True, id="train-train-1-1-cache"),
    pytest.param("train", "fixed", 1, 2, 2, True,
                 id="train-fixed-1-2-cache-2shards")]


@pytest.mark.parametrize("split,kind,ipu,epoch,shards,cache", LOADER_CASES)
def test_loader_batches_match_jax(coco_root, split, kind, ipu, epoch, shards,
                                  cache, monkeypatch):
    from boxer_tpu.dataset import build_dataloader as j_loader
    from boxer_tpu.dataset import build_dataset as j_dataset
    from boxer_tpu.dataset.helper import sampler as j_sampler
    from boxer_tpu_torch.dataset import build_dataloader, build_dataset
    from boxer_tpu_torch.dataset.helper import sampler

    cfg = dict(_dataset_config(coco_root, kind), cache_mode=cache)
    j_ds, t_ds = (j_dataset("detection", cfg, split),
                  build_dataset("detection", cfg, split))
    assert t_ds.get_answer_size() == j_ds.get_answer_size() == 3
    assert t_ds.label_to_cat_id == j_ds.label_to_cat_id == {0: 1, 1: 3, 2: 7}
    n_masks = 0
    monkeypatch.setattr(jax, "process_count", lambda: shards)
    for rank in range(shards):
        monkeypatch.setattr(jax, "process_index", lambda: rank)
        want_loader = j_loader(j_ds, split, batch_size=2, num_workers=1,
                               iter_per_update=ipu, seed=11)
        got_loader = build_dataloader(t_ds, split, batch_size=2,
                                      num_workers=2, iter_per_update=ipu,
                                      seed=11, replicas=shards, rank=rank)
        assert type(want_loader.sampler) is (
            j_sampler.ShardDistributedSampler if cache
            else j_sampler.DistributedSampler)
        assert type(got_loader.sampler).__name__ == \
            type(want_loader.sampler).__name__
        assert isinstance(got_loader.sampler, sampler.DistributedSampler)
        assert len(got_loader) == len(want_loader) == 4 // shards
        want_loader.sampler.set_epoch(epoch)
        got_loader.sampler.set_epoch(epoch)
        pairs = list(zip(list(want_loader), list(got_loader)))
        assert len(pairs) == 4 // shards
        for want, got in pairs:
            n_masks += int(_batches_equal(want, got, ipu))
    assert n_masks == 4
    assert (t_ds._image_cache is not None) == cache


@pytest.mark.parametrize("n", range(7, 12))
def test_shard_sampler_matches_jax(n):
    from boxer_tpu.dataset.helper.sampler import ShardDistributedSampler as J
    from boxer_tpu_torch.dataset.helper.sampler import ShardDistributedSampler

    for replicas in range(1, 5):
        shards = []
        for rank in range(replicas):
            for shuffle in (True, False):
                got = ShardDistributedSampler(n, replicas, rank, shuffle, 3)
                want = J(n, replicas, rank, shuffle, 3)
                for epoch in range(3):
                    got.set_epoch(epoch)
                    want.set_epoch(epoch)
                    assert list(got) == list(want)
                    assert len(got) == len(want) == -(-n // replicas)
            shards += list(ShardDistributedSampler(n, replicas, rank,
                                                   shuffle=False))
        # unshuffled, the shards are the padded index range cut in turn
        pad = -(-n // replicas) * replicas - n
        assert shards == list(range(n)) + list(range(pad))


@pytest.mark.parametrize("cache", [False, True])
def test_build_dataloader_picks_the_sampler_by_cache_mode(coco_root, cache):
    from boxer_tpu_torch.dataset import build_dataloader, build_dataset
    from boxer_tpu_torch.dataset.helper.sampler import (
        DistributedSampler,
        ShardDistributedSampler,
    )

    cfg = dict(_dataset_config(coco_root, "train"), cache_mode=cache)
    ds = build_dataset("detection", cfg, "train")
    loader = build_dataloader(ds, "train", batch_size=2, replicas=3, rank=1)
    assert type(loader.sampler) is (ShardDistributedSampler if cache
                                    else DistributedSampler)
    assert (loader.sampler.num_replicas, loader.sampler.rank) == (3, 1)


def test_cache_mode_under_threads(tmp_path):
    """The image cache shared by loader threads: 12 threads load every
    image of a cache_mode dataset in their own order, switching every
    microsecond; each load equals a single-threaded load of the uncached
    dataset, the cache holds one image a file, and writing into a handed
    out image leaves the cache as it was."""
    import sys
    import threading

    from boxer_tpu_torch.dataset import build_dataset

    root = write_coco(tmp_path / "coco", n_images=5, seed=6)
    cfg = _dataset_config(root, "fixed")
    want = [build_dataset("detection", cfg, "train").load(
        i, np.random.RandomState(0))[0]["image"] for i in range(5)]
    ds = build_dataset("detection", dict(cfg, cache_mode=True), "train")
    got, errors = [], []

    def work(seed):
        try:
            for i in np.random.RandomState(seed).permutation(5):
                image = ds.load(int(i), np.random.RandomState(0))[0]["image"]
                got.append((int(i), np.array(image)))
                image[...] = 0                  # an in-place augmentation
        except Exception as e:                  # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(got) == 12 * 5
    for i, image in got:
        np.testing.assert_array_equal(image, np.asarray(want[i]))
    assert sorted(ds._image_cache) == sorted(ds.ids)
    for image_id, img in ds._image_cache.items():
        path = root / "images" / f"{image_id}.jpg"
        np.testing.assert_array_equal(np.asarray(img), np.asarray(
            Image.open(path).convert("RGB")))


def test_cache_mode_second_epoch_reads_no_file(tmp_path):
    """cache_mode: after an epoch the image files are deleted; the second
    epoch equals a fresh loader's and the JAX loader's (taken before the
    deletion), so it was read from the cache, and the first epoch's
    augmentations (flips, resizes) did not write into the cache."""
    from boxer_tpu.dataset import build_dataloader as j_loader
    from boxer_tpu.dataset import build_dataset as j_dataset
    from boxer_tpu_torch.dataset import build_dataloader, build_dataset

    root = write_coco(tmp_path / "coco", n_images=6, seed=4)
    cfg = dict(_dataset_config(root, "train"), cache_mode=True)

    def loader():
        return build_dataloader(build_dataset("detection", cfg, "train"),
                                "train", batch_size=2, num_workers=3,
                                seed=7)

    want_loader = j_loader(j_dataset("detection", cfg, "train"), "train",
                           batch_size=2, num_workers=1, seed=7)
    want_loader.sampler.set_epoch(1)
    want = list(want_loader)
    fresh = loader()
    fresh.sampler.set_epoch(1)
    fresh = list(fresh)
    cached = loader()
    first = list(cached)
    assert len(cached.dataset._image_cache) == 6
    for f in (root / "images").iterdir():
        f.unlink()
    cached.sampler.set_epoch(1)
    second = list(cached)
    assert len(second) == len(fresh) == len(want) == len(first) == 3
    for w, f, g in zip(want, fresh, second):
        _batches_equal(w, g)
        for k, v in _flat(f).items():
            assert torch.equal(_flat(g)[k], v), k
        assert _meta_equal(g["meta"], f["meta"])
    with pytest.raises(FileNotFoundError):
        list(loader())


def test_loader_resumes_mid_epoch(coco_root):
    """`iterate(start)` gives the epoch's batches from `start` on, each as
    the whole epoch gives it, without loading the skipped ones."""
    from boxer_tpu_torch.dataset import build_dataloader, build_dataset

    ds = build_dataset("detection", _dataset_config(coco_root, "train"),
                       "train")
    loader = build_dataloader(ds, "train", batch_size=2, num_workers=3,
                              seed=5)
    loader.sampler.set_epoch(2)
    whole = list(loader)
    loads = []
    load = ds.load
    ds.load = lambda i, rng: loads.append(i) or load(i, rng)
    tail = list(loader.iterate(3))
    assert len(tail) == 1 and len(loads) == 2
    ds.load = load
    assert torch.equal(tail[0]["image"], whole[3]["image"])
    assert _meta_equal(tail[0]["meta"], whole[3]["meta"])


def test_loader_takes_a_large_seed(coco_root):
    """A trainer seed drawn from [1, 100000) (the shipped configs' seed -1)
    above 42,948 overflows the JAX loader's 32-bit RandomState seed; the
    port wraps it."""
    from boxer_tpu_torch.dataset import build_dataloader, build_dataset

    ds = build_dataset("detection", _dataset_config(coco_root, "train"),
                       "train")
    loader = build_dataloader(ds, "train", batch_size=4, seed=99999)
    assert [b["image"].shape[:2] for b in loader] == [(1, 4)] * 2


# ---------------------------------------------------------------- eval

def _gt_dataset():
    images = [{"id": 1, "height": 100, "width": 100, "file_name": "1.jpg"},
              {"id": 2, "height": 100, "width": 100, "file_name": "2.jpg"}]
    boxes = [(1, 1, [10, 10, 20, 20]), (1, 3, [50, 50, 30, 30]),
             (2, 1, [0, 0, 50, 50])]
    annotations = [{"id": i + 1, "image_id": img, "category_id": cat,
                    "bbox": b, "area": b[2] * b[3], "iscrowd": 0,
                    "segmentation": [[b[0], b[1], b[0] + b[2], b[1],
                                      b[0] + b[2], b[1] + b[3], b[0],
                                      b[1] + b[3]]]}
                   for i, (img, cat, b) in enumerate(boxes)]
    return {"images": images, "categories": [{"id": 1, "name": "a"},
                                             {"id": 3, "name": "b"}],
            "annotations": annotations}


EVAL_CASES = {
    "perfect": [(1, 1, [10, 10, 20, 20], 0.9), (1, 3, [50, 50, 30, 30], 0.8),
                (2, 1, [0, 0, 50, 50], 0.95)],
    "none": [],
    "half_precision": [(1, 1, [70, 70, 20, 20], 0.95),
                       (1, 1, [10, 10, 20, 20], 0.9),
                       (2, 1, [0, 0, 50, 50], 0.9),
                       (1, 3, [50, 50, 30, 30], 0.8)],
    "shifted": [(1, 1, [12, 11, 20, 18], 0.7), (1, 3, [45, 52, 30, 30], 0.6),
                (2, 1, [5, 0, 50, 45], 0.5), (2, 3, [1, 1, 9, 9], 0.4)],
}


def _records(case, iou_type):
    from boxer_tpu_torch.utils.rle import encode_mask

    out = []
    for img, cat, box, score in EVAL_CASES[case]:
        rec = {"image_id": img, "category_id": cat, "bbox": box,
               "score": score}
        if iou_type == "segm":
            m = np.zeros((100, 100), bool)
            m[box[1]:box[1] + box[3], box[0]:box[0] + box[2]] = True
            rec["segmentation"] = encode_mask(m)
        out.append(rec)
    return out


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_coco_eval_matches_jax(case, iou_type):
    from boxer_tpu.dataset.helper.coco_api import COCO as JCOCO
    from boxer_tpu.evaluate.coco_eval import COCOEval as JCOCOEval
    from boxer_tpu_torch.dataset.helper.coco_api import COCO
    from boxer_tpu_torch.evaluate.coco_eval import COCOEval

    stats = []
    for coco_cls, eval_cls in ((JCOCO, JCOCOEval), (COCO, COCOEval)):
        ev = eval_cls(coco_cls(dataset=_gt_dataset()), iou_type)
        ev.evaluate(_records(case, iou_type))
        ev.accumulate()
        stats.append(ev.summarize())
    assert np.array_equal(stats[0], stats[1]), stats
    if case == "perfect":
        # a rasterized polygon holds its border pixels: IoU 400/441 in segm
        assert iou_type == "segm" or stats[1][0] == 1.0


def test_box_iou_crowd_semantics_matches_jax():
    from boxer_tpu.evaluate.coco_eval import box_iou_xywh as j_iou
    from boxer_tpu_torch.evaluate.coco_eval import box_iou_xywh

    dt = np.array([[0, 0, 10, 10], [5, 5, 50, 20]], np.float64)
    gt = np.array([[0, 0, 100, 100], [0, 0, 20, 20]], np.float64)
    for crowd in ([1, 0], [0, 0]):
        assert np.array_equal(box_iou_xywh(dt, gt, np.array(crowd)),
                              j_iou(dt, gt, np.array(crowd)))


def test_format_and_evaluate_round_trip_matches_jax(coco_root):
    """Seeded model outputs (with mask logits) through both datasets'
    `format_for_evalai` (RLEs) and `prepare_for_evaluation`, then both
    `CocoEvaluator`s for bbox and segm: the same records, the same stats."""
    from boxer_tpu.dataset import build_dataset as j_dataset
    from boxer_tpu.evaluate.coco_eval import CocoEvaluator as JEvaluator
    from boxer_tpu_torch.dataset import build_dataset
    from boxer_tpu_torch.evaluate.coco_eval import CocoEvaluator

    cfg = _dataset_config(coco_root, "test")
    datasets = (j_dataset("detection", cfg, "val"),
                build_dataset("detection", cfg, "val"))
    rs = np.random.RandomState(3)
    items = [datasets[0].load(i, np.random.RandomState(0)) for i in range(4)]
    batch = datasets[0].collate(items)
    valid = batch["targets"]["valid"]
    nq = 12
    logits = rs.randn(4, nq, 3).astype(np.float32) - 2.0
    boxes = rs.uniform(0.2, 0.6, (4, nq, 4)).astype(np.float32)
    for i in range(4):              # near-perfect queries for the GT
        n = int(valid[i].sum())
        logits[i, np.arange(n), batch["targets"]["labels"][i, :n]] = 6.0
        boxes[i, :n] = batch["targets"]["boxes"][i, :n] + 0.004
    out = {"pred_logits": logits, "pred_boxes": boxes,
           "pred_masks": rs.randn(4, nq, 28, 28).astype(np.float32) + 1.0}
    records, stats = [], []
    for ds, ev_cls in zip(datasets, (JEvaluator, CocoEvaluator)):
        preds = ds.format_for_evalai(out, batch["meta"], topk=10,
                                     return_rles=True)
        recs = {"segm": ds.prepare_for_evaluation(preds),
                "bbox": ds.prepare_for_evaluation(
                    {k: {kk: vv for kk, vv in v.items() if kk != "rles"}
                     for k, v in preds.items()})}
        ev = ev_cls(ds.coco, ("bbox", "segm"))
        ev.update(recs, [m["image_id"] for m in batch["meta"]])
        ev.synchronize_between_processes()
        records.append(recs)
        stats.append(ev.accumulate_and_summarize(verbose=False))
    assert records[1] == records[0]
    assert len(records[1]["segm"]) == 40
    for k in ("coco_eval_bbox", "coco_eval_segm"):
        assert np.array_equal(stats[1][k], stats[0][k]), k
    assert stats[1]["coco_eval_bbox"][1] > 0.5


def test_merge_and_dedupe_match_jax():
    from boxer_tpu.evaluate.coco_eval import CocoEvaluator as JEvaluator
    from boxer_tpu.evaluate.coco_eval import merge_gathered_results as j_merge
    from boxer_tpu_torch.evaluate.coco_eval import (CocoEvaluator,
                                                    merge_gathered_results)

    def rec(img, score):
        return {"image_id": img, "category_id": 1,
                "bbox": [0, 0, 10, 10], "score": score}

    host0 = ([1, 2], {"bbox": [rec(1, 0.9), rec(2, 0.8)],
                      "segm": [rec(1, 0.9)]})
    host1 = ([3, 2], {"bbox": [rec(3, 0.7), rec(2, 0.8)],
                      "segm": [rec(2, 0.5)]})
    got = merge_gathered_results([host0, host1], ("bbox", "segm"))
    assert got == j_merge([host0, host1], ("bbox", "segm"))
    assert got[0] == [1, 2, 3]
    evs = [cls(coco_gt=None, iou_types=("bbox",))
           for cls in (JEvaluator, CocoEvaluator)]
    for ev in evs:
        ev.update({"bbox": [{"image_id": 5, "score": 0.9}]}, [5])
        ev.update({"bbox": [{"image_id": 5, "score": 0.1},
                            {"image_id": 6, "score": 0.4}]}, [5, 6])
    assert evs[1].img_ids == evs[0].img_ids == [5, 6]
    assert evs[1].results == evs[0].results


# ---------------------------------------------------------------- tb

def test_event_file_roundtrip(tmp_path):
    from boxer_tpu_torch.utils.tb_writer import TensorboardWriter, _masked_crc

    w = TensorboardWriter(str(tmp_path))
    w.add_scalars({"train/loss": 1.5, "train/lr": 2e-4}, step=7)
    w.add_scalar("val/mAP", 0.42, step=8)
    w.close()
    files = list(tmp_path.glob("events.out.tfevents.*"))
    assert len(files) == 1
    data = files[0].read_bytes()
    records, pos = [], 0
    while pos < len(data):
        (length,) = struct.unpack("<Q", data[pos:pos + 8])
        (len_crc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        assert len_crc == _masked_crc(data[pos:pos + 8])
        payload = data[pos + 12:pos + 12 + length]
        (data_crc,) = struct.unpack("<I",
                                    data[pos + 12 + length:pos + 16 + length])
        assert data_crc == _masked_crc(payload)
        records.append(payload)
        pos += 16 + length
    assert len(records) == 4
    assert b"brain.Event:2" in records[0]
    assert b"train/loss" in records[1]
    assert b"val/mAP" in records[3]
    assert struct.pack("<f", 0.42) in records[3]
