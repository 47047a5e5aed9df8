"""Training/eval loops; port of `boxer_tpu/trainer/engine.py`.

Parity target: reference `e2edet/trainer/engine.py` — train_epoch loop
with interval-driven checkpoint/eval (:126-192), evaluate (val:
CocoEvaluator, or the offline Waymo metrics for the 3D task; test: result
accumulation + dump, :20-123), per-interval meters/ups/ETA reporting
(:246-299). The train step hands back its stats
as host floats, read from the device in one copy a step (it needs the
gradient norm on the host for the NaN skip); the loop adds no sync.
In a process group every rank runs the loop and each eval on its data
shard of the split (the ranks of a shard, which differ in sp and mp, run
the sharded step together and hold the same outputs: only the shard's
first, `Layout.leads_shard`, formats and keeps its records); the records
are gathered over the ranks (an image or frame the sampler's padding gives
twice keeps its first record), rank 0 writes the result files, and every
rank returns the same metrics. The log, the scalars and the trace are
rank 0's.
"""

import json
import os
import time

import torch

from boxer_tpu_torch.parallel import distributed


def train_epoch(trainer):
    """Train on the current epoch's batches from `epoch_batches_done` on
    (the mid-epoch resume position) until the epoch ends or max_update is
    reached. A step skipped on a non-finite gradient norm takes no update
    (state.step does not advance), so the update counter follows
    state.step, as the JAX loop aligns it at its log interval."""
    loader = trainer.loaders["train"]
    log_interval = trainer.log_interval
    t_window = time.perf_counter()
    updates_in_window = 0

    # optional device trace: training.jax_profile = <dir> records updates
    # 5-8 of rank 0
    profile_dir = (trainer.running_config.get("jax_profile")
                   if distributed.is_master() else None)
    profiler = None

    start = trainer.epoch_batches_done
    for batch_idx, batch in enumerate(loader.iterate(start), start):
        if trainer.current_update >= trainer.max_update:
            break
        batch.pop("meta", None)
        if profile_dir and trainer.current_update == 5 and profiler is None:
            profiler = _start_profiler(trainer.device)
        # the dropout key's update index: every update call counted, a
        # skipped one too, from the position a checkpoint records
        trainer.state, stats = trainer._train_step(
            trainer.state, batch,
            update=trainer.current_epoch * len(loader) + batch_idx)
        trainer.epoch_batches_done = batch_idx + 1
        if profiler is not None and trainer.current_update == 8:
            _stop_profiler(profiler, trainer.device, profile_dir)
            profiler = None
            trainer.logger.info(f"Wrote device trace to {profile_dir}")
        if stats["skipped"]:
            trainer.logger.info(
                f"update {trainer.current_update + 1} skipped on a "
                f"non-finite gradient norm ({stats['grad_norm']})")
            continue
        trainer.current_update = trainer.state.step
        updates_in_window += 1

        if trainer.current_update % log_interval == 0:
            _update_info(trainer, stats, updates_in_window,
                         time.perf_counter() - t_window)
            t_window = time.perf_counter()
            updates_in_window = 0

        if (trainer.checkpoint_interval
                and trainer.current_update % trainer.checkpoint_interval == 0):
            trainer.checkpoint.save(trainer.state, trainer.current_update,
                                    extra=trainer.checkpoint_extra())
            trainer.logger.info(
                f"Checkpoint saved @ update {trainer.current_update}")

        if (trainer.evaluation_interval and "val" in trainer.loaders
                and trainer.current_update % trainer.evaluation_interval == 0):
            evaluate("val", trainer)

        if trainer.current_update >= trainer.max_update:
            break
    if profiler is not None:
        _stop_profiler(profiler, trainer.device, profile_dir)


def _start_profiler(device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    profiler = profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profiler(profiler, device, profile_dir):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    profiler.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def _update_info(trainer, stats, updates, window_s):
    host_stats = {k: v for k, v in stats.items() if isinstance(v, float)}
    trainer.meter.update(host_stats)
    ups = updates / max(window_s, 1e-9)
    eta = trainer.calculate_time_left(updates, window_s)
    trainer.logger.info(
        f"update {trainer.current_update}/{trainer.max_update} "
        f"loss={host_stats.get('total_loss', float('nan')):.4f} "
        f"grad_norm={host_stats.get('grad_norm', float('nan')):.3f} "
        f"ups={ups:.2f} eta={eta}")
    if trainer.writer is not None:
        trainer.writer.add_scalars(host_stats, trainer.current_update)


def evaluate(split: str, trainer):
    """val: streaming COCO eval (2D) or accumulated Waymo metrics (3D);
    test: accumulate + dump results (reference `engine.py:20-123`)."""
    loader = trainer.loaders.get(split)
    if loader is None:
        return None
    dataset = trainer.datasets[split]
    is_test = split == "test"
    if not hasattr(dataset, "coco"):
        return _evaluate_3d(split, trainer, loader, dataset, is_test)

    from boxer_tpu_torch.evaluate.coco_eval import CocoEvaluator

    iou_types = ["bbox"]
    if getattr(dataset, "use_mask", False):
        iou_types.append("segm")
    evaluator = None if is_test else CocoEvaluator(dataset.coco, iou_types)
    accumulated = {}
    lead = trainer.layout.leads_shard

    t0 = time.perf_counter()
    n_batches = 0
    for batch in loader:
        meta = batch.pop("meta", None)
        squeezed = _squeeze_microbatch(batch)
        if is_test:
            out = trainer._inference_step(trainer.state, squeezed)
        else:
            out = trainer._eval_step(trainer.state, squeezed)
        n_batches += 1
        if not lead:
            continue
        # numpy has no bf16: cast on the device, then one copy per output
        out_np = {k: v.float().cpu().numpy()
                  for k, v in _strip_aux(out).items()}
        # one postprocessing pass serves both iou types: the bbox records
        # just drop the rles (the mask paste is the expensive part)
        preds = dataset.format_for_evalai(
            out_np, meta, return_rles=("segm" in iou_types))

        if is_test:
            accumulated.update(preds)
        else:
            records = {"bbox": dataset.prepare_for_evaluation(
                _drop_rles(preds))}
            if "segm" in iou_types:
                records["segm"] = dataset.prepare_for_evaluation(preds)
            evaluator.update(records, [m["image_id"] for m in meta])

    dt = time.perf_counter() - t0
    trainer.logger.info(f"{split} eval: {n_batches} batches in {dt:.1f}s")

    if is_test:
        out_path = os.path.join(trainer.save_dir, "test_result.json")
        records = _merge_first(distributed.gather(accumulated))
        if distributed.is_master():
            with open(out_path, "w") as f:
                json.dump(dataset.prepare_for_evaluation(records), f)
            trainer.logger.info(f"Wrote {out_path}")
        distributed.synchronize()
        return out_path

    evaluator.synchronize_between_processes()
    stats = evaluator.accumulate_and_summarize(
        verbose=distributed.is_master())
    for k, v in stats.items():
        trainer.logger.info(f"{split} {k}: AP={v[0]:.4f} AP50={v[1]:.4f} "
                            f"AP75={v[2]:.4f}")
        if trainer.writer is not None:
            trainer.writer.add_scalars(
                {f"{split}/{k}_AP": float(v[0])}, trainer.current_update)
    return stats


def _evaluate_3d(split, trainer, loader, dataset, is_test):
    """3D (Waymo) eval, val and test alike: the inference step on each
    batch, its top-125 records accumulated, `results.pkl` written to the
    save dir; val then runs the offline metrics on the records."""
    accumulated = {}
    t0 = time.perf_counter()
    for batch in loader:
        meta = batch.pop("meta")
        out = trainer._inference_step(trainer.state,
                                      _squeeze_microbatch(batch))
        if trainer.layout.leads_shard:
            accumulated.update(dataset.format_for_evalai(out, meta))
    accumulated = _merge_first(distributed.all_gather(accumulated))
    path = distributed.broadcast_scalar(
        dataset.prepare_for_evaluation(accumulated, trainer.save_dir)
        if distributed.is_master() else None)
    trainer.logger.info(f"{split}: {len(accumulated)} frames in "
                        f"{time.perf_counter() - t0:.1f}s; wrote {path}")
    if is_test:
        return path

    from boxer_tpu_torch.evaluate.waymo_eval import evaluate_results

    metrics = evaluate_results(accumulated)
    for k, v in sorted(metrics.items()):
        trainer.logger.info(f"{split} {k}: {v:.4f}")
        if trainer.writer is not None:
            trainer.writer.add_scalars({f"{split}/{k}": v},
                                       trainer.current_update)
    return metrics


def _merge_first(parts):
    """The ranks' {image id or frame token: record} dicts in one, each key
    with its first record in rank order."""
    out = {}
    for part in parts:
        for k, v in part.items():
            out.setdefault(k, v)
    return out


def _squeeze_microbatch(batch):
    """Eval loaders keep iter_per_update=1; drop the leading microbatch dim."""

    def squeeze(x):
        return x[0] if isinstance(x, torch.Tensor) and x.ndim > 0 else x

    return {k: ({kk: squeeze(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else squeeze(v))
            for k, v in batch.items()}


def _strip_aux(out):
    return {k: v for k, v in out.items()
            if k not in ("aux_outputs", "enc_outputs")}


def _drop_rles(preds):
    return {k: {kk: vv for kk, vv in v.items() if kk not in ("rles", "masks")}
            for k, v in preds.items()}
