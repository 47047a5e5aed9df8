#!/usr/bin/env python3
"""Drive the PyTorch port (boxer_tpu_torch) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

1. device: requires a CUDA card and prints `nvidia-smi`'s name, power.limit;
2. build: compiles the CUDA kernels from boxer_tpu_torch/csrc with nvcc (one
   nvcc per source, all started together);
3. each kernel against its plain PyTorch version at the slices' shapes, with
   its error, its time beside the plain version's and the library call's
   (CUDA events; for K7a/K7b a zeroed table allocated in the call, then
   `index_add_`, with `index_add_` alone into a standing table beside it)
   and its bound (bytes at 3.35 TB/s or operations at the peak of their
   type): K1-K3 (K1 at P=4, M=161,576 and M=2,400; K2 at P=196,
   M=2,400 and at the training forward's P=4, M=161,576, P=4, M=2,400 and
   P=1, M=470,400; K3 at BH=8, L=300 in f32 and in bf16, its tensor-core
   kernel), K9 (box attention's inference sampling, one launch a call: the
   segm cell's encoder call, batch 16, P=4 over the 20,197 tokens of
   800x1216, and its decoder call, P=196 over 300 queries, bf16, with its
   device time; and the 3D cell's two calls, batch 4, P=4 over the 69,149
   tokens of 235x235 and 118x118 and over 300 queries, rotated grids;
   `csrc/box_sample.cu`), K10 (the pillar net at inference, one launch a
   forward: the pp3d.infer_b4 cell's 4 frames of 60,000 pillars of 20
   points, filters 64 and 128, bf16, a pillar's relative error, two
   launches bitwise equal, its device time; `csrc/pillar_net.cu`), K4 (the
   segm model's last decoder layer: both sums of its instance attention,
   B 1, H 8, LQ 300, 14x14 taps over the 4 levels of 800x1216, with bf16
   and with f32 tables, two launches bitwise equal, the kernel's tile
   printed; `csrc/instance_sample.cu`),
   then (3b) the d_value scatters K5 (P=4, M=161,576 and M=2,400) and K6
   (P=196, M=2,400), each as the fused kernel that also returns d_w4, as
   its d_table alone, and as the yardstick d_table kernel + plain d_w4
   (training), then (3c) the row scatters K7a and K7b and the
   m-major combine K8 at the folded encoder level 0 (P=4, M=161,576) and at
   P=196, M=2,400, K7b at P=16, LQ=600; the combine shootout T1-T3
   (`boxer_tpu_torch/tools/bench_combine.py`); and the gradients of
   `box_attention` at P=16 (the folded path, through `TakeRows` and K7b),
   whose output must carry a grad_fn, against the same op with K7b swapped
   for its plain version (rel err 1e-5); (3d) H1, the matcher's solve
   (`csrc/hungarian.cu`, a cluster of C blocks a problem), at the shipped
   configs' four matching calls (the 2D and Waymo decoders' stacked
   layers, 100 x 300 and 250 x 300; their encoder heads pruned to 100 x
   10,000 and 250 x 62,500), the costs from the matchers' own
   `cost_matrix` on random outputs with COCO's 1-60 and Waymo's 20-70
   valid targets a frame: col4row equal to the plain version's at the
   rule's C and at every C of 1, 2, 4, 8, 16 the card can hold, the plain
   version equal to scipy for one problem, `hungarian` and the solve free
   of host syncs under `torch.cuda.set_sync_debug_mode("error")`; the
   kernel's time at each C beside the one-block design's (commit
   e0deb11, `PERF.md`), the plain version's, scipy's host time and the
   bound of the bytes the solve must move (the valid rows' cost rows,
   n_rows and col4row, each once), with the plain version's Dijkstra
   steps and the kernel's ms a step beside it;
4. the full-width slice: BoxeR-2D R50 (hidden 256, 8 heads, 6+6 layers, 300
   queries, 91 classes) in bf16 at batch 1 on an 800x1216 canvas with
   seeded random weights, segm with the deferred top-100 mask decode, then
   detection only; img/s, and the kernels' launch counts over the timed
   forwards, which must match every call site (one K4 a segm forward);
   (4c: removed, with the m-major inference route it ran);
5. the same weights and image on a 256x384 canvas in f32 (no TF32), card
   (kernels, K4 among them) against CPU (plain versions): identical top-k
   labels, scores and boxes within atol 1e-3, fewer than 1e-3 of mask
   pixels different;
6. one more segm forward under torch.profiler: the device's busy time
   against the forward's time, and the kernels that take the most of it;
7. the training slice at full width, segm then detection: one train step
   (matcher, criterion, backward, clip, AdamW) with f32 parameters and the
   forward under bf16 autocast, on a synthetic batch of 1 at 800x1216 with
   20 targets; 1 warm-up step and 5 timed on the host clock up to a
   synchronize; ms/step, peak memory, the loss terms of the first and last
   step, the kernels' launches per step (which must match every call site;
   the segm step's remat runs the decoder's K3 again, no K2), then one more
   segm step under torch.profiler; (7c) the detection step
   folded (`FOLD_TAP_THRESHOLD = 0`: every level through `TakeRows`, K7b in
   the backward), with the same checks, a loss that falls after a step of
   norm 1e-3 against its gradient from the initial weights, and a
   profiled step; (7d) K5 on the model's own indices (encoder level 0 of
   a segm step) against random rows of the same shape, and K7b on the
   model's own indices at the 4 encoder levels of a folded detection step
   (taps a row, time beside its plain version and library call, rel 1e-5);
8. one train step at 256x384 in f32 (no TF32, no autocast) with phase 5's
   weights, card (kernels) against CPU (plain versions): identical matched
   query indices in every match, loss terms within rel 1e-4, the gradient
   norm within 1e-3, pre-clip gradients within a worst-leaf rel err of 0.1
   (a ReLU input within rounding of 0 takes the other branch on the other
   device, see `train_card_vs_cpu`); and the same step on the card with
   the fused K5/K6 swapped for their plain version (plain d_table and plain
   d_w4), the same forward: pre-clip gradients within a worst-leaf rel err
   of 1e-4, the sampling-offset and attention-weight leaves that d_w4 feeds
   among them; (8c) one f32 detection
   step at 256x384 on the card, folded against per-tap with the same
   weights and batch (identical matches, loss terms 1e-4, gradient norm
   1e-3, worst leaf 0.1), and the folded step with K7b swapped for its plain
   version (worst leaf 1e-4);
9. BoxeR-3D at the Waymo config's width: bf16 inference at 468x468 on
   32,000 drawn voxels of f32 points (frames/s, launches K9 4, K3 2 and
   K10 1 a forward, a profiled forward), then one served frame: 180,000
   points over the whole
   pc_range -> the voxelizer -> pad_voxels -> the model at the voxelizer's
   469x469 grid -> the top-125, ms by stage, every kept pillar on a canvas
   cell of its own; (9b) card against CPU at 128x128 in f32 with perturbed
   heads (top-125 labels equal, scores and metric boxes within 1e-3);
   (9c) the batch-2 train step under bf16 autocast (launches K2 8, K5 8,
   K3 2 a step; finite gradients, non-zero on every sampling projection);
   (9d) one f32 step at 128x128, card against CPU by phase 8's rules on
   frames whose matches clear every tie by 1e-4, and K5 against its plain
   version in the card's step (worst leaf 1e-4);
10. the trainer: the shipped COCO-InstanceSegmentation/boxer2d_r50_50eps
   config through `build_trainer`, `load`, `train` at full width (R50,
   hidden 256, 8x32 heads, 6+6 layers, 300 queries, bf16 autocast, the
   1344x1344 canvas, the config's processors and step schedule on the
   epoch clock) on a synthetic COCO directory (8 train and 8 val 480x640
   JPEGs, 2-3 polygons each, COCO's 80 category ids), only the schedule's
   length cut (TRAINER_CUTS): each update finite, not skipped, at the step
   schedule's LR times each group's base LR, with phase 7's segm launches
   x2 (two microbatches); the loader's first batch on the card bitwise
   equal to its host build; val bbox and segm AP in [0, 1]; a
   test_result.json record for every test image; config.yaml, the
   checkpoints of updates 2 and 4 and model_final; a resumed trainer with
   update 4's model and optimizer state bitwise, at (update, epoch, skip)
   (4, 1, 0), taking 2 more finite updates; ms per update (the median of
   updates 2-6, the first update a warm-up left out), peak memory,
   the eval forwards' launches per image (one K4 a test step, one a
   decoder layer a val step: the val forward samples every layer's RoI
   with train=True under no_grad) and one profiled update; no
   matcher host sync in any update (H1 solves on the card);
11. the Waymo trainer: the shipped Waymo-Detection/boxer3d_pointpillar
   config through `build_trainer`, `load`, `train` at full width (hidden
   256, 8 heads, 2+2 layers, 300 queries, 5 classes, the 469x469 grid,
   32,000 train and 60,000 test voxels of 20 points, 250 boxes, the
   config's processors and GT-database sampler, cosine with warmup, AdamW,
   bf16 autocast) on a generated Waymo directory (8 train and 16 val
   frames of 180,000 points, 20-70 objects with points in every box,
   9-column boxes) and its `create_gt_database`, only TRAINER_3D_CUTS cut:
   each update finite, not skipped, at the schedule's LR times each
   group's base LR, with K2 8, K5 8, K3 2; K9 2, K3 1 and K10 0.5 (one
   a batch of 2) a val or test frame; db-sampled objects placed; the
   loader's first batch on the card bitwise equal to its host build from
   the same draws; the val metrics
   equal to `evaluate_results` of the val records; results.pkl with a
   record per val and per test frame; config.yaml, the checkpoints of
   updates 2 and 4, model_final; a resumed trainer with update 4's model,
   optimizer state and db cursors bitwise, at (4, 1, 0), taking 2 more
   finite updates; ms per update (median of updates 2-6), peak memory,
   one profiled update's busy share, the matcher's host syncs an update
   (none, or the phase fails), K5's device ms a call beside phase 9c's,
   the matcher's cost matrices' peak memory and the loader's host ms by
   stage;
12. data parallel through the trainer (`parallel/distributed.py:launch`),
   the shipped configs at full width at a global batch of 2, one image or
   frame a rank; two ranks share the card over gloo (NCCL refuses two
   ranks on one card): (12a) one f32 update of the segm config at
   256x384 (SGD, no autocast) on two images against a world-1 update of
   the same images from the same weights (stats within 1e-4, the updated
   parameters' worst leaf within phase 8's 0.1, the ranks bitwise equal),
   then 2 bf16 updates from the loader with a ZeRO-1 checkpoint, resumed
   at world 2 (model and optimizer state bitwise) and at world 1 (one
   more update), the gradient all-reduce's bytes and ms; (12b) the
   trainer in a process group of one over NCCL against two no-group
   runs (bitwise, or within their run-to-run spread), ms per update
   beside phase 10's; (12c) each rank's optimizer-state bytes and peak
   memory with zero1 true and false (sharded: the ranks' states sum to
   the replica and none holds 3/4 of it); (12d) the Waymo config at
   world 2: the ranks' GT-database draws differ, val and test
   results.pkl hold every frame once (3 frames, one padded), a resume
   restores each rank's cursors. Launches per rank and update as phases
   10 and 11 count them (one microbatch);
13. dropout, remat and DETR: (13a) phase 7's segm step at dropout 0.1 with
   remat on and off from the same weights under one dropout key, in bf16
   autocast and in f32 (loss terms bitwise equal; the f32 gradients'
   worst leaf within 1e-4, the bf16 ones within 0.1 beside two eager
   runs' own spread; launches K2 48, K5 24, K6 24 both ways: the sampling
   output is saved, not relaunched; every mask drawn from a CUDA
   generator; non-zero sampling-projection gradients); (13b) the shipped segm config through the trainer at the
   recipe's per-card microbatch of 4 on the 1344x1344 canvas, 3 updates
   with remat on and 3 with it off, ms per update and peak memory of each;
   (13c) the shipped COCO-Detection/detr_r50 config through the trainer at
   full width (R50, 6+6 layers, FFN 2048, 100 queries, dropout 0.1, AdamW
   with lr_backbone, max_norm 0.1, bf16 autocast) on phase 10's synthetic
   COCO directory, cut to batch 2 and 4 updates with a checkpoint at 2:
   finite losses at the schedule's LR, every transformer layer's gradient
   non-zero, val AP in [0, 1], a resume from update 2 replaying updates 3-4
   bitwise, ms per update, peak memory, one inference forward's device
   time; (13d) DETR inference card against CPU at 256x384 in f32 (max abs
   1e-3);
14. the last single-device modules: (14a) the analytic box-attention
   backward (`set_box_attention_impl("analytic_vjp")`: K2 forward, one K5 a
   level in the backward) at op level, f32 gradients of value, gx, gy and
   the attention weights against the default backward (rel 1e-4) and
   against itself with K2/K5 swapped for their plain versions (rel 1e-5),
   K5 launches and each backward's CUDA-event ms, at P=4, M=161,576 a
   level and P=196, M=2,400; at model level phase 7's segm step with the
   switch on and off from the same weights, in turns: f32 (the train
   forward's outputs and the loss terms bitwise, the worst leaf 1e-5) and
   bf16 autocast (the worst leaf within 0.1 beside two default runs'
   spread), K2 48, K3 12, K5 24, K6 24 each way, ms/step, device ms and
   peak; one BoxeR-3D step (phase 9c's batch) with the switch on (K2 8, K5
   8, K3 2, finite gradients); (14b) the native runtime built with g++:
   the voxelizer on phase 9's served cloud at the shipped Waymo train
   voxelize (469x469, 32,000 voxels), the BEV collision test on 250 x 250
   boxes and the RLE counts of an 800x1216 mask, each bitwise equal to the
   numpy version, host ms of both; (14c) `tools.analyze` with every task at
   full width (the parameter count equal to the model's), `tools.visualize`
   and the segmentation demo each writing a PNG of the image's size;
15. tensor (mp) and sequence (sp) parallelism through the trainer at full
   width, every rank of a layout on the one card over gloo: (15a) one f32
   update of the shipped segm config at 256x384 (SGD, no autocast) on two
   images at mp2, sp2 and sp2 x mp2 against a world-1 update of the same
   images and weights by phase 12a's rule (stats within 1e-4, the worst
   leaf within 0.1, every rank's gathered parameters bitwise equal), each
   rank's launches (world 1's) and its kernels' BH and M, each of K2, K3,
   K5 and K6 against its plain version on the inputs the update gave it
   (1e-5, every rank and shape, world 1 too); at sp2 x mp2 the same step
   with K5/K6 swapped for their plain version (loss terms and leaves
   within 1e-4) and with K2, K3, K5 and K6 swapped (loss terms 1e-4, the
   median leaf 1e-4, the worst 0.1), and the inference forward (fold=True:
   K9, K3, one K4) against world 1 and against K9, K3 and K4 swapped (every
   output within 1e-4, the ranks' outputs bitwise equal); (15b) two bf16
   updates from the loader at sp2 x mp2 with a checkpoint at update 2
   equal to the ranks' gathered state, resumed at world 1 bitwise for one
   more update; (15c) each rank's peak memory at one image a data shard
   at world 1, mp2, sp2 and sp2 x mp2, every collective's calls, bytes and
   host ms a rank and update, ms per update (gloo stages the tensors
   through the host: no scaling number); (15d) one f32 update of BoxeR-3D
   (phase 9c's batch) and of DETR (phase 13c's config) at mp2 against
   world 1 by 12a's rule, each kernel against its plain version on its
   inputs (1e-5), and `distributed.sp=2` on either refused before
   anything is built.

Prints the slices' img/s and ms/step, the per-shape kernel rows on lines
of their own, and one JSON line of per-kernel results (one row per kernel
at its row's shape), then last {"ok": true, "device": {...}}. Any failed
phase raises: the exit code is not 0 and no ok line is printed.
"""

import collections
import contextlib
import functools
import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
BENCH = dict(num_classes=91, hidden_dim=256, nhead=8, num_level=4,
             enc_layers=6, dec_layers=6, dim_feedforward=1024, num_queries=300,
             backbone_arch="resnet50")
CANVAS = (800, 1216)
E2E_CANVAS = (256, 384)
SEGM_ITERS = 10
DET_ITERS = 10
TRAIN_STEPS = 5
# the JAX recipe of tools/mfu_bench.py:measure_train
TRAIN_WEIGHTS = {"loss_ce": 2.0, "loss_bbox": 5.0, "loss_giou": 2.0}
MASK_WEIGHTS = {"loss_mask": 5.0, "loss_dice": 5.0}
OPTIM = {"type": "adamw", "params": {"lr": 2e-4, "lr_backbone": 2e-5,
                                     "weight_decay": 1e-4}}
SCHEDULE = {"type": "multi_step", "params": {"lr_steps": [10 ** 9],
                                             "lr_ratio": 0.1,
                                             "use_warmup": False}}
KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7a", "K7b", "K8", "K9",
           "K10", "H1")
# BoxeR-3D at the width of boxer_tpu/config/base_boxer3d_detection.yaml:
# 82-137 as tools/mfu_bench.py:measure_boxer3d instantiates it (:202-221):
# a 468x468 BEV grid of 0.32 m pillars, 32,000 voxels of 20 points
PC_RANGE_3D = (-75.0, -75.0, -3.0, 75.0, 75.0, 5.0)
VOXEL_3D = (0.32, 0.32, 8.0)
BENCH_3D = dict(num_classes=2, hidden_dim=256, nhead=8, num_level=2,
                enc_layers=2, dec_layers=2, dim_feedforward=1024,
                num_queries=300)
VOXELS_3D, POINTS_3D = 32000, 20
# the config's test processor (yaml:69-74) and a frame of about 180,000
# points, as a Waymo top lidar returns
SERVE_VOXELS, SERVE_POINTS = 60000, 180000
# card against CPU at a 128x128 grid
E2E_PC_3D = (-20.48, -20.48, -3.0, 20.48, 20.48, 5.0)
E2E_VOXELS_3D = 128 * 128
ITERS_3D = 10
TRAIN_BATCH_3D = 2          # the recipe's 16 over 8 cards (yaml:157)
TRAIN_WEIGHTS_3D = {"loss_ce": 2.0, "loss_bbox": 5.0, "loss_giou": 2.0,
                    "loss_rad": 4.0}
OPTIM_3D = {"type": "adamw", "params": {
    "lr": 1e-3, "lr_backbone": 1e-3, "weight_decay": 1e-4, "eps": 1e-9,
    "deform_lr_multi": 0.1}}
# phase 10: the shipped segm config through the trainer, only the length of
# its schedule cut (two microbatches of one image an update, 4 updates, then
# 2 more after a resume); a synthetic COCO directory of 480x640 JPEGs with
# COCO's 80 category ids (1-90 less 10)
TRAINER_CONFIG = "boxer_tpu_torch/config/COCO-InstanceSegmentation/boxer2d_r50_50eps.yaml"
TRAINER_CUTS = ["training.seed=3", "training.batch_size=2",
                "training.iter_per_update=2", "training.max_update=4",
                "training.checkpoint_interval=2", "training.log_interval=1",
                "training.run_type=train_val_test"]
COCO_IDS = [i for i in range(1, 91)
            if i not in (12, 26, 29, 30, 45, 66, 68, 69, 71, 83)]
COCO_IMAGES, COCO_HW = 8, (480, 640)
# phase 11: the shipped Waymo config through the trainer at full width, cut
# only here: batch 2 (the recipe's 16 over 8 cards, as phase 9c), a fixed
# seed, 4 updates with a checkpoint every 2 (both kept), then 2 more after
# a resume; on a generated Waymo directory in the converter's layout: 8
# train frames and 16 val frames (the config's load_interval 5 evaluates 4
# of them), SERVE_POINTS points and 20-70 objects a frame
TRAINER_3D_CONFIG = "boxer_tpu_torch/config/Waymo-Detection/boxer3d_pointpillar.yaml"
TRAINER_3D_CUTS = ["training.seed=3", "training.batch_size=2",
                   "training.max_update=4", "training.checkpoint_interval=2",
                   "training.num_checkpoint=2",
                   "training.run_type=train_val_test"]
WAYMO_FRAMES, WAYMO_OBJECTS = {"train": 8, "val": 16}, (20, 70)
# phase 12: data parallel through the trainer, the shipped configs at full
# width; two ranks share the one card over gloo (NCCL refuses two ranks on
# one card), NCCL runs a group of one. The global batch is 2 (one image or
# frame a rank); 12a's update against a world-1 update runs in f32 at
# phase 8's canvas with SGD at LR 10 (an update of the clipped gradient
# well above the parameters' f32 spacing, as the CPU tests take it)
DP_CUTS = ["training.seed=3", "training.batch_size=2",
           "training.iter_per_update=1", "training.log_interval=1",
           "training.run_type=train", "training.checkpoint_interval=2",
           "training.num_checkpoint=2"]
DP_F32_CUTS = DP_CUTS + [
    "training.mixed_precision=none", "training.max_update=1",
    f"dataset_config.detection.canvas_size=[{E2E_CANVAS[0]},{E2E_CANVAS[1]}]",
    "optimizer.type=sgd", "optimizer.params.lr=10.0",
    "optimizer.params.lr_backbone=1.0"]
DP_3D_CUTS = ["training.seed=3", "training.batch_size=2",
              "training.max_update=2", "training.checkpoint_interval=2",
              "training.num_checkpoint=2", "training.log_interval=1",
              "training.run_type=train_val_test"] + [
    f"dataset_config.detection3d.imdb_files.{s}.load_interval=1"
    for s in ("val", "test")]
# 3 val frames: the sampler pads them to 4 over 2 ranks
WAYMO_DP_FRAMES = {"train": 4, "val": 3}
# phase 13: dropout, remat and DETR. 13a phase 7's segm step at DROPOUT;
# 13b the shipped segm config at the recipe's per-card microbatch (a global
# 32 over 8 cards: 4 images in one microbatch), 3 updates with remat on and
# off; 13c the shipped DETR config cut only to batch 2 and 4 updates (a
# checkpoint at 2, resumed to replay 3-4), on phase 10's synthetic COCO
# directory; 13d DETR inference card against CPU at E2E_CANVAS in f32
DROPOUT = 0.1
REMAT_CUTS = ["training.seed=3", "training.batch_size=4",
              "training.iter_per_update=1", "training.max_update=3",
              "training.checkpoint_interval=1000", "training.log_interval=1",
              "training.run_type=train"]
DETR_CONFIG = "boxer_tpu_torch/config/COCO-Detection/detr_r50.yaml"
DETR_CUTS = ["training.seed=3", "training.batch_size=2",
             "training.max_update=4", "training.checkpoint_interval=2",
             "training.num_checkpoint=2", "training.log_interval=1",
             "training.evaluation_interval=1000", "training.num_workers=2",
             "training.run_type=train_val"]


# phase 15: tensor (mp) and sequence (sp) parallelism through the trainer,
# the shipped configs at full width, every rank of a layout on the one card
# over gloo; dp 1, so each rank of a layout holds the whole batch: 15a's
# two images (DP_F32_CUTS), 15b/15c's one image from the loader (MP_CUTS)
MP_LAYOUTS = {"mp2": (1, 1, 2), "sp2": (1, 2, 1), "sp2mp2": (1, 2, 2)}
MP_CUTS = ["training.seed=3", "training.batch_size=1",
           "training.iter_per_update=1", "training.log_interval=1",
           "training.run_type=train", "training.checkpoint_interval=2",
           "training.num_checkpoint=2", "training.max_update=2"]
MP_SGD = {"type": "sgd", "params": {"lr": 10.0, "lr_backbone": 1.0}}
# DETR's update unclipped: under the config's clip at 0.1 the queries'
# update is about 2e-6, 20 f32 spacings of their N(0, 1) entries, and one
# spacing's flip moves that leaf by 0.2 (f32 against float64 on the CPU:
# 0.10 at world 1 alone)
MP_DETR_CUTS = ["training.seed=3", "training.batch_size=2",
                "training.mixed_precision=none", "training.run_type=train",
                "training.max_update=1", "training.max_norm=0",
                "optimizer.type=sgd", "optimizer.params.lr=10.0",
                "optimizer.params.lr_backbone=1.0"]


def per_run(**counts):
    """Launches of every kernel in one run: those given, 0 elsewhere."""
    return {k: counts.get(k, 0) for k in KERNELS}


# launches per forward at every call site: K9 once a box-attention call, in
# 6 encoder layers and 5 decoder layers (6 when detection only), K3 in 6
# decoder self-attentions, K4 in the segm model's last decoder layer (its
# instance attention, all 4 levels in one launch)
INFER_LAUNCHES = {True: per_run(K9=11, K3=6, K4=1),
                  False: per_run(K9=12, K3=6)}
# launches per train step at every call site: K2 is the forward of every
# sampling level (6 encoder + 6 decoder layers x 4 levels), K5 the backward
# of each box-attention level, K6 of each instance-attention level, K3 the 6
# decoder self-attentions (its backward is plain autograd), and under remat
# (on by default) 6 more in a segm step, the decoder layers' recompute; the
# sampling outputs are saved, so the recompute launches no K2; folded, every
# box-attention level gathers with `TakeRows` and scatters with K7b; H1
# solves the encoder head's match and the decoder layers' (one call of
# `match_layers`)
TRAIN_LAUNCHES = {True: per_run(K2=48, K3=12, K5=24, K6=24, H1=2),
                  False: per_run(K2=48, K3=6, K5=48, H1=2)}
FOLDED_TRAIN_LAUNCHES = per_run(K3=6, K7b=48, H1=2)
# BoxeR-3D: at inference the pillar net is one launch of K10, each box
# attention (2 encoder + 2 decoder layers) samples both levels in one
# launch of K9, K3 runs the 2 decoder self-attentions; a train step runs
# every sampling level per tap (P = 4, `QuadSample`: K2 in 4 layers x 2
# levels) and K5 in the backward of each, and H1's two matches, as
# BoxeR-2D's; its pillar net is the torch path
INFER_3D_LAUNCHES = per_run(K9=4, K3=2, K10=1)
TRAIN_3D_LAUNCHES = per_run(K2=8, K3=2, K5=8, H1=2)


def log(*args):
    print(*args, flush=True)


def rel_err(a, b):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-6))


def check_kernels(dev):
    """Phases 3, 3b, 3c: each kernel against its plain version at the slices'
    shapes, timed beside its plain version, its library call and its bound.
    Returns {name: result dict}."""
    from boxer_tpu_torch.ops import combine_reduce as cr
    from boxer_tpu_torch.ops import flash_attention as fa
    from boxer_tpu_torch.ops import scatter_accum as sa
    from boxer_tpu_torch.tools import bench_combine as bc
    from boxer_tpu_torch.tools import bench_kernels as bk

    rs = np.random.RandomState(0)
    # encoder / decoder level 0 at 800x1216: 8 heads x 101 x 153 quad rows
    rows, m_enc, m_dec = 8 * 101 * 153, 8 * 20197, 8 * 300
    table = torch.from_numpy(rs.randn(rows, 128).astype(np.float32)).to(
        dev, torch.bfloat16)

    def taps(p, m, n_rows=rows):
        idx = torch.from_numpy(rs.randint(0, n_rows, (p, m)).astype(np.int32))
        return idx.to(dev), *(torch.from_numpy(
            rs.rand(*s).astype(np.float32)).to(dev)
            for s in ((p, m), (p, m), (p, m), (p, 4, m)))

    def nbytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    results = {}
    # K1 at its row's shape (encoder level 0), then the detection decoder's
    for p, m in bk.K1_SHAPES:
        idx, lx, ly, wt, _ = taps(p, m)
        results["K1" if m == m_enc else f"K1 P={p} M={m}"] = dict(
            wrapper=cr.quad_sample_reduce_raw,
            kernel=functools.partial(cr.quad_sample_reduce_raw, table, idx,
                                     lx, ly, wt),
            plain=functools.partial(cr.quad_sample_reduce_plain, table, idx,
                                    lx=lx, ly=ly, wt=wt),
            library=bc.library_call(table, *bc.bag_inputs(
                idx.t(), cr.corner_weights(lx, ly, wt).permute(2, 1, 0))),
            bound=bk.k1_bound(table, idx, lx, ly, wt),
            tol=1e-5, shape=f"P={p} M={m} table {rows}x128 bf16")
    # K2 at its row's shape (the inference decoder), then at the shapes of
    # `QuadSample`'s training forward
    for i, (p, m) in enumerate(bk.K2_SHAPES):
        idx2, _, _, _, w4 = taps(p, m)
        results["K2" if i == 0 else f"K2 P={p} M={m}"] = dict(
            bc.pmajor_case(table, idx2, w4), tol=1e-5,
            shape=f"P={p} M={m} table {rows}x128 bf16")
    qkv = [torch.from_numpy(rs.randn(8, 300, 32).astype(np.float32)).to(dev)
           for _ in range(3)]
    # QK^T and PV: 2 x 2 x BH x L x L x D
    attn_flops = 4 * 8 * 300 * 300 * 32
    results["K3_f32"] = dict(
        wrapper=fa.flash_attention,
        kernel=lambda: fa.flash_attention(*qkv),
        plain=lambda: fa.flash_attention_plain(*qkv),
        library=lambda: torch.nn.functional.scaled_dot_product_attention(*qkv),
        nbytes=4 * nbytes(qkv[0]), flops=attn_flops,
        tol=1e-5, shape="BH=8 L=300 D=32 f32")
    qkv16 = [t.to(torch.bfloat16) for t in qkv]
    results["K3"] = dict(
        wrapper=fa.flash_attention,
        kernel=lambda: fa.flash_attention(*qkv16),
        plain=lambda: fa.flash_attention_plain(*qkv16),
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            *qkv16),
        nbytes=4 * nbytes(qkv16[0]), flops=attn_flops, dtype="bf16",
        tol=1e-2, shape="BH=8 L=300 D=32 bf16")

    # K9 at the segm cell's encoder call (the row the kernels line reports),
    # its decoder call and the 3D cell's two calls
    results.update(box_sample_rows(dev))

    # K4 at the segm forward's last decoder layer, in bf16 (the row the
    # kernels line reports) and f32 tables
    results.update(instance_rows(dev, rs))

    # K10 at the 3D cell's pillar net
    results.update(pillar_rows(dev))

    # 3b. the backward scatters, f32 cotangents as the backward hands them,
    # the bf16 table the forward sampled: at each shape the fused kernel
    # (d_table and d_w4, the row the kernels line reports at the first
    # shape), the d_table kernel alone, and the yardstick, the d_table
    # kernel followed by the plain d_w4
    for p, m, per_tap in bk.K56_SHAPES:
        idx5, *_, w45 = taps(p, m)
        g5 = torch.from_numpy(rs.randn(p * m if per_tap else m, 32).astype(
            np.float32)).to(dev)
        key = "K6" if per_tap else "K5"
        sfx = "" if (p, m) in ((4, m_enc), (196, m_dec)) else f" P={p} M={m}"
        counter = (sa.scatter_add_rows_pmajor_weighted if per_tap
                   else sa.scatter_add_rows_weighted)
        shape = (f"P={p} M={m} {'per-tap' if per_tap else 'shared'} f32 g, "
                 f"table {rows}x128 bf16")

        def fused(idx5=idx5, g5=g5, w45=w45, per_tap=per_tap):
            return sa.scatter_add_rows_weighted_dw4(idx5, g5, w45, table,
                                                    per_tap)

        def d_table(idx5=idx5, g5=g5, w45=w45, counter=counter):
            return counter(idx5, g5, w45, rows)

        def plain(idx5=idx5, g5=g5, w45=w45, per_tap=per_tap, **kw):
            return sa.scatter_accum_dw4_plain(idx5, g5, w45, table, per_tap,
                                              **kw)

        with_dw4 = bk.k56_bound(table, idx5, g5, w45, with_dw4=True)
        results[key + sfx] = dict(
            wrapper=counter, kernel=fused, plain=plain, library=None,
            bound=with_dw4, tol=1e-5, shape=shape + ", with d_w4")
        results[key + " d_table" + sfx] = dict(
            wrapper=counter, kernel=d_table,
            plain=functools.partial(sa.scatter_accum_plain, idx5, g5, w45,
                                    rows, per_tap),
            library=None,
            bound=bk.k56_bound(table, idx5, g5, w45, with_dw4=False),
            tol=1e-5, shape=shape + ", d_table only")
        results[key + " yardstick" + sfx] = dict(
            wrapper=counter,
            kernel=lambda d_table=d_table, plain=plain: (
                d_table(), plain(want_table=False)[1]),
            plain=plain, library=None, bound=with_dw4, tol=1e-5,
            shape=shape + ", d_table kernel + plain d_w4")

    # 3c. the row scatters (bf16 payload, the folded backward's cotangent)
    # and the m-major combine: the folded encoder level 0 first (the row the
    # kernels line reports), then P=196 M=2,400, then K7b at the JAX package's
    # chip-test shape (2 heads, levels (80,120) and (40,60), LQ=600, P=16)
    # library call: a zeroed table allocated in the call, then `index_add_`
    # of the payload converted to f32 beforehand (the same function as the
    # kernel); "standing": `index_add_` alone into a table zeroed once
    # outside the timed calls, the yardstick these rows were once timed by
    def scatter_rows(key, p, m, n_rows, flat):
        ix = taps(p, m, n_rows)[0]
        ix = ix.reshape(-1) if flat else ix
        pay = torch.from_numpy(rs.randn(p * m, 128).astype(np.float32)).to(
            dev, torch.bfloat16)
        out = torch.zeros((n_rows, 128), dtype=torch.float32, device=dev)
        ix_long, pay_f32 = ix.reshape(-1).long(), pay.float()
        wrapper = sa.scatter_add_rows if flat else sa.scatter_add_rows_pmajor
        results[key] = dict(
            wrapper=wrapper, kernel=lambda: wrapper(ix, pay, n_rows),
            plain=lambda: sa.scatter_rows_plain(ix, pay, n_rows),
            library=bk.index_add_call(ix, pay, n_rows),
            standing=lambda: out.index_add_(0, ix_long, pay_f32),
            bound=bk.k7_bound(ix, pay, n_rows),
            tol=1e-5, shape=f"P={p} M={m} bf16 payload, table {n_rows}x128")

    def mmajor(key, p, m):
        ix, lx8, ly8, wt8, _ = taps(m, p)
        results[key] = dict(bc.mmajor_case(table, ix, lx8, ly8, wt8),
                            tol=1e-5, shape=f"P={p} M={m} m-major, table "
                            f"{rows}x128 bf16")

    for sfx, p, m in (("", 4, m_enc), (" P=196", 196, m_dec)):
        scatter_rows("K7a" + sfx, p, m, rows, flat=True)
        scatter_rows("K7b" + sfx, p, m, rows, flat=False)
        mmajor("K8" + sfx, p, m)
    scatter_rows("K7b P=16", 16, 2 * 600, 2 * 81 * 121, flat=False)

    # BoxeR-3D's encoder level 0 at 468x468: P=4, M = 8 heads x 68,445
    # queries on 8 x 235 x 235 quad rows; K2 (the per-tap forward) and the
    # fused K5 (its backward) with random rows
    rows3, m3 = 8 * 235 * 235, 8 * 68445
    table3 = torch.from_numpy(rs.randn(rows3, 128).astype(np.float32)).to(
        dev, torch.bfloat16)
    idx3, *_, w43 = taps(4, m3, rows3)
    g3 = torch.from_numpy(rs.randn(m3, 32).astype(np.float32)).to(dev)
    shape3 = f"P=4 M={m3} table {rows3}x128 bf16 (BoxeR-3D)"
    results["K2 3D"] = dict(bc.pmajor_case(table3, idx3, w43), tol=1e-5,
                            shape=shape3)
    results["K5 3D"] = dict(
        wrapper=sa.scatter_add_rows_weighted,
        kernel=lambda: sa.scatter_add_rows_weighted_dw4(idx3, g3, w43,
                                                        table3, False),
        plain=lambda: sa.scatter_accum_dw4_plain(idx3, g3, w43, table3,
                                                 False),
        library=None, bound=bk.k56_bound(table3, idx3, g3, w43,
                                         with_dw4=True),
        tol=1e-5, shape=shape3 + ", shared f32 g, with d_w4")

    for name, r in results.items():
        # the fused scatter returns (d_table, d_w4): the worse of the two
        got, want = r["kernel"](), r["plain"]()
        torch.cuda.synchronize()
        pairs = list(zip(got, want)) if isinstance(want, tuple) else [
            (got, want)]
        err = r.get("err", rel_err)
        r["rel_err"] = max(err(a.float(), b.float()) for a, b in pairs)
        r["max_abs_err"] = max(float((a.float() - b.float()).abs().max())
                               for a, b in pairs)
        if r.get("bitwise"):
            again = r["kernel"]()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name}: two launches differ")
        before = r["wrapper"].launches
        r["ms"] = bc.cuda_ms(r["kernel"])
        r["op_launches"] = r["wrapper"].launches - before
        r["plain_ms"] = bc.cuda_ms(r["plain"])
        r["library_ms"] = (bc.cuda_ms(r["library"]) if r["library"]
                           else None)
        r["bound_ms"], r["bound_by"] = r["bound"] if "bound" in r else \
            bc.bound_ms(r["nbytes"], r["flops"], r.get("dtype", "f32"))
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        if "standing" in r:
            lib += f" (standing table: {bc.cuda_ms(r['standing']):.4f} ms)"
        device = (f" (device {bk.device_ms(r['kernel']):.4f} ms)"
                  if r.get("device_ms") else "")
        log(f"{name} [{r['shape']}]: rel err {r['rel_err']:.3e} "
            f"(tol {r['tol']:g}), max abs err {r['max_abs_err']:.3e}, "
            f"kernel {r['ms']:.4f} ms{device}, plain {r['plain_ms']:.4f} ms, "
            f"library {lib}, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        if not r["rel_err"] <= r["tol"]:
            raise AssertionError(f"{name} disagrees with its plain version")
    # numbers only: the callables hold the inputs, which would otherwise
    # stay allocated through the later phases and their peak memory
    return {name: {k: v for k, v in r.items() if not callable(v)}
            for name, r in results.items()}


# K4's shape: the segm forward's last decoder layer at 800x1216 (batch 1, 8
# heads, 300 queries, the 14x14 RoI over the 4 levels)
SEGM_LEVELS = ((100, 152), (50, 76), (25, 38), (13, 19))
ROI_K = 14


def segm_instance_case(dev, rs):
    """K4's inputs at the segm shape: a random value (1, S, H, 32) f32 on
    the host, and gx, gy, spatial and level weights (1, H, L, P, LQ) f32 on
    `dev`, the taps laid out as the model lays them: each (head, query)'s
    14x14 grid spread over a box (centre in [0.05, 0.95], sides in [0.02,
    0.5], so some taps lie past a border), moved a little at each level;
    random spatial and level weights. Returns (value, taps, the number of
    distinct quad rows the valid taps read)."""
    from boxer_tpu_torch.ops.combine_reduce import pmajor_taps, tap_rows

    nh, lq, k, nl = BENCH["nhead"], BENCH["num_queries"], ROI_K, len(
        SEGM_LEVELS)
    npt = k * k
    value = torch.from_numpy(rs.randn(
        1, sum(h * w for h, w in SEGM_LEVELS), nh, 32).astype(np.float32))
    grid = (np.arange(k) + 0.5) / k - 0.5
    centre = rs.uniform(0.05, 0.95, (2, 1, nh, 1, 1, lq))
    side = rs.uniform(0.02, 0.5, (2, 1, nh, 1, 1, lq))
    offset = rs.normal(0.0, 0.01, (2, 1, nh, nl, 1, lq))
    steps = (np.tile(grid, k), np.repeat(grid, k))          # x, y by tap
    gx, gy = (torch.from_numpy((centre[a] + side[a] * steps[a][:, None]
                                + offset[a]).astype(np.float32)).to(dev)
              for a in (0, 1))
    sw, lw = (torch.from_numpy(rs.rand(1, nh, nl, npt, lq).astype(
        np.float32)).to(dev) for _ in range(2))
    # the quad rows the valid taps read
    rows = 0
    for li, (h, w) in enumerate(SEGM_LEVELS):
        idx, _, _, valid = tap_rows(pmajor_taps(gx, nh, nl, npt, lq)[li],
                                    pmajor_taps(gy, nh, nl, npt, lq)[li], h, w)
        rows += torch.unique(idx[valid]).numel()
    return value, (gx, gy, sw, lw), rows


def k4_bound(rows, gx, dtype):
    """K4's bound: the distinct quad rows the valid taps read, gx, gy and
    the two weights once, and both outputs once; the operations, 4 corners
    and 2 sums of 32 channels a tap and level, at the f32 peak."""
    from boxer_tpu_torch.tools import bench_combine as bc

    _, nh, _, npt, lq = gx.shape
    size = torch.finfo(dtype).bits // 8
    nbytes = (rows * 128 * size + 4 * gx.numel() * 4
              + (nh * lq * 32 + lq * npt * nh * 32) * size)
    return bc.bound_ms(nbytes, gx.numel() * (4 + 2) * 32 * 2)


def instance_rows(dev, rs):
    """Phase 3: K4 against its plain version at the segm shape
    (`segm_instance_case`), with bf16 and with f32 tables, two launches
    bitwise equal; its bound (`k4_bound`); its device time (torch.profiler)
    is printed beside its CUDA-event time, and its tile beside its shape.
    Returns {name: case}."""
    from boxer_tpu_torch.ops import instance_sample as isr

    ba = importlib.import_module("boxer_tpu_torch.ops.box_attention")
    value, taps, rows = segm_instance_case(dev, rs)
    gx, k = taps[0], ROI_K
    nh, lq = gx.shape[1], gx.shape[-1]
    cases = {}
    for name, dtype, tol in (("K4", torch.bfloat16, 1e-2),
                             ("K4 f32", torch.float32, 1e-5)):
        tq, warps, splits = isr.launch_tile(dev, dtype, 1, nh, lq)
        tables = ba._build_quad_tables(value.to(dev, dtype), SEGM_LEVELS)
        cases[name] = dict(
            wrapper=isr.instance_sample_reduce,
            kernel=functools.partial(isr.instance_sample_reduce, tables,
                                     SEGM_LEVELS, *taps, k),
            plain=functools.partial(isr.instance_sample_reduce_plain, tables,
                                    SEGM_LEVELS, *taps, k),
            library=None, bound=k4_bound(rows, gx, dtype), device_ms=True,
            bitwise=True, tol=tol,
            shape=f"B=1 H={nh} LQ={lq} k={k}, levels {SEGM_LEVELS} "
            f"({rows} quad rows read), {str(dtype)[6:]} tables, tile {tq} "
            f"queries x {warps} warps, {splits} blocks a cluster")
    return cases


def box_sample_rows(dev):
    """Phase 3: K9 at the segm cell's two box-attention calls
    (`bench_kernels.K9_CALLS`) and at the 3D cell's two
    (`bench_kernels.K9_3D_CALLS`: batch 4, levels 235x235 and 118x118, P 4,
    rotated grids), inputs from `bench_kernels.k9_case`, two launches
    bitwise equal; its bound (`bench_kernels.k9_bound`); its device time is
    printed beside its CUDA-event time. Returns {name: case}."""
    from boxer_tpu_torch.ops import box_sample as bs
    from boxer_tpu_torch.tools import bench_kernels as bk

    calls = [("K9" if i == 0 else f"K9 P={npt}", "segm", call, npt, lq,
              bk.K9_BATCH, bk.SEGM_LEVELS, False)
             for i, (call, npt, lq) in enumerate(bk.K9_CALLS)]
    calls += [(f"K9 3D {call}", "3D", call, npt, lq, bk.K9_3D_BATCH,
               bk.PP3D_LEVELS, True) for call, npt, lq in bk.K9_3D_CALLS]
    cases = {}
    for i, (name, model, call, npt, lq, b, levels, turn) in enumerate(calls):
        value, gx, gy, aw = bk.k9_case(dev, 90 + i, npt, lq, b=b,
                                       shapes=levels, turn=turn)
        args = (value, levels, gx, gy, aw)
        cases[name] = dict(
            wrapper=bs.box_sample_reduce,
            kernel=functools.partial(bs.box_sample_reduce, *args),
            plain=functools.partial(bs.box_sample_reduce_plain, *args),
            library=None, bound=bk.k9_bound(value, gx), device_ms=True,
            bitwise=True, tol=1e-2,
            shape=f"the {model} {call} call: B={b} H={bk.K9_HEADS} "
            f"P={npt} LQ={gx.shape[-1]}, levels {levels}, bf16"
            + (", rotated" if turn else ""))
    return cases


def pillar_rows(dev):
    """Phase 3: K10 against its plain version at the pp3d.infer_b4 cell's
    pillar net (`bench_kernels.k10_case`: 4 frames of 60,000 pillars of 20
    points, filters 64 and 128, bf16 weights), judged by a pillar's
    relative error (`bench_kernels.pillar_err`; an empty pillar's -1e9
    would swamp the largest-element error), two launches bitwise equal;
    its bound (`bench_kernels.k10_bound`); its device time is printed
    beside its CUDA-event time. Returns {name: case}."""
    from boxer_tpu_torch.ops import pillar_net as pn
    from boxer_tpu_torch.tools import bench_kernels as bk

    feats, n, coors, net = bk.k10_case(dev, 100)
    args = (feats, n, coors, bk.PP3D_VOXEL, bk.PP3D_RANGE, net.pfn_layers)
    with torch.no_grad():
        out = pn.pillar_features(*args)
    return {"K10": dict(
        wrapper=pn.pillar_features,
        kernel=torch.no_grad()(functools.partial(pn.pillar_features, *args)),
        plain=torch.no_grad()(functools.partial(pn.pillar_features_plain,
                                                *args)),
        library=None, bound=bk.k10_bound(feats, out), device_ms=True,
        bitwise=True, err=bk.pillar_err, tol=1e-2,
        shape=f"the 3D cell's pillar net: V={feats.shape[0]} P="
        f"{feats.shape[1]}, filters (64, 128), bf16")}


def box_attention_grads(dev):
    """Phase 3c: the gradients of `box_attention` (reference contract,
    default fold) at P=16, the folded path through `TakeRows` and K7b, at the
    JAX package's chip-test shape, against the same op with K7b swapped for
    its plain version. The output must carry a grad_fn."""
    ba = importlib.import_module("boxer_tpu_torch.ops.box_attention")
    from boxer_tpu_torch.ops import scatter_accum as sa

    shapes, nh, ch, lq, p = ((80, 120), (40, 60)), 2, 32, 600, 16
    rs = np.random.RandomState(5)
    value = rs.rand(1, sum(h * w for h, w in shapes), nh, ch).astype(
        np.float32) * 0.01
    loc = rs.uniform(0.05, 0.95, (1, lq, nh, 2, p, 2)).astype(np.float32)
    weight = rs.rand(1, lq, nh, 2, p).astype(np.float32)
    weight /= weight.sum(axis=(-1, -2), keepdims=True)
    cot = torch.from_numpy(rs.randn(1, lq, nh * ch).astype(np.float32)).to(
        dev)

    def grads():
        ts = [torch.from_numpy(a).to(dev).requires_grad_()
              for a in (value, loc, weight)]
        out = ba.box_attention(ts[0], shapes, ts[1], ts[2])
        if out.grad_fn is None:
            raise AssertionError("box_attention's output has no grad_fn")
        before = sa.scatter_add_rows_pmajor.launches
        (out * cot).sum().backward()
        torch.cuda.synchronize()
        return ([t.grad for t in ts],
                sa.scatter_add_rows_pmajor.launches - before)

    got, n_kernel = grads()
    kernel = ba.scatter_add_rows_pmajor
    ba.scatter_add_rows_pmajor = sa.scatter_rows_plain
    try:
        want, n_plain = grads()
    finally:
        ba.scatter_add_rows_pmajor = kernel
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    log(f"box_attention P=16 grads on the card, K7b vs its plain version: "
        f"value {errs[0]:.3e}, loc {errs[1]:.3e}, weight {errs[2]:.3e} "
        f"(K7b launches {n_kernel}, with the plain version {n_plain})")
    if n_kernel != len(shapes) or n_plain or max(errs) > 1e-5:
        raise AssertionError("box_attention's gradients through K7b disagree")


# phase 3d: the matcher's solve (H1) at the shipped configs' matching
# calls, (label, batch, layers stacked by `criterion/losses.py:
# match_layers`, padded targets NT, queries or proposals NQ, valid targets
# a frame as the loaders give them, 3D): the 2D decoder (max_boxes 100, 300
# queries, 6 layers), the 2D encoder head (the 37,485 tokens of the
# 1344x1344 canvas at strides 8-64, pruned to 100 x 10,000), the Waymo
# decoder (max_boxes 250, 300 queries, 2 layers) and its encoder head
# (phase 11's 207,447 proposals, pruned to 250 x 62,500); batch 2
ASSIGN_CALLS = (("2D decoder", 2, 6, 100, 300, (1, 60), False),
                ("2D encoder", 2, 1, 100, 37_485, (1, 60), False),
                ("Waymo decoder", 2, 2, 250, 300, (20, 70), True),
                ("Waymo encoder", 2, 1, 250, 207_447, (20, 70), True))


def matching_inputs(rs, batch, layers, nt, nq, counts, is_3d, dev):
    """Random outputs of `layers` layers of `batch` frames and the frames'
    targets with `counts` valid, on `dev`: ([output dict a layer],
    targets), as the criterion hands them to `match_layers`. An encoder
    head (layers 1, NQ > 4 NT) has one class and NEG_INF logits with zero
    boxes on a tenth of its proposals, as the models mask them."""
    from boxer_tpu_torch.nn.predictor import NEG_INF

    nb, encoder = batch * layers, nq > 4 * nt
    ncls = 1 if encoder else (3 if is_3d else BENCH["num_classes"])

    def boxes(n, k):
        if is_3d:
            return np.concatenate([rs.uniform(0.05, 0.95, (n, k, 3)),
                                   rs.uniform(0.005, 0.05, (n, k, 3)),
                                   rs.uniform(-1, 1, (n, k, 1))], -1)
        return np.concatenate([rs.uniform(0.1, 0.9, (n, k, 2)),
                               rs.uniform(0.02, 0.4, (n, k, 2))], -1)

    logits = rs.randn(nb, nq, ncls).astype(np.float32)
    pred = boxes(nb, nq).astype(np.float32)
    if encoder:
        masked = rs.rand(nb, nq) < 0.1
        logits[masked], pred[masked] = NEG_INF, 0.0
    valid = np.arange(nt)[None, :] < np.asarray(counts)[:, None]
    targets = {"labels": rs.randint(0, ncls, (batch, nt)).astype(np.int32),
               "boxes": boxes(batch, nt).astype(np.float32), "valid": valid}
    return [{"pred_logits": torch.from_numpy(logits[i::layers]).to(dev),
             "pred_boxes": torch.from_numpy(pred[i::layers]).to(dev)}
            for i in range(layers)], {k: torch.from_numpy(v).to(dev)
                                      for k, v in targets.items()}


# H1 at these calls as one block a problem solved them (e0deb11, `PERF.md`
# section 6: NVIDIA H100 80GB HBM3, 700 W, CUDA events, mean of 5)
ONE_BLOCK_H1_MS = {"2D decoder": 0.0520, "2D encoder": 0.4231,
                   "Waymo decoder": 0.1398, "Waymo encoder": 0.9501}
# the cluster sizes phase 3d holds against the plain version at each call
H1_CLUSTERS = (1, 2, 4, 8, 16)


def assignment_calls(dev):
    """ASSIGN_CALLS's inputs from one seed, in order: yields (label,
    layers, batch, nt, nq, [output dict a layer], targets, matcher)."""
    from boxer_tpu_torch.nn import matcher as mt

    rs = np.random.RandomState(11)
    for label, batch, layers, nt, nq, (lo, hi), is_3d in ASSIGN_CALLS:
        counts = rs.randint(lo, hi + 1, batch)
        outputs, targets = matching_inputs(rs, batch, layers, nt, nq, counts,
                                           is_3d, dev)
        matcher = (mt.HungarianMatcher3d(2, 5, 2, 4) if is_3d
                   else mt.HungarianMatcher(2, 5, 2, focal_label=True))
        yield label, layers, batch, nt, nq, outputs, targets, matcher


def assignment_of(matcher, outputs, targets):
    """The layers stacked as `match_layers` stacks them and the problem as
    `hungarian` builds it from their cost matrix: (valid, sub, n_rows,
    rows, cand)."""
    from boxer_tpu_torch.nn import matcher as mt

    layers = len(outputs)
    stacked = {k: torch.cat([o[k] for o in outputs]) for k in outputs[0]}
    tiled = {k: v.repeat((layers,) + (1,) * (v.dim() - 1))
             for k, v in targets.items()}
    cost = matcher.cost_matrix(stacked, tiled).transpose(-1, -2)
    return (tiled["valid"],) + tuple(mt.assignment_problem(cost,
                                                           tiled["valid"]))


def check_assignment(dev, smi):
    """Phase 3d: H1 against its plain version at the shipped matching calls
    (ASSIGN_CALLS), the costs from the matchers' own `cost_matrix` on
    random outputs and the problems as `hungarian` builds them (valid rows
    first, pruned columns): col4row equal at the rule's cluster size and
    at each of H1_CLUSTERS the card can hold; the plain version equal to
    scipy on the host for the first problem; the criterion's matching
    (`match_layers`: the cost matrices and `hungarian`) and the kernel free
    of host syncs (`torch.cuda.set_sync_debug_mode("error")`). Times
    the kernel at each cluster size and the plain version (CUDA events)
    and scipy (host clock, one problem); the bound is the bytes the solve
    must move, each once, at 3.35 TB/s: the cost rows of each problem's
    valid rows (a solve visits each), n_rows and col4row. The kernel is
    bound by its chain of dependent Dijkstra steps, not by these bytes: the
    plain version's step count stands beside the bound, and the kernel's
    ms a step is its ms over the longest problem's steps. Returns {label:
    result dict}."""
    from scipy.optimize import linear_sum_assignment

    from boxer_tpu_torch.criterion.losses import match_layers
    from boxer_tpu_torch.ops import hungarian as hg
    from boxer_tpu_torch.tools import bench_combine as bc

    results = {}
    for (label, layers, batch, nt, nq, outputs, targets,
         matcher) in assignment_calls(dev):
        torch.cuda.synchronize()
        before = hg.solve_assignment.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            matched = torch.cat(match_layers(matcher, outputs, targets)[0])
            valid, sub, n_rows, rows, cand = assignment_of(matcher, outputs,
                                                           targets)
            got = hg.solve_assignment(sub, n_rows)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        launched = hg.solve_assignment.launches - before
        del outputs
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        want, steps = hg.solve_assignment_plain(sub, n_rows,
                                                count_steps=True)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        equal = torch.equal(got, want)
        nb, n, m = sub.shape
        by_c, refused = {}, []
        for c in H1_CLUSTERS:
            if not hg.max_active_clusters(dev, n, m, c):
                refused.append(c)
                continue
            same = torch.equal(hg.solve_assignment(sub, n_rows, c), want)
            by_c[c] = bc.cuda_ms(lambda c=c: hg.solve_assignment(
                sub, n_rows, c), 5)
            equal = equal and same
        # the criterion's matches: the solve mapped back to the original
        # rows and columns
        col = got if cand is None else cand.gather(1, got)
        col = torch.empty_like(col).scatter_(1, rows, col)
        mapped = torch.equal(col[valid], matched[valid])
        k = int(n_rows[0])
        host = sub[0, :k].cpu().numpy()
        t0 = time.perf_counter()
        r_idx, c_idx = linear_sum_assignment(host)
        scipy_ms = (time.perf_counter() - t0) * 1e3
        scipy_ok = (r_idx.tolist() == list(range(k))
                    and c_idx.tolist() == want[0, :k].tolist())
        clusters = hg.cluster_size(m)
        r = dict(shape=f"{tuple(sub.shape)}", plain_ms=plain_ms,
                 ms=bc.cuda_ms(lambda: hg.solve_assignment(sub, n_rows), 5),
                 max_abs_err=float((got - want).abs().max()),
                 library_ms=None, scipy_ms=scipy_ms, steps=steps.tolist(),
                 n_rows=n_rows.tolist(), clusters=clusters, by_c=by_c,
                 one_block_ms=ONE_BLOCK_H1_MS[label])
        r["step_us"] = 1e3 * r["ms"] / max(int(steps.max()), 1)
        r["bound_ms"], r["bound_by"] = bc.bound_ms(
            int(n_rows.sum()) * m * 4 + nb * 4 + nb * n * 8, 0)
        log(f"H1 [{label}: {layers} layer(s) x batch {batch}, NT {nt}, NQ "
            f"{nq} -> {r['shape']}, valid rows {r['n_rows']}] [{smi}]: "
            f"equal to plain {equal} (at C {clusters} and "
            f"{sorted(by_c)}; the card holds no cluster of {refused}), "
            f"plain equal to scipy on problem 0 "
            f"{scipy_ok}, `match_layers` the same matches {mapped}, launches "
            f"under the sync check {launched} (no host sync); Dijkstra steps "
            f"{r['steps']}; kernel {r['ms']:.4f} ms at C {clusters} "
            f"({r['step_us']:.2f} us a step of the longest problem; one "
            f"block a problem, e0deb11: {r['one_block_ms']:.4f} ms), by C "
            + ", ".join(f"{c}: {t:.4f}" for c, t in by_c.items())
            + f" ms; plain {plain_ms:.4f} ms, scipy {scipy_ms:.4f} host ms "
            f"(problem 0), library none, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}: the valid rows' cost rows, n_rows and "
            f"col4row once; {int(steps.sum())} dependent Dijkstra steps in "
            f"all)")
        if not (equal and scipy_ok and mapped and launched == 2
                and clusters in by_c):
            raise AssertionError(f"H1 at the {label} call: equal {equal}, "
                                 f"scipy {scipy_ok}, mapped {mapped}, "
                                 f"launches {launched}, C {clusters} held "
                                 f"{clusters in by_c}")
        results[label] = r
        del sub, got, want, matched, col
        torch.cuda.empty_cache()
    return results


def build_model(use_mask, seed=0, noise_seed=None, dropout=0.0):
    """BoxeR2D at the bench width with seeded weights; with noise_seed the
    zero-initialised heads get a little seeded noise so sampling offsets,
    attention weights and logits spread."""
    from boxer_tpu_torch.models.boxer2d import BoxeR2D

    model = BoxeR2D(**BENCH, use_mask=use_mask, dropout=dropout).init_weights(
        seed).eval()
    if noise_seed is not None:
        rs = np.random.RandomState(noise_seed)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith(("linear_box_weight", "linear_attn_weight",
                                  "class_embed.bias")):
                    p.add_(torch.from_numpy(
                        rs.randn(*p.shape).astype(np.float32) * 0.05))
    return model


def make_image(hw, seed=0):
    rs = np.random.RandomState(seed)
    image = torch.from_numpy(rs.randn(1, *hw, 3).astype(np.float32))
    return image, torch.zeros((1, *hw), dtype=torch.bool)


def counters():
    from boxer_tpu_torch.ops import box_sample as bs
    from boxer_tpu_torch.ops import combine_reduce as cr
    from boxer_tpu_torch.ops import flash_attention as fa
    from boxer_tpu_torch.ops import hungarian as hg
    from boxer_tpu_torch.ops import instance_sample as isr
    from boxer_tpu_torch.ops import pillar_net as pn
    from boxer_tpu_torch.ops import scatter_accum as sa

    return {"K1": cr.quad_sample_reduce_raw, "K2": cr.quad_sample_reduce_w4,
            "K3": fa.flash_attention, "K4": isr.instance_sample_reduce,
            "K5": sa.scatter_add_rows_weighted,
            "K6": sa.scatter_add_rows_pmajor_weighted,
            "K7a": sa.scatter_add_rows, "K7b": sa.scatter_add_rows_pmajor,
            "K8": cr.quad_sample_reduce_mmajor, "K9": bs.box_sample_reduce,
            "K10": pn.pillar_features, "H1": hg.solve_assignment}


@contextlib.contextmanager
def sampling(**constants):
    """Set module constants of the sampling op (`FOLD_TAP_THRESHOLD`) for
    a phase and restore them after it."""
    ba = importlib.import_module("boxer_tpu_torch.ops.box_attention")

    saved = {k: getattr(ba, k) for k in constants}
    for k, v in constants.items():
        setattr(ba, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(ba, k, v)


def timed(fn, iters, dev):
    """`iters` calls of fn(), each on the host clock up to a synchronize,
    with the launch counters zeroed and the peak memory reset just before
    them; only the last call's result is kept alive, so the peak is one
    call's. Returns (times in ms, launch counts, the last result)."""
    torch.cuda.reset_peak_memory_stats(dev)
    for f in counters().values():
        f.launches = 0
    times, out = [], None
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, {k: f.launches for k, f in counters().items()}, out


def run_slice(dev, use_mask, iters, label):
    """Phase 4: a warm-up forward, then `iters` forwards each timed on the
    host clock up to a synchronize, with the launch counters zeroed just
    before them. Returns (img/s at the median forward, counts)."""
    model = build_model(use_mask).to(dev, torch.bfloat16)
    image, mask = (t.to(dev) for t in make_image(CANVAS))
    post = {"canvas_hw": CANVAS, "topk": 100}
    with torch.no_grad():
        model(image, mask, postprocess=post)
        torch.cuda.synchronize()
        times, counts, out = timed(
            lambda: model(image, mask, postprocess=post), iters, dev)
    ms = float(np.median(times))
    fps = 1e3 / ms
    log(f"{label}: {fps:.3f} img/s (median {ms:.2f} ms/img of {iters} "
        f"forwards: {', '.join(f'{t:.2f}' for t in times)}; peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB), "
        f"launches {counts}")

    k = post["topk"]
    want = {"scores": (1, k), "labels": (1, k), "boxes": (1, k, 4)}
    if use_mask:
        want["masks"] = (1, k, *CANVAS)
    for key, shape in want.items():
        if tuple(out[key].shape) != shape:
            raise AssertionError(f"{label}: {key} {tuple(out[key].shape)} "
                                 f"!= {shape}")
        if out[key].is_floating_point() and not torch.isfinite(out[key]).all():
            raise AssertionError(f"{label}: {key} not finite")
    expect = {k: v * iters for k, v in INFER_LAUNCHES[use_mask].items()}
    if counts != expect:
        raise AssertionError(f"{label}: launches {counts} != {expect}")
    del model
    torch.cuda.empty_cache()
    return fps, counts


def card_vs_cpu(dev):
    """Phase 5: same weights and image, f32, card (kernels) vs CPU
    (plain)."""
    model = build_model(True, seed=1, noise_seed=2)
    image, mask = make_image(E2E_CANVAS, seed=1)
    post = {"canvas_hw": E2E_CANVAS, "topk": 100}
    with torch.no_grad():
        want = model(image, mask, postprocess=post)
        model.to(dev)
        before = {k: f.launches for k, f in counters().items()}
        got = {k: v.cpu() for k, v in model(image.to(dev), mask.to(dev),
                                            postprocess=post).items()}
    torch.cuda.synchronize()
    after = {k: f.launches for k, f in counters().items()}
    if any(after[k] == before[k] for k in ("K9", "K3", "K4")):
        raise AssertionError("card run did not go through every kernel")
    label_eq = bool((got["labels"] == want["labels"]).all())
    score_err = float((got["scores"] - want["scores"]).abs().max())
    box_err = float((got["boxes"] - want["boxes"]).abs().max())
    mask_diff = float((got["masks"] != want["masks"]).float().mean())
    log(f"card vs CPU at {E2E_CANVAS} f32: labels equal {label_eq}, "
        f"score max abs err {score_err:.3e}, box max abs err {box_err:.3e} px,"
        f" mask pixels differing {mask_diff:.3e}")
    if not (label_eq and score_err <= 1e-3 and box_err <= 1e-3
            and mask_diff < 1e-3):
        raise AssertionError("card and CPU disagree")
    return dict(score_err=score_err, box_err=box_err, mask_diff=mask_diff)


def profile(fn, wall_ms, label):
    """Run fn() once under torch.profiler after a warm-up call. Prints the
    device's summed kernel time (the port's spans left out) against the unprofiled wall time `wall_ms`
    (the busy share; the rest the device idles while the host dispatches)
    and the top kernels by device time. Returns (busy ms, share, {kernel
    name: (device ms, calls)})."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    from boxer_tpu_torch.utils.timer import device_events

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"profile, {label}: device busy {busy_ms:.2f} ms of a {wall_ms:.2f} "
        f"ms run ({100 * busy_ms / wall_ms:.1f}%); top kernels:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms  {e.count:4d}x  "
            f"{e.key[:90]}")
    return busy_ms, busy_ms / wall_ms, {
        e.key: (e.self_device_time_total / 1e3, e.count) for e in kernels}


def k5_call_ms(by_kernel):
    """Device ms per call of the weighted scatter (K5, or K6: one kernel)
    in a profile's kernels."""
    ms, calls = map(sum, zip(*[v for k, v in by_kernel.items()
                               if "scatter_weighted_kernel" in k]))
    return ms / calls


def profile_forward(dev, forward_ms):
    """Phase 6: one segm forward under the profiler."""
    model = build_model(True).to(dev, torch.bfloat16)
    image, mask = (t.to(dev) for t in make_image(CANVAS))
    post = {"canvas_hw": CANVAS, "topk": 100}
    with torch.no_grad():
        profile(lambda: model(image, mask, postprocess=post), forward_ms,
                "segm forward")
    del model
    torch.cuda.empty_cache()


def train_setup(model, use_mask, compute_dtype, debug_grads=False):
    """The recipe's criterion, AdamW and train step around `model`."""
    from boxer_tpu_torch.criterion.losses import Boxer2DCriterion
    from boxer_tpu_torch.nn.matcher import HungarianMatcher
    from boxer_tpu_torch.optim import build_optimizer, build_schedule
    from boxer_tpu_torch.parallel.steps import TrainState, make_train_step

    weights = dict(TRAIN_WEIGHTS, **(MASK_WEIGHTS if use_mask else {}))
    losses = ["boxes", "focal_labels"] + (["masks"] if use_mask else [])
    criterion = Boxer2DCriterion(BENCH["num_classes"],
                                 HungarianMatcher(2, 5, 2, focal_label=True),
                                 weights, losses)
    state = TrainState(model, build_optimizer(OPTIM, model),
                       build_schedule(SCHEDULE, base_lr=2e-4))
    step = make_train_step(criterion, max_norm=0.1,
                           compute_dtype=compute_dtype,
                           debug_grads=debug_grads)
    return criterion, state, step


def train_batch(hw, use_mask, dev, seed=0):
    from boxer_tpu_torch.dataset.synthetic import synthetic_batch

    batch = synthetic_batch(1, *hw, num_targets=20,
                            num_classes=BENCH["num_classes"],
                            with_masks=use_mask, seed=seed,
                            iter_per_update=1)

    def put(x):
        return {k: put(v) for k, v in x.items()} if isinstance(x, dict) \
            else torch.from_numpy(x).to(dev)

    return put(batch)


def check_grads(grads, label):
    """Every trainable parameter has a finite gradient, and no sampling
    layer's value_proj / linear_box_weight / linear_attn_weight gradient is
    all zero (a detached kernel output would leave them so)."""
    bad = [n for n, g in grads.items()
           if g is None or not bool(torch.isfinite(g).all())]
    if bad:
        raise AssertionError(f"{label}: missing or non-finite grads {bad}")
    watched = [n for n in grads if "value_proj" in n
               or n.endswith(("linear_box_weight", "linear_attn_weight"))]
    zero = [n for n in watched if not bool(grads[n].abs().max() > 0)]
    n_layers = BENCH["enc_layers"] + BENCH["dec_layers"]
    if zero or len(watched) != 4 * n_layers:
        raise AssertionError(f"{label}: zero grads in {zero} "
                             f"({len(watched)} watched)")


def loss_falls_along_gradient(model, criterion, batch, label,
                              step_norm=1e-3):
    """The total loss of the step's forward (bf16 autocast) on its batch
    falls after a parameter step of L2 norm `step_norm` against its
    gradient: the backward is a descent direction of the full-width loss.
    The parameters are restored after it. Over a few AdamW steps the loss
    moves up and down on either path, and a finite step can flip a top-k
    proposal or a match (the loss is discontinuous there), so the check
    starts from the initial weights with a small step. Returns (loss
    before, loss after, predicted after)."""
    from boxer_tpu_torch.criterion.losses import weighted_total

    weight_dict = criterion.expanded_weight_dict(num_aux=16, num_enc=2)
    targets = {k: v[0] for k, v in batch["targets"].items()}
    num_boxes = criterion.compute_num_boxes(batch["targets"])
    mask = batch.get("mask")

    def total():
        with torch.autocast(batch["image"].device.type, dtype=torch.bfloat16):
            out = model(batch["image"][0], None if mask is None else mask[0],
                        train=True, inference=False)
        return weighted_total(criterion(out, targets, num_boxes=num_boxes),
                              weight_dict)[0]

    params = [p for p in model.parameters() if p.requires_grad]
    saved = [p.detach().clone() for p in params]
    before = total()
    before.backward()
    norm = torch.sqrt(sum((p.grad.float() ** 2).sum() for p in params
                          if p.grad is not None))
    with torch.no_grad():
        for p in params:
            if p.grad is not None:
                p.sub_(p.grad * (step_norm / norm))
        after = float(total())
        for p, s in zip(params, saved):
            p.copy_(s)
            p.grad = None
    before, norm = float(before.detach()), float(norm)
    predicted = before - step_norm * norm
    log(f"  a step of norm {step_norm:g} against the gradient (norm "
        f"{norm:.5g}) from the initial weights: total loss {before:.6g} -> "
        f"{after:.6g} (linear prediction {predicted:.6g})")
    if not after < before:
        raise AssertionError(f"{label}: the loss did not fall along its "
                             "gradient")
    return before, after, predicted


def run_train(dev, use_mask, label, profiled=False, per_step=None,
              falling=False):
    """Phases 7 and 7c: with `falling`, first the loss must fall along its
    gradient; then a warm-up step (its pre-clip gradients checked), then
    TRAIN_STEPS timed steps on the same batch with the launch counters
    zeroed just before them; the counts must be `per_step` (by default the
    per-tap step's) per step. Returns (median ms/step, peak GiB, counts,
    profile)."""
    from boxer_tpu_torch.parallel.steps import make_train_step

    model = build_model(use_mask).to(dev).train()
    criterion, state, step = train_setup(model, use_mask, torch.bfloat16)
    debug_step = make_train_step(criterion, max_norm=0.1,
                                 compute_dtype=torch.bfloat16,
                                 debug_grads=True)
    batch = train_batch(CANVAS, use_mask, dev)
    if falling:
        loss_falls_along_gradient(model, criterion, batch, label)
    terms = (["total_loss", "loss_ce", "loss_bbox", "loss_giou"]
             + (["loss_mask", "loss_dice"] if use_mask else [])
             + ["loss_ce_enc_0", "grad_norm"])

    def show(stats):
        return ", ".join(f"{k} {stats[k]:.5g}" for k in terms)

    state, first = debug_step(state, batch)
    torch.cuda.synchronize()
    check_grads(first.pop("_grads"), label)
    all_stats = [first]
    times, counts, _ = timed(
        lambda: all_stats.append(step(state, batch)[1]), TRAIN_STEPS, dev)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    ms = float(np.median(times))
    log(f"{label}: {ms:.2f} ms/step median of {TRAIN_STEPS} steps "
        f"({', '.join(f'{t:.2f}' for t in times)}); peak {peak:.2f} GiB; "
        f"launches per step {({k: v / TRAIN_STEPS for k, v in counts.items()})}")
    log(f"  first step: {show(all_stats[0])}")
    log(f"  last step:  {show(all_stats[-1])}")
    losses = [st["total_loss"] for st in all_stats]
    log(f"  total loss by step: {', '.join(f'{v:.5g}' for v in losses)}")
    for i, st in enumerate(all_stats):
        if st["skipped"] != 0.0 or not all(np.isfinite(v) for k, v in
                                           st.items() if k != "_grads"):
            raise AssertionError(f"{label}: step {i} skipped or not finite: "
                                 f"{st}")
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    if bad or state.step != TRAIN_STEPS + 1:
        raise AssertionError(f"{label}: after the last step {bad}, step "
                             f"{state.step}")
    per_step = TRAIN_LAUNCHES[use_mask] if per_step is None else per_step
    expect = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    if counts != expect:
        raise AssertionError(f"{label}: launches {counts} != {expect}")
    busy = profile(lambda: step(state, batch), ms,
                   f"{label}, one step") if profiled else None
    del model, state, step, debug_step
    torch.cuda.empty_cache()
    return ms, peak, counts, busy


def k5_in_model(dev):
    """Phase 7d: K5 on the model's own indices. One full-width segm train
    step with the fused scatter's wrapper recording its inputs at encoder
    level 0 (its first call on that level's 123,624-row table); then the
    fused kernel and the d_table kernel alone on them and on the same
    inputs with random rows: time, error against the plain version, and the
    distinct rows in a block's tile of 32 outputs x P taps."""
    ba = importlib.import_module("boxer_tpu_torch.ops.box_attention")
    from boxer_tpu_torch.ops import scatter_accum as sa
    from boxer_tpu_torch.tools import bench_combine as bc
    from boxer_tpu_torch.tools import bench_kernels as bk

    captured = []
    fused = ba.scatter_add_rows_weighted_dw4

    def record(idx, g, w4, table, per_tap, **kw):
        if not per_tap and table.shape[0] == bk.ROWS and not captured:
            captured.append(tuple(t.clone() for t in (idx, g, w4, table)))
        return fused(idx, g, w4, table, per_tap, **kw)

    model = build_model(True).to(dev).train()
    _, state, step = train_setup(model, True, torch.bfloat16)
    ba.scatter_add_rows_weighted_dw4 = record
    try:
        step(state, train_batch(CANVAS, True, dev))
    finally:
        ba.scatter_add_rows_weighted_dw4 = fused
    del model, state, step
    torch.cuda.empty_cache()
    idx, g, w4, table = captured[0]
    p, m = idx.shape
    tiles = idx[:, :m // 32 * 32].reshape(p, -1, 32).transpose(0, 1)
    srt = tiles.reshape(-1, p * 32).sort(dim=1).values
    distinct = float(((srt[:, 1:] != srt[:, :-1]).sum(1) + 1).float().mean())
    gen = torch.Generator(device=dev).manual_seed(0)
    random = torch.randint(0, table.shape[0], idx.shape, generator=gen,
                           device=dev, dtype=torch.int32)
    res = {}
    for name, ix in (("model", idx), ("random", random)):
        got = sa.scatter_add_rows_weighted_dw4(ix, g, w4, table, False)
        want = sa.scatter_accum_dw4_plain(ix, g, w4, table, False)
        err = max(rel_err(a, b) for a, b in zip(got, want))
        res[name] = dict(err=err, fused_ms=bc.cuda_ms(
            lambda: sa.scatter_add_rows_weighted_dw4(ix, g, w4, table,
                                                     False)),
            table_ms=bc.cuda_ms(lambda: sa.scatter_add_rows_weighted(
                ix, g, w4, table.shape[0])))
    log(f"K5 at encoder level 0 of a segm train step (P={p} M={m}, "
        f"{table.dtype} table): a tile of 32 outputs x {p} taps holds "
        f"{distinct:.1f} distinct rows of {32 * p}; " + "; ".join(
            f"{k} rows: fused {v['fused_ms']:.4f} ms, d_table alone "
            f"{v['table_ms']:.4f} ms, rel err {v['err']:.2e}"
            for k, v in res.items()))
    if max(v["err"] for v in res.values()) > 1e-5:
        raise AssertionError("K5 on the model's indices disagrees with its "
                             "plain version")
    return res


def k7b_model_inputs(dev):
    """K7b's inputs at the 4 encoder levels of one full-width folded
    detection train step (bf16 autocast, `FOLD_TAP_THRESHOLD = 0`): the
    first call of `TakeRows`' backward on each level's table with the
    encoder's M = 8 x 20,197 queries. Returns [(idx (P, M), payload
    (P*M, 128), rows)] from level 0 to 3."""
    ba = importlib.import_module("boxer_tpu_torch.ops.box_attention")
    from boxer_tpu_torch.tools import bench_kernels as bk

    m_enc = bk.K1_SHAPES[0][1]
    captured = {}
    scatter = ba.scatter_add_rows_pmajor

    def record(idx, payload, rows):
        if idx.shape[1] == m_enc and rows not in captured:
            captured[rows] = (idx.clone(), payload.clone(), rows)
        return scatter(idx, payload, rows)

    model = build_model(False).to(dev).train()
    _, state, step = train_setup(model, False, torch.bfloat16)
    ba.scatter_add_rows_pmajor = record
    try:
        with sampling(FOLD_TAP_THRESHOLD=0):
            step(state, train_batch(CANVAS, False, dev))
    finally:
        ba.scatter_add_rows_pmajor = scatter
    del model, state, step
    torch.cuda.empty_cache()
    if len(captured) != 4:
        raise AssertionError(f"K7b captured at {len(captured)} encoder "
                             "levels, not 4")
    return [captured[r] for r in sorted(captured, reverse=True)]


def k7b_in_model(dev):
    """Phase 7d: K7b on the model's own indices at the 4 encoder levels of
    a folded detection step: taps a row (mean over the rows hit, and the
    most), the kernel's error against its plain version (rel 1e-5), and its
    time beside the plain version's and the library call's (a zeroed table
    and `index_add_`)."""
    from boxer_tpu_torch.ops import scatter_accum as sa
    from boxer_tpu_torch.tools import bench_combine as bc
    from boxer_tpu_torch.tools import bench_kernels as bk

    res = []
    for level, (idx, pay, rows) in enumerate(k7b_model_inputs(dev)):
        mean, most = bk.taps_per_row(idx, rows)
        got = sa.scatter_add_rows_pmajor(idx, pay, rows)
        err = rel_err(got, sa.scatter_rows_plain(idx, pay, rows))
        r = dict(level=level, rows=rows, mean=mean, most=most, err=err,
                 ms=bc.cuda_ms(lambda: sa.scatter_add_rows_pmajor(
                     idx, pay, rows)),
                 plain_ms=bc.cuda_ms(lambda: sa.scatter_rows_plain(
                     idx, pay, rows)),
                 library_ms=bc.cuda_ms(bk.index_add_call(idx, pay, rows)),
                 bound_ms=bk.k7_bound(idx, pay, rows)[0])
        log(f"K7b at encoder level {level} of a folded detection step (P="
            f"{idx.shape[0]} M={idx.shape[1]}, {rows} rows): {mean:.1f} taps "
            f"a row hit, at most {most}; kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms, rel err {err:.2e}")
        res.append(r)
        if not err <= 1e-5:
            raise AssertionError(f"K7b at encoder level {level} disagrees "
                                 "with its plain version")
    return res


class RecordingMatcher:
    """A matcher that keeps every match it returns (on the CPU) and its
    smallest margin: how near another query's cost comes to a matched
    query's for the same target. Within rounding of 0, another device may
    match the other query, so identical matches across devices need a
    margin well above it."""

    def __init__(self, matcher):
        self.matcher, self.calls, self.margin = matcher, [], float("inf")

    def __call__(self, outputs, targets):
        qi, valid = self.matcher(outputs, targets)
        self.calls.append(torch.where(valid, qi, -1).cpu())
        cost = self.matcher.cost_matrix(outputs, targets).transpose(-1, -2)
        chosen = cost.gather(-1, qi[..., None])
        gap = (cost - chosen).abs().scatter(-1, qi[..., None], float("inf"))
        self.margin = min(self.margin, float(gap.amin(-1)[valid].min()))
        return qi, valid


def recorded_step(model, device, setup, batch):
    """One f32 train step of a copy of `model` on `device`, through
    `setup(copy) -> (criterion, state, step)`, its matcher recording every
    match. Returns (stats with the pre-clip gradients on the CPU and the
    matches' smallest margin, `match_margin`, the matches, the launches of
    each kernel)."""
    import copy

    m = copy.deepcopy(model).to(device)
    criterion, state, step = setup(m)
    criterion.matcher = RecordingMatcher(criterion.matcher)
    before = {k: f.launches for k, f in counters().items()}
    _, stats = step(state, batch)
    torch.cuda.synchronize()
    after = {k: f.launches for k, f in counters().items()}
    stats["_grads"] = {n: g.cpu() for n, g in stats["_grads"].items()}
    stats["match_margin"] = criterion.matcher.margin
    return stats, criterion.matcher.calls, {k: after[k] - before[k]
                                            for k in after}


def leaf_errs(a, b):
    """Rel err of a's pre-clip gradient leaves against b's, over b's
    leaves: (the worst, its leaf, the median)."""
    errs = {n: rel_err(a["_grads"][n], g) for n, g in b["_grads"].items()}
    worst = max(errs, key=errs.get)
    return errs[worst], worst, float(np.median(list(errs.values())))


def train_card_vs_cpu(dev):
    """Phase 8: one f32 train step with phase 5's weights on the CPU (plain
    versions), on the card (kernels), and on the card with the fused K5/K6
    swapped for their plain version, plain d_table and plain d_w4 (the same
    forward, so the same ReLU branches)."""
    ba = importlib.import_module("boxer_tpu_torch.ops.box_attention")
    from boxer_tpu_torch.ops import scatter_accum as sa

    model = build_model(True, seed=1, noise_seed=2).train()

    def run(device):
        return recorded_step(
            model, device,
            lambda m: train_setup(m, True, torch.float32, debug_grads=True),
            train_batch(E2E_CANVAS, True, device, seed=1))

    want, want_qi, cpu_launches = run(torch.device("cpu"))
    got, got_qi, launches = run(dev)
    kernel = ba.scatter_add_rows_weighted_dw4
    ba.scatter_add_rows_weighted_dw4 = sa.scatter_accum_dw4_plain
    try:
        plain, _, plain_launches = run(dev)
    finally:
        ba.scatter_add_rows_weighted_dw4 = kernel
    if any(cpu_launches.values()) or not all(
            launches[k] for k in ("K2", "K3", "K5", "K6")) or (
            plain_launches["K5"] or plain_launches["K6"]):
        raise AssertionError(f"launches: CPU {cpu_launches}, card "
                             f"{launches}, card with plain K5/K6 "
                             f"{plain_launches}")
    same_match = len(got_qi) == len(want_qi) and all(
        torch.equal(g, w) for g, w in zip(got_qi, want_qi))
    keys = [k for k in want if k.startswith("loss_")] + ["total_loss"]
    loss_err = max(rel_err(got[k], want[k]) for k in keys)
    norm_err = rel_err(got["grad_norm"], want["grad_norm"])
    cpu_err, cpu_leaf, cpu_median = leaf_errs(got, want)
    k56_err, k56_leaf, _ = leaf_errs(got, plain)
    # the leaves d_w4 feeds first: the sampling-offset (box) and attention
    # weight projections
    sampling = {n: g for n, g in plain["_grads"].items() if n.endswith((
        "linear_box_weight", "linear_box_bias", "linear_attn_weight",
        "linear_attn_bias"))}
    dw4_err, dw4_leaf, _ = leaf_errs(got, {"_grads": sampling})
    log(f"train step at {E2E_CANVAS} f32: card vs CPU {len(got_qi)} matches "
        f"identical {same_match}, loss terms ({len(keys)}) worst rel err "
        f"{loss_err:.3e}, grad norm {norm_err:.3e}, pre-clip grads worst "
        f"leaf rel err {cpu_err:.3e} ({cpu_leaf}), median leaf "
        f"{cpu_median:.3e}; card K5/K6 (d_table and d_w4) vs their plain "
        f"version in the same step: worst leaf {k56_err:.3e} ({k56_leaf}), "
        f"of the {len(sampling)} sampling-offset and attention-weight "
        f"leaves {dw4_err:.3e} ({dw4_leaf})")
    # card vs CPU, the gradients: a ReLU whose input lies within rounding of
    # 0 takes the other branch on the other device and moves every leaf
    # upstream of it (one such unit of 2.09M in encoder layer 5 moves its
    # linear1 by 1.8e-2, backbone.layer4.1.conv1 by 2.75e-2), so the bound
    # there only catches gross faults such as a detached kernel output (rel
    # err 1); the kernels' own backward is held tightly in the same step
    if not (same_match and loss_err <= 1e-4 and norm_err <= 1e-3
            and cpu_err <= 0.1 and k56_err <= 1e-4 and sampling):
        raise AssertionError("train step: card and CPU disagree")
    return dict(loss_err=loss_err, grad_err=cpu_err, k56_err=k56_err,
                dw4_err=dw4_err)


def train_folded_vs_pertap(dev):
    """Phase 8c: one f32 detection step at 256x384 on the card with phase 5's
    weights and phase 8's batch, folded (`FOLD_TAP_THRESHOLD = 0`: every
    level through `TakeRows`, K7b in the backward) against per-tap
    (`QuadSample`: K2, K5), then folded with K7b swapped for its plain
    version (the same forward, so the same ReLU branches)."""
    ba = importlib.import_module("boxer_tpu_torch.ops.box_attention")
    from boxer_tpu_torch.ops import scatter_accum as sa

    model = build_model(False, seed=1, noise_seed=2).train()

    def run(threshold):
        with sampling(FOLD_TAP_THRESHOLD=threshold):
            return recorded_step(
                model, dev, lambda m: train_setup(m, False, torch.float32,
                                                  debug_grads=True),
                train_batch(E2E_CANVAS, False, dev, seed=1))

    folded, folded_qi, folded_launches = run(0)
    # P=4 taps per level: a threshold of 4 keeps every level per tap
    pertap, pertap_qi, pertap_launches = run(4)
    kernel = ba.scatter_add_rows_pmajor
    ba.scatter_add_rows_pmajor = sa.scatter_rows_plain
    try:
        plain, _, plain_launches = run(0)
    finally:
        ba.scatter_add_rows_pmajor = kernel
    if not (folded_launches["K7b"] and not folded_launches["K5"]
            and not folded_launches["K2"] and pertap_launches["K5"]
            and not pertap_launches["K7b"] and not plain_launches["K7b"]):
        raise AssertionError(f"launches: folded {folded_launches}, per-tap "
                             f"{pertap_launches}, folded with plain K7b "
                             f"{plain_launches}")
    same_match = len(folded_qi) == len(pertap_qi) and all(
        torch.equal(a, b) for a, b in zip(folded_qi, pertap_qi))
    keys = [k for k in pertap if k.startswith("loss_")] + ["total_loss"]
    loss_err = max(rel_err(folded[k], pertap[k]) for k in keys)
    norm_err = rel_err(folded["grad_norm"], pertap["grad_norm"])
    fold_err, fold_leaf, _ = leaf_errs(folded, pertap)
    k7b_err, k7b_leaf, _ = leaf_errs(folded, plain)
    log(f"detection train step at {E2E_CANVAS} f32 on the card, folded vs "
        f"per-tap: {len(folded_qi)} matches identical {same_match}, loss "
        f"terms ({len(keys)}) worst rel err {loss_err:.3e}, grad norm "
        f"{norm_err:.3e}, pre-clip grads worst leaf {fold_err:.3e} "
        f"({fold_leaf}); K7b vs its plain version in the folded step: worst "
        f"leaf {k7b_err:.3e} ({k7b_leaf}); K7b launches "
        f"{folded_launches['K7b']}")
    # the folded and per-tap forwards sum the taps in another order, so a
    # ReLU input within rounding of 0 may take the other branch (phase 8):
    # the leaves are held at 0.1 there and K7b at 1e-4 in the same forward
    if not (same_match and loss_err <= 1e-4 and norm_err <= 1e-3
            and fold_err <= 0.1 and k7b_err <= 1e-4):
        raise AssertionError("folded and per-tap train steps disagree")
    return dict(loss_err=loss_err, grad_err=fold_err, k7b_err=k7b_err)


def grid_3d(pc_range):
    """(nx, ny) of the drawn voxels (`random_voxels_3d`): the whole 0.32 m
    pillars over pc_range, 468 x 468 at full width as tools/mfu_bench.py:202
    sets it. A voxelized frame runs at the voxelizer's own grid instead
    (`dataset/waymo.py:grid_shape`, 469 x 469 there)."""
    return tuple(int((pc_range[3 + i] - pc_range[i]) / VOXEL_3D[i])
                 for i in range(2))


def build_model_3d(pc_range, seed=0, noise_seed=None):
    """BoxeR3D at the bench width with seeded weights; with noise_seed the
    heads JAX initialises to zero (`linear_box`, `linear_attn`, the box
    MLPs' last layer) get seeded noise, so sampling points move by more
    than a pixel, the decoder's dθ turns the grid and the boxes spread."""
    from boxer_tpu_torch.models.boxer3d import BoxeR3D

    backbone = {"type": "pointpillar", "params": {
        "hidden_dim": 256, "position_encoding": "fixed", "ref_size": 4,
        "return_layers": 2,
        "reader": {"num_input_features": 5, "num_filters": [64, 128],
                   "voxel_size": list(VOXEL_3D), "pc_range": list(pc_range)},
        "neck": {"num_layers": [2, 4, 2], "ds_strides": [1, 2, 2],
                 "ds_filters": [256, 512, 1024]}}}
    model = BoxeR3D(**BENCH_3D, backbone_cfg=backbone).init_weights(seed)
    if noise_seed is not None:
        rs = np.random.RandomState(noise_seed)
        with torch.no_grad():
            for name, p in model.named_parameters():
                scale = (0.15 if name.endswith("linear_box_weight") else 0.05
                         if name.endswith(("linear_attn_weight",
                                           "class_embed.bias"))
                         or "bbox_embed.layers.2." in name else 0)
                if scale:
                    p.add_(torch.from_numpy(
                        rs.randn(*p.shape).astype(np.float32) * scale))
    return model.eval()


def random_voxels_3d(grid, n_voxels, batch, seed):
    """`batch` frames of `n_voxels` voxels each, one after the other (the
    loader's fixed blocks): coordinates [b, 0, y, x] drawn without
    replacement over each frame's cells (two voxels on one cell would leave
    the scatter's winner unspecified), 1-20 points of 5 features a voxel,
    the unused slots zero. Returns numpy (voxels, coordinates, points)."""
    rs = np.random.RandomState(seed)
    nx, ny = grid
    parts = []
    for b in range(batch):
        cell = rs.choice(nx * ny, n_voxels, replace=False)
        n = rs.randint(1, POINTS_3D + 1, n_voxels).astype(np.int32)
        v = rs.randn(n_voxels, POINTS_3D, 5).astype(np.float32)
        v[np.arange(POINTS_3D)[None, :] >= n[:, None]] = 0.0
        c = np.stack([np.full(n_voxels, b), np.zeros(n_voxels, np.int64),
                      cell // nx, cell % nx], 1).astype(np.int32)
        parts.append((v, c, n))
    return tuple(np.concatenate(x) for x in zip(*parts))


def lidar_cloud(pc_range, n, seed):
    """A seeded frame of n points over the whole of pc_range's x-y square,
    its edges and corners included: ranges log-uniform from 2 m to the
    corner (denser near the sensor, as a spinning lidar's returns are), the
    points outside the square drawn again; z around the ground, intensity
    and elongation in [0, 1)."""
    rs = np.random.RandomState(seed)
    lo, hi = np.asarray(pc_range[:2]), np.asarray(pc_range[3:5])
    corner = float(np.hypot(*np.maximum(-lo, hi)))
    xy = np.zeros((0, 2))
    while len(xy) < n:
        r = np.exp(rs.uniform(np.log(2.0), np.log(corner), 2 * n))
        phi = rs.uniform(-np.pi, np.pi, 2 * n)
        cand = np.stack([r * np.cos(phi), r * np.sin(phi)], 1)
        xy = np.concatenate([xy, cand[((cand >= lo) & (cand < hi)).all(1)]])
    z = np.clip(rs.normal(0.0, 1.0, n), pc_range[2] + 0.01,
                pc_range[5] - 0.01)
    return np.concatenate([xy[:n], z[:, None], rs.rand(n, 2)],
                          1).astype(np.float32)


def voxelize_frames(clouds, pc_range, max_voxels):
    """Each cloud through the port's voxelizer at the test processor's 20
    points a voxel, padded to its fixed block: numpy (voxels, coordinates
    [b, z, y, x], points) of all frames."""
    from boxer_tpu_torch.dataset.processor.voxelizer import (pad_voxels,
                                                             points_to_voxel)

    parts = [pad_voxels(*points_to_voxel(c, VOXEL_3D, pc_range,
                                         max_points=POINTS_3D,
                                         max_voxels=max_voxels), b,
                        max_voxels) for b, c in enumerate(clouds)]
    return tuple(np.concatenate(x) for x in zip(*parts))


def targets_3d(batch, seed, nt=20):
    """A microbatch (A=1) of `batch` frames of nt normalized boxes (cx, cy,
    cz, l, w, h, angle), 2 classes."""
    rs = np.random.RandomState(seed)
    boxes = np.concatenate([rs.uniform(0.15, 0.85, (batch, nt, 2)),
                            rs.uniform(0.3, 0.6, (batch, nt, 1)),
                            rs.uniform(0.01, 0.05, (batch, nt, 2)),
                            rs.uniform(0.1, 0.3, (batch, nt, 1)),
                            rs.rand(batch, nt, 1)], -1).astype(np.float32)
    return {"labels": rs.randint(0, 2, (1, batch, nt)).astype(np.int32),
            "boxes": boxes[None], "valid": np.ones((1, batch, nt), bool)}


def voxel_batch_3d(arrays, targets, grid, batch, dev):
    """The train step's voxel batch (A=1) on `dev`."""
    put = lambda x: torch.from_numpy(x).to(dev)
    vox, coords, npts = arrays
    return {"voxels": put(vox[None]), "coordinates": put(coords[None]),
            "num_points_per_voxel": put(npts[None]), "grid_shape": grid,
            "batch_size": batch,
            "targets": {k: put(v) for k, v in targets.items()}}


def train_setup_3d(model, compute_dtype, debug_grads=False):
    """The Waymo recipe's criterion, AdamW (lr 1e-3, weight decay 1e-4, eps
    1e-9, the sampling offsets at 0.1 of the lr), a constant lr and the
    train step (clip 1.0) around `model`."""
    from boxer_tpu_torch.criterion.losses import Boxer3DCriterion
    from boxer_tpu_torch.nn.matcher import HungarianMatcher3d
    from boxer_tpu_torch.optim import build_optimizer, build_schedule
    from boxer_tpu_torch.parallel.steps import TrainState, make_train_step

    criterion = Boxer3DCriterion(BENCH_3D["num_classes"],
                                 HungarianMatcher3d(2, 5, 2, 4),
                                 TRAIN_WEIGHTS_3D, ["boxes", "focal_labels"])
    state = TrainState(model, build_optimizer(OPTIM_3D, model),
                       build_schedule(SCHEDULE, base_lr=1e-3))
    return criterion, state, make_train_step(
        criterion, max_norm=1.0, compute_dtype=compute_dtype,
        debug_grads=debug_grads)


def train_batch_3d(dev, seed=0):
    """Phase 9c's batch: 2 frames of 32,000 voxels at 468x468, 20 targets
    each."""
    grid = grid_3d(PC_RANGE_3D)
    return voxel_batch_3d(
        random_voxels_3d(grid, VOXELS_3D, TRAIN_BATCH_3D, seed),
        targets_3d(TRAIN_BATCH_3D, seed), grid, TRAIN_BATCH_3D, dev)


def run_3d_inference(dev, smi):
    """Phase 9: BoxeR-3D inference at full width in bf16, batch 1, 32,000
    voxels: a warm-up, then ITERS_3D forwards each on the host clock up to a
    synchronize with the launch counters zeroed just before them (K9 = 4,
    K3 = 2, K10 = 1 a forward, no K2), one profiled forward; then one
    served frame, points -> voxelizer -> pad_voxels -> model -> top-125,
    timed by stage.
    Returns (frames/s, counts, result dict)."""
    from boxer_tpu_torch.dataset.waymo import format_for_evalai

    grid = grid_3d(PC_RANGE_3D)
    model = build_model_3d(PC_RANGE_3D).to(dev, torch.bfloat16)
    vox, coords, npts = random_voxels_3d(grid, VOXELS_3D, 1, seed=0)
    # the points stay f32, as the loader hands them (K10 takes f32 alone)
    args = (torch.from_numpy(vox).to(dev), torch.from_numpy(coords).to(dev),
            torch.from_numpy(npts).to(dev), grid, 1)
    with torch.no_grad():
        model(*args)
        torch.cuda.synchronize()
        times, counts, out = timed(lambda: model(*args), ITERS_3D, dev)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    ms = float(np.median(times))
    label = f"BoxeR-3D {grid[0]}x{grid[1]} {VOXELS_3D} voxels bf16 [{smi}]"
    log(f"{label}: {1e3 / ms:.3f} frames/s (median {ms:.2f} ms of {ITERS_3D} "
        f"forwards: {', '.join(f'{t:.2f}' for t in times)}; peak "
        f"{peak:.2f} GiB), launches {counts}")
    want = {"pred_logits": (1, 300, 2), "pred_boxes": (1, 300, 7)}
    for key, shape in want.items():
        if tuple(out[key].shape) != shape or not torch.isfinite(
                out[key].float()).all():
            raise AssertionError(f"{label}: {key} {tuple(out[key].shape)}, "
                                 f"finite {torch.isfinite(out[key]).all()}")
    expect = {k: v * ITERS_3D for k, v in INFER_3D_LAUNCHES.items()}
    if counts != expect:
        raise AssertionError(f"{label}: launches {counts} != {expect}")
    with torch.no_grad():
        busy = profile(lambda: model(*args), ms, "BoxeR-3D forward")

    # one served frame, each stage up to a synchronize, at the voxelizer's
    # own grid (its last column lies past mfu_bench's 468)
    from boxer_tpu_torch.dataset.processor.voxelizer import (pad_voxels,
                                                             points_to_voxel)
    from boxer_tpu_torch.dataset.waymo import grid_shape

    serve_grid = grid_shape(PC_RANGE_3D, VOXEL_3D)
    cloud = lidar_cloud(PC_RANGE_3D, SERVE_POINTS, seed=3)
    occupied = []
    hook = model.backbone.extractor.register_forward_hook(
        lambda mod, a, canvas: occupied.append(
            int((canvas != 0).any(-1).sum())))
    for run in range(2):                     # the first warms the shapes
        stage = {}
        t0 = time.perf_counter()
        v, c, n = points_to_voxel(cloud, VOXEL_3D, PC_RANGE_3D,
                                  max_points=POINTS_3D,
                                  max_voxels=SERVE_VOXELS)
        live = len(v)
        v, c, n = pad_voxels(v, c, n, 0, SERVE_VOXELS)
        t1 = time.perf_counter()
        dev_args = (torch.from_numpy(v).to(dev), torch.from_numpy(c).to(dev),
                    torch.from_numpy(n).to(dev))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with torch.no_grad():
            o = model(*dev_args, serve_grid, 1)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            top = format_for_evalai(o["pred_logits"], o["pred_boxes"],
                                    PC_RANGE_3D, topk=125)
            torch.cuda.synchronize()
        t4 = time.perf_counter()
        stage = {"voxelize + pad (host)": t1 - t0, "to device": t2 - t1,
                 "model": t3 - t2, "top-125": t4 - t3}
    hook.remove()
    # every kept pillar on a cell of its own, the grid's last row and
    # column among them: a pillar folded into another row would overwrite
    # a live one or leave the count short
    kept = c[c[:, 0] >= 0]
    edges = (int(kept[:, 3].max()) == serve_grid[0] - 1
             and int(kept[:, 2].max()) == serve_grid[1] - 1)
    boxes = top["pred_boxes3d"].float()
    lo = torch.tensor(PC_RANGE_3D[:3], device=dev)
    hi = torch.tensor(PC_RANGE_3D[3:], device=dev)
    inside = bool(((boxes[..., :3] >= lo) & (boxes[..., :3] <= hi)).all())
    finite = all(bool(torch.isfinite(t.float()).all()) for t in top.values())
    log(f"BoxeR-3D served frame at {serve_grid[0]}x{serve_grid[1]} [{smi}]: "
        f"{SERVE_POINTS} points -> {live} voxels (of {SERVE_VOXELS}; "
        f"{occupied[-1]} canvas cells hit, the last row and column among "
        f"them {edges}) -> top-125 in "
        f"{1e3 * sum(stage.values()):.2f} ms: " + ", ".join(
            f"{k} {1e3 * t:.2f} ms" for k, t in stage.items())
        + f"; finite {finite}, centres inside pc_range {inside}")
    if occupied[-1] != live or not edges:
        raise AssertionError("BoxeR-3D served frame: the canvas lost pillars")
    if not (finite and inside and top["pred_scores"].shape == (1, 125)):
        raise AssertionError("BoxeR-3D served frame: bad top-125")
    del model
    torch.cuda.empty_cache()
    return 1e3 / ms, counts, dict(ms=ms, times=times, peak=peak, busy=busy,
                                  serve_ms={k: 1e3 * t for k, t in
                                            stage.items()})


def sampling_spread(model, args):
    """How far the perturbed heads move the sampling of the encoder's and
    the decoder's first Box3dAttention in one forward of `model` (CPU):
    the largest move of a sampling point, in pixels of level 0, against
    the same module with a zero `linear_box_weight`, and the decoder's
    largest |dθ| in radians."""
    from boxer_tpu_torch.nn.attention import _offsets

    mods = {"encoder": model.transformer.encoder.layers[0].self_attn,
            "decoder": model.transformer.decoder.layers[0].multihead_attn}
    seen = {}
    hooks = [m.register_forward_pre_hook(
        lambda mod, a, k=k: seen.__setitem__(k, (a[0], a[2], a[5])))
        for k, m in mods.items()]
    with torch.no_grad():
        model(*args)
    for h in hooks:
        h.remove()
    px = {}
    with torch.no_grad():
        for k, m in mods.items():
            q, shapes, ref = seen[k]
            gx, gy = m._where_to_attend(q, None, ref)
            saved = m.linear_box_weight.clone()
            m.linear_box_weight.zero_()
            gx0, gy0 = m._where_to_attend(q, None, ref)
            m.linear_box_weight.copy_(saved)
            (hl, wl) = shapes[0]
            px[k] = float(torch.maximum((gx - gx0)[:, :, 0].abs() * wl,
                                        (gy - gy0)[:, :, 0].abs() * hl).max())
        dtheta = float((_offsets(mods["decoder"], seen["decoder"][0])[
            :, :, :, 4] / 16 * 2 * np.pi).abs().max())
    return px, dtheta


def card_vs_cpu_3d(dev):
    """Phase 9b: one served frame at a 128x128 grid in f32 through the
    perturbed model, card (kernels) against CPU (plain versions): identical
    top-125 labels, scores and metric boxes within atol 1e-3."""
    from boxer_tpu_torch.dataset.waymo import format_for_evalai, grid_shape

    grid = grid_shape(E2E_PC_3D, VOXEL_3D)
    model = build_model_3d(E2E_PC_3D, seed=1, noise_seed=2)
    arrays = voxelize_frames([lidar_cloud(E2E_PC_3D, 40000, seed=4)],
                             E2E_PC_3D, E2E_VOXELS_3D)
    args = [torch.from_numpy(a) for a in arrays] + [grid, 1]
    px, dtheta = sampling_spread(model, args)

    def top(device):
        m = model.to(device)
        with torch.no_grad():
            o = m(*(a.to(device) if torch.is_tensor(a) else a for a in args))
            return {k: v.cpu() for k, v in format_for_evalai(
                o["pred_logits"], o["pred_boxes"], E2E_PC_3D).items()}

    want = top(torch.device("cpu"))
    before = {k: f.launches for k, f in counters().items()}
    got = top(dev)
    torch.cuda.synchronize()
    after = {k: f.launches - before[k] for k, f in counters().items()}
    label_eq = bool((got["pred_labels"] == want["pred_labels"]).all())
    score_err = float((got["pred_scores"] - want["pred_scores"]).abs().max())
    box_err = float((got["pred_boxes3d"] - want["pred_boxes3d"]).abs().max())
    log(f"BoxeR-3D card vs CPU at {grid[0]}x{grid[1]} f32 (launches "
        f"{after}): top-125 labels equal {label_eq}, score max abs err "
        f"{score_err:.3e}, box max abs err {box_err:.3e} m; the perturbed "
        f"heads move sampling points up to {px['encoder']:.2f} px "
        f"(encoder) and {px['decoder']:.2f} px (decoder) of level 0, dθ up "
        f"to {dtheta:.3f} rad")
    if after != INFER_3D_LAUNCHES:
        raise AssertionError(f"BoxeR-3D card run: launches {after}")
    if min(px.values()) <= 1.0 or dtheta <= 0.3:
        raise AssertionError("the perturbed heads barely move the sampling")
    if not (label_eq and score_err <= 1e-3 and box_err <= 1e-3):
        raise AssertionError("BoxeR-3D: card and CPU disagree")
    return dict(score_err=score_err, box_err=box_err, px=px, dtheta=dtheta)


def check_grads_3d(grads, label):
    """Every gradient finite; every Box3dAttention's value_proj, linear_box
    (its dθ rows too, in the decoder) and linear_attn gradient not all
    zero."""
    bad = [n for n, g in grads.items()
           if g is None or not bool(torch.isfinite(g).all())]
    if bad:
        raise AssertionError(f"{label}: missing or non-finite grads {bad}")
    watched = {n: g for n, g in grads.items()
               if n.endswith(("value_proj.weight", "linear_box_weight",
                              "linear_attn_weight"))}
    zero = [n for n, g in watched.items() if not bool(g.abs().max() > 0)]
    for n, g in watched.items():
        if n.endswith("linear_box_weight") and g.shape[0] % 5 == 0 and \
                "decoder" in n:
            # rows (head, level, variable): the 5th variable is dθ
            if not bool(g.reshape(-1, 5, g.shape[-1])[:, 4].abs().max() > 0):
                zero.append(n + " (dθ rows)")
    n_layers = BENCH_3D["enc_layers"] + BENCH_3D["dec_layers"]
    if zero or len(watched) != 3 * n_layers:
        raise AssertionError(f"{label}: zero grads in {zero} "
                             f"({len(watched)} watched)")


def run_train_3d(dev, smi):
    """Phase 9c: the BoxeR-3D train step at full width, batch 2 (two frames
    of 32,000 voxels, 20 targets each), f32 parameters, bf16 autocast: a
    checked warm-up step, TRAIN_STEPS timed ones with the counters zeroed
    just before them (K2 = 8, K5 = 8, K3 = 2 a step), one profiled step.
    Returns (median ms/step, peak GiB, counts, result dict)."""
    from boxer_tpu_torch.parallel.steps import make_train_step

    model = build_model_3d(PC_RANGE_3D).to(dev).train()
    criterion, state, step = train_setup_3d(model, torch.bfloat16)
    debug_step = make_train_step(criterion, max_norm=1.0,
                                 compute_dtype=torch.bfloat16,
                                 debug_grads=True)
    batch = train_batch_3d(dev)
    label = (f"BoxeR-3D train 468x468 batch {TRAIN_BATCH_3D} bf16 autocast "
             f"[{smi}]")
    terms = ["total_loss", "loss_ce", "loss_bbox", "loss_giou", "loss_rad",
             "loss_ce_enc_0", "loss_rad_enc_0", "grad_norm"]
    state, first = debug_step(state, batch)
    torch.cuda.synchronize()
    check_grads_3d(first.pop("_grads"), label)
    all_stats = [first]
    times, counts, _ = timed(
        lambda: all_stats.append(step(state, batch)[1]), TRAIN_STEPS, dev)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    ms = float(np.median(times))
    log(f"{label}: {ms:.2f} ms/step median of {TRAIN_STEPS} steps "
        f"({', '.join(f'{t:.2f}' for t in times)}); peak {peak:.2f} GiB; "
        f"launches per step "
        f"{({k: v / TRAIN_STEPS for k, v in counts.items()})}")
    for name, st in (("first", all_stats[0]), ("last", all_stats[-1])):
        log(f"  {name} step: " + ", ".join(f"{k} {st[k]:.5g}" for k in terms))
    for i, st in enumerate(all_stats):
        if st["skipped"] != 0.0 or not all(np.isfinite(v)
                                           for v in st.values()):
            raise AssertionError(f"{label}: step {i} skipped or not finite: "
                                 f"{st}")
    expect = {k: v * TRAIN_STEPS for k, v in TRAIN_3D_LAUNCHES.items()}
    if counts != expect or state.step != TRAIN_STEPS + 1:
        raise AssertionError(f"{label}: launches {counts} != {expect}, "
                             f"step {state.step}")
    busy = profile(lambda: step(state, batch), ms, "BoxeR-3D train step")
    del model, state, step, debug_step
    torch.cuda.empty_cache()
    return ms, peak, counts, dict(times=times, busy=busy,
                                  k5_ms=k5_call_ms(busy[2]),
                                  first={k: all_stats[0][k] for k in terms},
                                  last={k: all_stats[-1][k] for k in terms})


def train_card_vs_cpu_3d(dev):
    """Phase 9d: one f32 BoxeR-3D train step at the 128x128 grid with phase
    9b's weights, on 2 served frames with 20 targets each: CPU (plain
    versions), card (kernels), and card with the fused K5 swapped for its
    plain version (the same forward). Identical matches are asked of
    frames whose CPU matches clear every tie by more than 1e-4 of cost
    (`RecordingMatcher`); nearer, the devices' rounding may pick either
    query, as it does on frames 5 and 6 of this cloud."""
    from boxer_tpu_torch.dataset.waymo import grid_shape
    ba = importlib.import_module("boxer_tpu_torch.ops.box_attention")
    from boxer_tpu_torch.ops import scatter_accum as sa

    grid = grid_shape(E2E_PC_3D, VOXEL_3D)
    model = build_model_3d(E2E_PC_3D, seed=1, noise_seed=2).train()
    arrays = voxelize_frames([lidar_cloud(E2E_PC_3D, 40000, seed=s)
                              for s in (8, 9)], E2E_PC_3D, E2E_VOXELS_3D)
    targets = targets_3d(2, seed=7)

    def run(device):
        return recorded_step(
            model, device,
            lambda m: train_setup_3d(m, torch.float32, debug_grads=True),
            voxel_batch_3d(arrays, targets, grid, 2, device))

    want, want_qi, cpu_launches = run(torch.device("cpu"))
    if want["match_margin"] <= 1e-4:
        raise AssertionError(f"phase 9d's frames match within "
                             f"{want['match_margin']:.3e} of a tie")
    got, got_qi, launches = run(dev)
    kernel = ba.scatter_add_rows_weighted_dw4
    ba.scatter_add_rows_weighted_dw4 = sa.scatter_accum_dw4_plain
    try:
        plain, _, plain_launches = run(dev)
    finally:
        ba.scatter_add_rows_weighted_dw4 = kernel
    if any(cpu_launches.values()) or launches != TRAIN_3D_LAUNCHES or \
            plain_launches["K5"]:
        raise AssertionError(f"launches: CPU {cpu_launches}, card "
                             f"{launches}, card with plain K5 "
                             f"{plain_launches}")
    same_match = len(got_qi) == len(want_qi) == 2 and all(
        torch.equal(g, w) for g, w in zip(got_qi, want_qi))
    keys = [k for k in want if k.startswith("loss_")] + ["total_loss"]
    loss_err = max(rel_err(got[k], want[k]) for k in keys)
    norm_err = rel_err(got["grad_norm"], want["grad_norm"])
    cpu_err, cpu_leaf, _ = leaf_errs(got, want)
    k5_err, k5_leaf, _ = leaf_errs(got, plain)
    log(f"BoxeR-3D train step at {grid[0]}x{grid[1]} f32: card vs CPU "
        f"{len(got_qi)} matches (the encoder's binary one, then the decoder "
        f"layers'; CPU margin {want['match_margin']:.3e}) identical "
        f"{same_match}, loss terms ({len(keys)}) worst rel "
        f"err {loss_err:.3e}, grad norm {norm_err:.3e}, pre-clip grads worst "
        f"leaf {cpu_err:.3e} ({cpu_leaf}); card K5 (d_table and d_w4) vs its "
        f"plain version in the same step: worst leaf {k5_err:.3e} "
        f"({k5_leaf})")
    # the leaves at 0.1, as phase 8 says why; K5 at 1e-4 in the same forward
    if not (same_match and loss_err <= 1e-4 and norm_err <= 1e-3
            and cpu_err <= 0.1 and k5_err <= 1e-4):
        raise AssertionError("BoxeR-3D train step: card and CPU disagree")
    return dict(loss_err=loss_err, norm_err=norm_err, grad_err=cpu_err,
                k5_err=k5_err)


def write_coco(root, seed=0):
    """A COCO directory under root: COCO_IMAGES train and as many val
    JPEGs at COCO_HW, 2-3 polygon annotations each (a pentagon in a random
    box, one of COCO's 80 ids); test.json lists the val images alone."""
    from PIL import Image

    rs = np.random.RandomState(seed)
    h, w = COCO_HW
    cats = [{"id": i, "name": f"c{i}"} for i in COCO_IDS]
    os.makedirs(root / "images")
    for split, first in (("train", 1), ("val", 1 + COCO_IMAGES)):
        images, anns = [], []
        for img_id in range(first, first + COCO_IMAGES):
            Image.fromarray((rs.rand(h, w, 3) * 255).astype(np.uint8)).save(
                root / "images" / f"{img_id}.jpg")
            images.append({"id": img_id, "height": h, "width": w,
                           "file_name": f"{img_id}.jpg"})
            for _ in range(rs.randint(2, 4)):
                bw, bh = rs.randint(w // 8, w // 2), rs.randint(h // 8, h // 2)
                x, y = rs.randint(0, w - bw), rs.randint(0, h - bh)
                poly = [x, y, x + bw, y, x + bw, y + bh, x + bw / 2,
                        y + 0.6 * bh, x, y + bh]
                anns.append({"id": 1000 * img_id + len(anns),
                             "image_id": img_id,
                             "category_id": int(rs.choice(COCO_IDS)),
                             "bbox": [float(v) for v in (x, y, bw, bh)],
                             "area": float(bw * bh), "iscrowd": 0,
                             "segmentation": [[float(v) for v in poly]]})
        with open(root / f"{split}.json", "w") as f:
            json.dump({"images": images, "annotations": anns,
                       "categories": cats}, f)
        if split == "val":
            with open(root / "test.json", "w") as f:
                json.dump({"images": images, "categories": cats}, f)


def trainer_on_card(root, opts):
    """The port's trainer on the card from the shipped segm config, the
    synthetic COCO under root and the dotlist `opts`, loaded."""
    from boxer_tpu_torch.trainer import build_trainer
    from boxer_tpu_torch.utils.config import Configuration

    data = [f"dataset_config.detection.imdb_files.{split}.{key}="
            f"{root}/{name}"
            for split in ("train", "val", "test")
            for key, name in (("anno_file", f"{split}.json"),
                              ("image_folder", "images"))]
    configuration = Configuration(
        str(ROOT / TRAINER_CONFIG),
        opts=data + [f"training.save_dir={root}/save"] + opts,
        extra={"task": "detection", "model": "boxer2d"}, device="cuda")
    trainer = build_trainer(configuration, device="cuda")
    trainer.load()
    return trainer


def tree_map(batch, fn):
    return {k: tree_map(v, fn) if isinstance(v, dict)
            else fn(v) if isinstance(v, torch.Tensor) else v
            for k, v in batch.items()}


def record_steps(trainer, log_update, syncs=None):
    """Wrap the trainer's train, eval and inference steps: each train step
    is timed up to a synchronize and its launches, stats, group LRs (with
    the schedule's value at the step it took), the host's wait since the
    previous step returned and, given the `matcher_syncs` tally, the
    matcher's host syncs are recorded; the first batch is kept, on the
    card and copied to the host; the eval and inference steps' launches
    and images (frames) are summed."""
    from boxer_tpu_torch.optim import build_schedule

    rec = {"updates": [], "eval": {}, "first": None,
           "step": trainer._train_step}
    sched = trainer.config.scheduler.to_dict()
    sched["params"]["_steps_per_epoch"] = len(trainer.loaders["train"])
    schedule = build_schedule(sched, trainer.config.optimizer.params.lr)
    launched = lambda: {k: f.launches for k, f in counters().items()}
    train_step = rec["step"]

    def step(state, batch, **kw):
        t0 = time.perf_counter()
        wait = (t0 - rec["end"]) * 1e3 if "end" in rec else None
        if rec["first"] is None:
            rec["first"] = (tree_map(batch, torch.clone),
                            tree_map(batch, lambda t: t.cpu()))
        before, step_before = launched(), state.step
        synced = syncs["syncs"] if syncs else 0
        t0 = time.perf_counter()
        state, stats = train_step(state, batch, **kw)
        torch.cuda.synchronize()
        rec["end"] = time.perf_counter()
        ms = (rec["end"] - t0) * 1e3
        after = launched()
        lrs = {g["name"]: (g["lr"], g["base_lr"] * schedule(step_before))
               for g in state.optimizer.param_groups}
        rec["updates"].append(dict(ms=ms, stats=stats, lrs=lrs, launches={
            k: after[k] - before[k] for k in after}, wait_ms=wait,
            syncs=(syncs["syncs"] - synced) if syncs else None))
        log_update(len(rec["updates"]), rec["updates"][-1])
        return state, stats

    def counted(name, fn):
        def run(state, batch):
            before = launched()
            out = fn(state, batch)
            torch.cuda.synchronize()
            tally = rec["eval"].setdefault(name, {"images": 0, "steps": 0,
                                                  "launches": {
                                                      k: 0 for k in before}})
            tally["steps"] += 1
            tally["images"] += (batch["batch_size"] if "voxels" in batch
                                else batch["image"].shape[0])
            for k, v in launched().items():
                tally["launches"][k] += v - before[k]
            return out
        return run

    trainer._train_step = step
    trainer._eval_step = counted("val", trainer._eval_step)
    trainer._inference_step = counted("test", trainer._inference_step)
    return rec


def run_trainer(dev, smi):
    """Phase 10: the shipped segm config through the port's trainer on the
    card at full width (R50, hidden 256, 8x32 heads, 6+6 layers, 300
    queries, bf16 autocast, the config's 1344x1344 canvas and processors,
    its step schedule on the epoch clock), on a synthetic COCO directory,
    with only the schedule's length cut (TRAINER_CUTS): 4 updates of two
    microbatches of one image, val (bbox and segm AP) and test
    (test_result.json), checkpoints at updates 2 and 4; then a resumed
    trainer takes updates 5 and 6. Returns (launch counts of the main
    path, results)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_coco(root)
        cuts = TRAINER_CUTS + ["training.num_checkpoint=2"]
        log(f"trainer [{smi}]: {TRAINER_CONFIG} with {' '.join(cuts)}")
        t_load = time.perf_counter()
        trainer = trainer_on_card(root, cuts)
        t_load = time.perf_counter() - t_load
        label = "trainer, segm R50 1344x1344 bf16 autocast"

        def log_update(i, u):
            log(f"  update {i}: {u['ms']:.2f} ms, total_loss "
                f"{u['stats']['total_loss']:.5g}, grad_norm "
                f"{u['stats']['grad_norm']:.5g}, accuracy "
                f"{u['stats']['accuracy']:.4g}, skipped "
                f"{u['stats']['skipped']:g}, matcher syncs {u['syncs']}, "
                f"launches {u['launches']}")

        evals = {}
        evaluate = trainer.evaluate
        trainer.evaluate = lambda split: evals.setdefault(split,
                                                          evaluate(split))
        with matcher_syncs() as syncs:
            rec = record_steps(trainer, log_update, syncs)
            torch.cuda.reset_peak_memory_stats(dev)
            for f in counters().values():
                f.launches = 0
            t0 = time.perf_counter()
            trainer.train()
            torch.cuda.synchronize()
            t_train = time.perf_counter() - t0
            counts = {k: f.launches for k, f in counters().items()}
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30

        updates = rec["updates"]
        times = [u["ms"] for u in updates]
        per_update = {k: 2 * v for k, v in TRAIN_LAUNCHES[True].items()}
        for i, u in enumerate(updates):
            st = u["stats"]
            if st["skipped"] != 0.0 or not all(np.isfinite(v)
                                               for v in st.values()):
                raise AssertionError(f"{label}: update {i + 1}: {st}")
            if any(lr != want for lr, want in u["lrs"].values()):
                raise AssertionError(f"{label}: update {i + 1}: group LRs "
                                     f"{u['lrs']} off the step schedule")
            if u["launches"] != per_update or u["syncs"] != 0:
                raise AssertionError(f"{label}: update {i + 1} launched "
                                     f"{u['launches']} != {per_update}, "
                                     f"matcher syncs {u['syncs']}")
        if len(updates) != 4 or trainer.state.step != 4:
            raise AssertionError(f"{label}: {len(updates)} updates, step "
                                 f"{trainer.state.step}")

        # the loader's copy: its first batch on the card against the same
        # loader's first batch built on the host
        from boxer_tpu_torch.dataset import build_dataloader

        host_loader = build_dataloader(
            trainer.datasets["train"], "train", batch_size=2,
            iter_per_update=2, seed=trainer.seed, device="cpu")
        host_loader.sampler.set_epoch(0)
        host = next(iter(host_loader))
        copied = rec["first"][1]
        flat = lambda b: {**{k: v for k, v in b.items() if k not in (
            "targets", "meta")}, **b["targets"]}
        copy_ok = sorted(flat(copied)) == sorted(flat(host)) and all(
            torch.equal(flat(copied)[k], v) for k, v in flat(host).items())
        if not copy_ok:
            raise AssertionError(f"{label}: the loader's first batch on the "
                                 "card differs from its host build")

        ap = {k: [float(x) for x in v] for k, v in evals["val"].items()}
        if sorted(ap) != ["coco_eval_bbox", "coco_eval_segm"] or not all(
                0.0 <= v[0] <= 1.0 for v in ap.values()):
            raise AssertionError(f"{label}: val stats {ap}")
        save = root / "save"
        with open(save / "test_result.json") as f:
            records = json.load(f)
        test_ids = {r["image_id"] for r in records}
        want_ids = set(range(1 + COCO_IMAGES, 1 + 2 * COCO_IMAGES))
        files = ["config.yaml", "checkpoints/model_2.pth",
                 "checkpoints/model_4.pth", "model_final"]
        missing = [f for f in files if not (save / f).exists()]
        if test_ids != want_ids or missing or not all(
                "segmentation" in r for r in records):
            raise AssertionError(f"{label}: test records of {test_ids}, "
                                 f"missing files {missing}")
        per_image = {split: {k: v / e["images"] for k, v in
                             e["launches"].items()}
                     for split, e in rec["eval"].items()}
        # K4: one launch a test step (the inference forward's last decoder
        # layer, both images of the batch); one a decoder layer a val step,
        # whose forward (inference=False) runs the decoder's training
        # topology, every layer's instance attention with train=True under
        # no_grad
        k4 = {split: e["launches"]["K4"] for split, e in rec["eval"].items()}
        layers = len(trainer.state.model.transformer.decoder.layers)
        want_k4 = {"val": layers * rec["eval"]["val"]["steps"],
                   "test": rec["eval"]["test"]["steps"]}
        if k4 != want_k4:
            raise AssertionError(f"{label}: K4 launches {k4} != {want_k4} "
                                 f"({layers} decoder layers)")
        log(f"{label} [{smi}]: load {t_load:.1f} s, train() {t_train:.1f} s "
            f"(4 updates, val and test); ms per update "
            f"{', '.join(f'{t:.2f}' for t in times)}; peak "
            f"{peak:.2f} GiB; launches per update {updates[-1]['launches']};"
            f" per eval image {per_image} (K4 {k4} in "
            f"{rec['eval']['val']['steps']} val and "
            f"{rec['eval']['test']['steps']} test steps); val AP bbox "
            f"{ap['coco_eval_bbox'][0]:.4g}, segm "
            f"{ap['coco_eval_segm'][0]:.4g}; {len(records)} test records of "
            f"{len(test_ids)} images; the loader's first batch on the card "
            f"equals its host build {copy_ok}")
        del trainer
        torch.cuda.empty_cache()

        # resume: update 4's checkpoint, at the end of the first epoch
        saved = torch.load(save / "checkpoints/model_4.pth",
                           map_location="cpu", weights_only=True)
        resumed = trainer_on_card(root, TRAINER_CUTS[:-2] + [
            "training.max_update=6", "training.run_type=train",
            "training.resume=true"])
        model_ok = all(torch.equal(v.cpu(), saved["model"][k]) for k, v in
                       resumed.state.model.state_dict().items())
        opt = resumed.state.optimizer.state_dict()
        opt_ok = all(torch.equal(v.cpu(), saved["optimizer"]["state"][i][k])
                     for i, s in opt["state"].items() for k, v in s.items())
        position = (resumed.current_update, resumed.current_epoch,
                    resumed.epoch_batches_done)
        log(f"  resumed from update 4: model bitwise {model_ok}, optimizer "
            f"state bitwise {opt_ok} ({len(opt['state'])} tensors' state), "
            f"(update, epoch, skip) {position}")
        if not (model_ok and opt_ok and len(opt["state"]) > 0
                and position == (4, 1, 0)):
            raise AssertionError(f"{label}: resume restored {position}")
        with matcher_syncs() as syncs2:
            rec2 = record_steps(resumed, lambda i, u: log_update(4 + i, u),
                                syncs2)
            resumed.train()
        more = rec2["updates"]
        if resumed.state.step != 6 or len(more) != 2 or not all(
                np.isfinite(u["stats"]["total_loss"])
                and u["stats"]["skipped"] == 0.0 and u["syncs"] == 0
                for u in more):
            raise AssertionError(f"{label}: after the resume "
                                 f"{[(u['stats'], u['syncs']) for u in more]}")
        # the first update (the warm-up) left out
        times = times[1:] + [u["ms"] for u in more]
        median = float(np.median(times))
        sync_counts = [u["syncs"] for u in updates + more]
        log(f"{label} [{smi}]: {median:.2f} ms per update, the median of "
            f"updates 2-6 (min {min(times):.2f}, max {max(times):.2f}); "
            f"matcher syncs per update {sync_counts} in "
            f"{syncs['calls'] + syncs2['calls']} calls")
        batch, step = rec["first"][0], rec2["step"]
        busy = profile(lambda: step(resumed.state, batch), median,
                       f"{label}, one update")
        del resumed, rec, rec2, batch, step
        torch.cuda.empty_cache()
    return counts, dict(ms=median, times=times, peak=peak,
                        busy=busy, per_image=per_image, ap=ap,
                        train_s=t_train, syncs=sync_counts)


def waymo_trainer_on_card(root, opts):
    """The port's trainer on the card from the shipped Waymo config, the
    Waymo directory under root (val and test on its val frames, as the
    config has them; the train split's GT database) and the dotlist
    `opts`, loaded."""
    from boxer_tpu_torch.trainer import build_trainer
    from boxer_tpu_torch.utils.config import Configuration

    imdb = "dataset_config.detection3d.imdb_files"
    data = [f"{imdb}.{split}.{key}={value}"
            for split, info in (("train", "train"), ("val", "val"),
                                ("test", "val"))
            for key, value in (("root_path", root), (
                "info_path", f"{root}/infos/infos_{info}.pkl"))]
    data.append(f"{imdb}.train.db_sampler.db_info_path="
                f"{root}/infos/dbinfos_infos_train.pkl")
    configuration = Configuration(
        str(ROOT / TRAINER_3D_CONFIG),
        opts=data + [f"training.save_dir={root}/save"] + opts,
        extra={"task": "detection3d", "model": "boxer3d"}, device="cuda")
    trainer = build_trainer(configuration, device="cuda")
    trainer.load()
    return trainer


def draws_equal(a, b):
    """Two GT-database draw states ({class: (order, cursor)}) equal."""
    return sorted(a) == sorted(b) and all(
        torch.equal(o.cpu(), b[n][0].cpu()) and c == b[n][1]
        for n, (o, c) in a.items())


@contextlib.contextmanager
def matcher_syncs():
    """Count the matcher's host syncs: each bool(), int() or item() of a
    tensor while the port's `hungarian` runs (on the card the solve is one
    kernel launch, H1, and phases 10 and 11 fail on any). Yields {"syncs",
    "calls"}, which grow until the block ends."""
    from boxer_tpu_torch.nn import matcher

    tally, inside = {"syncs": 0, "calls": 0}, [False]
    solve = matcher.hungarian

    def counted(*args, **kw):
        tally["calls"] += 1
        inside[0] = True
        try:
            return solve(*args, **kw)
        finally:
            inside[0] = False

    def counting(name):
        base = getattr(torch.Tensor, name)

        def call(self, *args, **kw):
            if inside[0]:
                tally["syncs"] += 1
            return base(self, *args, **kw)
        return call

    names = ("__bool__", "__int__", "item")
    saved = {n: torch.Tensor.__dict__.get(n) for n in names}
    for n in names:
        setattr(torch.Tensor, n, counting(n))
    matcher.hungarian = counted
    try:
        yield tally
    finally:
        matcher.hungarian = solve
        for n, v in saved.items():
            if v is None:
                delattr(torch.Tensor, n)
            else:
                setattr(torch.Tensor, n, v)


def cost_matrix_peak(fn):
    """fn() with the 3D matcher's cost matrices measured: the most device
    memory a `cost_matrix` call held above what was allocated as it began
    (GiB), and the (B, NQ, NT) shape of each."""
    from boxer_tpu_torch.nn.matcher import HungarianMatcher3d

    cost = HungarianMatcher3d.cost_matrix
    peaks, shapes = [], []

    def measured(self, outputs, targets):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = cost(self, outputs, targets)
        torch.cuda.synchronize()
        peaks.append((torch.cuda.max_memory_allocated() - base) / 2 ** 30)
        shapes.append(tuple(out.shape))
        return out

    HungarianMatcher3d.cost_matrix = measured
    try:
        fn()
    finally:
        HungarianMatcher3d.cost_matrix = cost
    return max(peaks), shapes


def loader_stage_ms(ds, frames):
    """Host ms of a train frame's load by stage, one frame after another on
    this thread, over the first `frames` frames of the Waymo dataset ds:
    read (the lidar pkl), db sample (draw, collision test, object points),
    each processor by class; and the collate of two frames. The db
    sampler's cursors are restored after."""
    from boxer_tpu_torch.dataset import waymo

    stages = {}

    def timing(name, fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                stages[name] = (stages.get(name, 0.0)
                                + (time.perf_counter() - t0) * 1e3)
        return run

    read, sampler, procs = (waymo.read_points_with_sweeps, ds.db_sampler,
                            ds.processor.procs)
    state = ds.draw_state()
    waymo.read_points_with_sweeps = timing("read", read)
    sampler.draw = timing("db sample", sampler.draw)
    sampler.place = timing("db sample", sampler.place)
    ds.processor.procs = [timing(type(p).__name__, p) for p in procs]
    try:
        items = [ds.load(i, np.random.RandomState(i),
                         ds.draw(i, np.random.RandomState([i, 1])))
                 for i in range(frames)]
    finally:
        waymo.read_points_with_sweeps = read
        del sampler.draw, sampler.place
        ds.processor.procs = procs
        ds.set_draw_state(state)
    per_frame = {k: v / frames for k, v in stages.items()}
    t0 = time.perf_counter()
    ds.collate(items[:2])
    per_frame["collate (a batch of 2)"] = (time.perf_counter() - t0) * 1e3
    return per_frame


def run_trainer_3d(dev, smi):
    """Phase 11: the shipped Waymo config through the port's trainer on the
    card at full width (hidden 256, 8 heads, 2+2 layers, 300 queries, 5
    classes, the 469x469 grid, 32,000 train and 60,000 test voxels of 20
    points, 250 boxes, the config's processors, the GT-database sampler,
    the cosine schedule with warmup, AdamW with the offsets at 0.1 of the
    LR, bf16 autocast), on a generated Waymo directory and its GT
    database, with only TRAINER_3D_CUTS: 4 updates of a batch of 2 frames,
    val (the offline metrics) and test, both into results.pkl, checkpoints
    at updates 2 and 4; then a resumed trainer takes updates 5 and 6.
    Returns (launch counts of the main path, results)."""
    import pickle
    import tempfile

    from boxer_tpu_torch.dataset import build_dataloader
    from boxer_tpu_torch.dataset.synthetic import write_waymo
    from boxer_tpu_torch.evaluate.waymo_eval import evaluate_results
    from boxer_tpu_torch.tools.preprocess.create_gt_database import \
        create_gt_database

    label = "trainer 3D, BoxeR-3D 469x469 bf16 autocast"
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        write_waymo(root, WAYMO_FRAMES, PC_RANGE_3D, SERVE_POINTS,
                    WAYMO_OBJECTS, seed=0)
        _, db = create_gt_database(str(root), "infos/infos_train.pkl")
        log(f"{label} [{smi}]: Waymo directory of {WAYMO_FRAMES} frames of "
            f"{SERVE_POINTS} points and {WAYMO_OBJECTS} objects, its GT "
            f"database {({k: len(v) for k, v in db.items()})}, in "
            f"{time.perf_counter() - t0:.1f} s; {TRAINER_3D_CONFIG} with "
            f"{' '.join(TRAINER_3D_CUTS)}")
        t_load = time.perf_counter()
        trainer = waymo_trainer_on_card(root, TRAINER_3D_CUTS)
        t_load = time.perf_counter() - t_load
        ds = trainer.datasets["train"]
        start_state = ds.draw_state()
        placed, place = [], ds.db_sampler.place

        def counted_place(*args, **kw):
            out = place(*args, **kw)
            placed.append(0 if out is None else len(out["gt_boxes"]))
            return out

        def log_update(i, u):
            st = u["stats"]
            log(f"  update {i}: {u['ms']:.2f} ms (host wait before it "
                f"{u['wait_ms'] or 0:.2f} ms), total_loss "
                f"{st['total_loss']:.5g}, grad_norm {st['grad_norm']:.5g}, "
                f"num_boxes {st['num_boxes']:g}, skipped {st['skipped']:g}, "
                f"matcher syncs {u['syncs']}, launches {u['launches']}")

        evals, records, eval_s = {}, {}, {}
        evaluate = trainer.evaluate

        def evaluate_and_read(split):
            t0 = time.perf_counter()
            evals[split] = evaluate(split)
            eval_s[split] = time.perf_counter() - t0
            with open(root / "save" / "results.pkl", "rb") as f:
                records[split] = pickle.load(f)
            return evals[split]

        trainer.evaluate = evaluate_and_read
        ds.db_sampler.place = counted_place
        with matcher_syncs() as syncs:
            rec = record_steps(trainer, log_update, syncs)
            torch.cuda.reset_peak_memory_stats(dev)
            for f in counters().values():
                f.launches = 0
            t0 = time.perf_counter()
            trainer.train()
            torch.cuda.synchronize()
            t_train = time.perf_counter() - t0
            counts = {k: f.launches for k, f in counters().items()}
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        del ds.db_sampler.place
        with open(root / "save" / "results.pkl", "rb") as f:
            records["test"] = pickle.load(f)

        updates = rec["updates"]
        for i, u in enumerate(updates):
            st = u["stats"]
            if st["skipped"] != 0.0 or not all(np.isfinite(v)
                                               for v in st.values()):
                raise AssertionError(f"{label}: update {i + 1}: {st}")
            if any(lr != want for lr, want in u["lrs"].values()):
                raise AssertionError(f"{label}: update {i + 1}: group LRs "
                                     f"{u['lrs']} off the cosine schedule")
            if u["launches"] != TRAIN_3D_LAUNCHES:
                raise AssertionError(f"{label}: update {i + 1} launched "
                                     f"{u['launches']} != {TRAIN_3D_LAUNCHES}")
        if len(updates) != 4 or trainer.state.step != 4:
            raise AssertionError(f"{label}: {len(updates)} updates, step "
                                 f"{trainer.state.step}")
        if sum(placed) == 0:
            raise AssertionError(f"{label}: the db sampler placed no object "
                                 f"in {len(placed)} train frames")

        # the loader's copy: its first batch on the card against the same
        # loader's first batch built on the host, from the same draws
        host_loader = build_dataloader(ds, "train", batch_size=2,
                                       seed=trainer.seed, device="cpu")
        host_loader.sampler.set_epoch(0)
        host_loader.draw_state = start_state
        host = next(iter(host_loader))
        copied = rec["first"][1]
        arrays = lambda b: {**{k: v for k, v in b.items() if isinstance(
            v, torch.Tensor)}, **b["targets"]}
        copy_ok = (sorted(arrays(copied)) == sorted(arrays(host)) and all(
            torch.equal(arrays(copied)[k], v)
            for k, v in arrays(host).items()) and all(
            copied[k] == host[k] for k in ("grid_shape", "batch_size")))
        if not copy_ok:
            raise AssertionError(f"{label}: the loader's first batch on the "
                                 "card differs from its host build")

        # results.pkl after val and after test: a record per frame; the
        # val metrics are evaluate_results' of the val records
        tokens = {s: sorted(i["token"] for i in trainer.datasets[s].infos)
                  for s in ("val", "test")}
        metrics = evals["val"]
        want_metrics = evaluate_results(records["val"])
        if (any(sorted(records[s]) != tokens[s] for s in tokens)
                or len(tokens["val"]) != 4 or metrics != want_metrics
                or not metrics or not all(np.isfinite(v)
                                          for v in metrics.values())):
            raise AssertionError(f"{label}: val metrics {metrics} (want "
                                 f"{want_metrics}), records of "
                                 f"{ {s: sorted(r) for s, r in records.items()} }"
                                 f" for frames {tokens}")
        save = root / "save"
        files = ["config.yaml", "checkpoints/model_2.pth",
                 "checkpoints/model_4.pth", "model_final"]
        missing = [f for f in files if not (save / f).exists()]
        if missing:
            raise AssertionError(f"{label}: missing files {missing}")
        frames = rec["eval"]["test"]["images"]
        per_frame = {k: v / frames
                     for k, v in rec["eval"]["test"]["launches"].items()}
        want_frame = {k: v / TRAIN_BATCH_3D
                      for k, v in INFER_3D_LAUNCHES.items()}
        if frames != 8 or per_frame != want_frame:
            raise AssertionError(f"{label}: {frames} eval frames launched "
                                 f"{per_frame} a frame != {want_frame}")
        update_ms = ", ".join(f"{u['ms']:.2f}" for u in updates)
        log(f"{label} [{smi}]: load {t_load:.1f} s, train() {t_train:.1f} s "
            f"(4 updates, val {eval_s['val']:.1f} s with the metrics, test);"
            f" ms per update {update_ms};"
            f" peak {peak:.2f} GiB; launches per update "
            f"{updates[-1]['launches']}, per val or test frame {per_frame}; "
            f"db-sampled objects placed in the {len(placed)} train frames "
            f"{sum(placed)} ({placed}); valid targets per batch "
            f"{[int(u['stats']['num_boxes']) for u in updates]}; matcher "
            f"syncs per update {[u['syncs'] for u in updates]} in "
            f"{syncs['calls']} calls; val metrics {metrics}; results.pkl "
            f"records {len(records['val'])} val, {len(records['test'])} "
            f"test; the loader's first batch on the card equals its host "
            f"build {copy_ok}")
        saved_extra = torch.load(save / "checkpoints/model_4.pth",
                                 map_location="cpu",
                                 weights_only=True)["extra"]
        del trainer, host_loader
        torch.cuda.empty_cache()

        # resume: update 4's checkpoint, at the end of the first epoch
        saved = torch.load(save / "checkpoints/model_4.pth",
                           map_location="cpu", weights_only=True)
        resumed = waymo_trainer_on_card(root, [
            c for c in TRAINER_3D_CUTS if not c.startswith(
                ("training.max_update", "training.run_type"))] + [
            "training.max_update=6", "training.run_type=train",
            "training.resume=true"])
        model_ok = all(torch.equal(v.cpu(), saved["model"][k]) for k, v in
                       resumed.state.model.state_dict().items())
        opt = resumed.state.optimizer.state_dict()
        opt_ok = all(torch.equal(v.cpu(), saved["optimizer"]["state"][i][k])
                     for i, s in opt["state"].items() for k, v in s.items())
        draws = resumed.loaders["train"].draw_state
        draws_ok = draws_equal(draws, saved_extra["draw_states"][0])
        position = (resumed.current_update, resumed.current_epoch,
                    resumed.epoch_batches_done)
        log(f"  resumed from update 4: model bitwise {model_ok}, optimizer "
            f"state bitwise {opt_ok} ({len(opt['state'])} tensors' state), "
            f"the db sampler's cursors {draws_ok}, (update, epoch, skip) "
            f"{position}")
        if not (model_ok and opt_ok and draws_ok and len(opt["state"]) > 0
                and position == (4, 1, 0)):
            raise AssertionError(f"{label}: resume restored {position}")
        with matcher_syncs() as syncs2:
            rec2 = record_steps(resumed, lambda i, u: log_update(4 + i, u),
                                syncs2)
            resumed.train()
        more = rec2["updates"]
        if resumed.state.step != 6 or len(more) != 2 or not all(
                np.isfinite(u["stats"]["total_loss"])
                and u["stats"]["skipped"] == 0.0 for u in more):
            raise AssertionError(f"{label}: after the resume "
                                 f"{[u['stats'] for u in more]}")
        # the first update (the warm-up) left out
        kept = updates[1:] + more
        times = [u["ms"] for u in kept]
        median = float(np.median(times))
        waits = [u["wait_ms"] for u in kept if u["wait_ms"] is not None]
        sync_counts = [u["syncs"] for u in updates + more]
        if any(sync_counts):
            raise AssertionError(f"{label}: matcher host syncs per update "
                                 f"{sync_counts}")
        log(f"{label} [{smi}]: {median:.2f} ms per update, the median of "
            f"updates 2-6 (min {min(times):.2f}, max {max(times):.2f}); "
            f"host wait before a step, median {np.median(waits):.2f} ms of "
            f"{len(waits)}; matcher syncs per update {sync_counts} in "
            f"{syncs['calls'] + syncs2['calls']} calls")
        batch, step = rec["first"][0], rec2["step"]
        busy = profile(lambda: step(resumed.state, batch), median,
                       f"{label}, one update")
        k5_ms = k5_call_ms(busy[2])
        cost_peak, cost_shapes = cost_matrix_peak(
            lambda: step(resumed.state, batch))
        log(f"{label}: the matcher's cost matrices {cost_shapes}, the "
            f"largest {cost_peak:.2f} GiB above the memory at its start")
        stages = loader_stage_ms(resumed.datasets["train"], 4)
        log(f"{label} [{smi}]: the loader's host ms, one frame after "
            f"another: " + ", ".join(f"{k} {v:.2f}" for k, v in
                                      stages.items()) + " (per frame)")
        del resumed, rec, rec2, batch, step
        torch.cuda.empty_cache()
    return counts, dict(ms=median, times=times, peak=peak, busy=busy,
                        k5_ms=k5_ms, cost_peak=cost_peak,
                        syncs=sync_counts, waits=waits,
                        stages=stages, metrics=metrics, train_s=t_train,
                        val_s=eval_s["val"], placed=sum(placed))


def allreduce_timer():
    """Wrap torch.distributed.all_reduce: each call on more than a million
    elements (the step's flat gradient buffer) is timed on the host clock
    between two synchronizes. Returns (the list of (bytes, ms), restore)."""
    import torch.distributed as dist

    calls, all_reduce = [], dist.all_reduce

    def timed_all_reduce(tensor, *args, **kw):
        if tensor.numel() < 10 ** 6:
            return all_reduce(tensor, *args, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = all_reduce(tensor, *args, **kw)
        torch.cuda.synchronize()
        calls.append((tensor.numel() * tensor.element_size(),
                      (time.perf_counter() - t0) * 1e3))
        return out

    dist.all_reduce = timed_all_reduce
    return calls, lambda: setattr(dist, "all_reduce", all_reduce)


def dp_train(make, label, per_update, verbose):
    """Build a trainer with `make()`, train it with the launch counters
    zeroed just before and read just after, each update recorded (and
    logged if `verbose`). Returns (trainer, record, counts, (peak GiB,
    GiB allocated) after the first update, optimizer-state bytes this
    rank holds: its shard's under ZeRO-1)."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    def local_state_bytes(optimizer):
        if isinstance(optimizer, ZeroRedundancyOptimizer):
            optimizer = optimizer.optim
        return sum(v.numel() * v.element_size()
                   for st in optimizer.state.values() for v in st.values()
                   if torch.is_tensor(v))

    trainer = make()
    dev = trainer.device
    first = {}

    def log_update(i, u):
        if i == 1:
            first["peak"] = (torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                             torch.cuda.memory_allocated(dev) / 2 ** 30)
            first["state"] = local_state_bytes(trainer.state.optimizer)
        if verbose:
            st = u["stats"]
            log(f"  {label}, update {i}: {u['ms']:.2f} ms, "
                f"total_loss {st['total_loss']:.5g}, num_boxes "
                f"{st['num_boxes']:g}, grad_norm {st['grad_norm']:.5g}, "
                f"skipped {st['skipped']:g}, launches {u['launches']}")

    rec = record_steps(trainer, log_update)
    torch.cuda.reset_peak_memory_stats(dev)
    for f in counters().values():
        f.launches = 0
    trainer.train()
    torch.cuda.synchronize()
    counts = {k: f.launches for k, f in counters().items()}
    for i, u in enumerate(rec["updates"]):
        st = u["stats"]
        if st["skipped"] != 0.0 or not all(np.isfinite(v)
                                           for v in st.values()):
            raise AssertionError(f"{label}: update {i + 1}: {st}")
        if u["launches"] != per_update:
            raise AssertionError(f"{label}: update {i + 1} launched "
                                 f"{u['launches']} != {per_update}")
    return trainer, rec, counts, first["peak"], first["state"]


def dp_ranks(task_path):
    """Phases 12a, 12c and 12d in one of the two ranks that share the card
    over gloo (`run_data_parallel` launches them); writes what the parent
    checks to <out>/rank<r>.pt."""
    import pickle

    import torch.distributed as dist

    from boxer_tpu_torch.parallel.sharding import optimizer_state_dict

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    task = torch.load(task_path, weights_only=False)
    root, rank = Path(task["root"]), dist.get_rank()
    out = {}
    cpu = lambda t: {k: v.detach().cpu().clone() for k, v in t.items()}

    # 12a: one f32 update on this rank's image of the parent's batch
    trainer = trainer_on_card(root, DP_F32_CUTS + [
        f"training.save_dir={root}/dp2_f32"])
    out["init_equal"] = all(torch.equal(v.cpu(), task["weights"][k]) for k, v
                            in trainer.state.model.state_dict().items())
    batch = tree_map(task["batch"], lambda t: t[:, rank:rank + 1].to(
        trainer.device))
    _, out["f32_stats"] = trainer._train_step(trainer.state, batch)
    out["f32_params"] = cpu(dict(trainer.state.model.named_parameters()))
    del trainer, batch
    torch.cuda.empty_cache()

    # 12a: 2 updates from the loader at bf16 autocast with a ZeRO-1
    # checkpoint at update 2, the gradient all-reduce timed; 12c: its
    # optimizer state and peak
    calls, restore = allreduce_timer()
    trainer, rec, out["counts"], out["peak_zero1"], out["state_zero1"] = \
        dp_train(lambda: trainer_on_card(root, DP_CUTS + [
            "training.max_update=2", f"training.save_dir={root}/dp2"]),
            "segm bf16 world 2, rank 0", TRAIN_LAUNCHES[True], rank == 0)
    restore()
    out["allreduce"] = calls
    out["ms"] = [u["ms"] for u in rec["updates"]]
    out["sharded"] = type(trainer.state.optimizer).__name__
    # the ZeRO-1 state gathered to rank 0: the port's one gather_object
    # (what a checkpoint runs) against ZeRO's own consolidate_state_dict
    for name, gather in (
            ("gather_s", lambda o: optimizer_state_dict(o)),
            ("consolidate_s", lambda o: o.consolidate_state_dict(to=0))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gather(trainer.state.optimizer)
        out[name] = time.perf_counter() - t0
    del trainer, rec
    torch.cuda.empty_cache()

    # 12a: the checkpoint resumed at world 2, one more update
    saved = torch.load(root / "dp2/checkpoints/model_2.pth",
                       map_location="cpu", weights_only=True)
    resumed = trainer_on_card(root, DP_CUTS + [
        "training.max_update=3", "training.resume=true",
        f"training.save_dir={root}/dp2"])
    out["resume_model"] = all(torch.equal(v.cpu(), saved["model"][k]) for k, v
                              in resumed.state.model.state_dict().items())
    opt = optimizer_state_dict(resumed.state.optimizer)
    out["resume_opt"] = None if opt is None else (
        sorted(opt["state"]) == sorted(saved["optimizer"]["state"]) and all(
            torch.equal(v.cpu(), saved["optimizer"]["state"][i][k])
            for i, st in opt["state"].items() for k, v in st.items()
            if torch.is_tensor(v)))
    out["resume_position"] = (resumed.current_update, resumed.current_epoch,
                              resumed.epoch_batches_done)
    resumed.train()
    out["resume_step"] = resumed.state.step
    del resumed, saved, opt
    torch.cuda.empty_cache()

    # 12c: the same updates with the optimizer state replicated
    trainer, _, _, out["peak_plain"], out["state_plain"] = dp_train(
        lambda: trainer_on_card(root, DP_CUTS + [
            "training.max_update=1", "distributed.zero1=false",
            f"training.save_dir={root}/dp2_plain"]),
        "segm bf16 world 2, zero1 false, rank 0", TRAIN_LAUNCHES[True],
        rank == 0)
    out["sharded_plain"] = type(trainer.state.optimizer).__name__
    del trainer
    torch.cuda.empty_cache()

    # 12d: the Waymo trainer, val and test, then a resume with the draws
    wroot = root / "waymo"
    save = wroot / "save_dp2"
    records = {}

    def make():
        trainer = waymo_trainer_on_card(wroot, DP_3D_CUTS + [
            f"training.save_dir={save}"])
        evaluate = trainer.evaluate

        def evaluate_and_read(split):
            result = evaluate(split)
            with open(save / "results.pkl", "rb") as f:
                records[split] = sorted(pickle.load(f))
            return result

        trainer.evaluate = evaluate_and_read
        return trainer

    trainer, rec, out["counts_3d"], out["peak_3d"], _ = dp_train(
        make, "Waymo bf16 world 2, rank 0", TRAIN_3D_LAUNCHES, rank == 0)
    with open(save / "results.pkl", "rb") as f:
        records["test"] = sorted(pickle.load(f))
    out["records"] = records
    out["tokens"] = {s: sorted(i["token"] for i in trainer.datasets[s].infos)
                     for s in ("val", "test")}
    out["ms_3d"] = [u["ms"] for u in rec["updates"]]
    out["draws"] = trainer.loaders["train"].draw_state
    del trainer, rec
    torch.cuda.empty_cache()
    saved = torch.load(save / "checkpoints/model_2.pth", map_location="cpu",
                       weights_only=True)["extra"]["draw_states"]
    resumed = waymo_trainer_on_card(wroot, DP_3D_CUTS + [
        f"training.save_dir={save}", "training.max_update=3",
        "training.run_type=train", "training.resume=true"])
    out["restored_draws"] = draws_equal(resumed.loaders["train"].draw_state,
                                        saved[rank])
    out["saved_draws"] = len(saved)
    resumed.train()
    out["resume_step_3d"] = resumed.state.step
    torch.save(out, root / f"rank{rank}.pt")


def nccl_rank(task_path):
    """Phase 12b: the trainer in a process group of one over NCCL, 2
    updates from the loader at bf16 autocast."""
    task = torch.load(task_path, weights_only=False)
    root = Path(task["root"])
    trainer, rec, counts, _, _ = dp_train(
        lambda: trainer_on_card(root, DP_CUTS + [
            "training.max_update=2", f"training.save_dir={root}/nccl"]),
        "segm bf16 NCCL world 1", TRAIN_LAUNCHES[True], True)
    torch.save(dict(params={n: p.detach().cpu() for n, p in
                            trainer.state.model.named_parameters()},
                    ms=[u["ms"] for u in rec["updates"]], counts=counts,
                    stats=[u["stats"] for u in rec["updates"]],
                    lr=max(g["base_lr"]
                           for g in trainer.state.optimizer.param_groups)),
               root / "nccl.pt")


def run_data_parallel(dev, smi, phase10_ms):
    """Phase 12: data parallel through the port's trainer at full width on
    the one card. 12a: two ranks over gloo on the shipped segm config at a
    global batch of 2 (1 image a rank): one f32 update (256x384, no
    autocast) against a world-1 update of the same 2 images from the same
    weights, then 2 bf16 updates from the loader with a ZeRO-1 checkpoint,
    resumed at world 2 (model and optimizer state bitwise) and at world 1
    (one update); the gradient all-reduce's bytes and ms. 12b: the trainer
    in a process group of one over NCCL against the no-group trainer. 12c:
    each rank's optimizer-state bytes and peak memory with zero1 true and
    false. 12d: the Waymo config at world 2 (1 frame a rank): the ranks'
    GT-database draws differ, val and test results.pkl hold every frame
    once, a resume restores each rank's cursors. Returns (launch counts of
    the world-2 and NCCL trainers' runs, results)."""
    import shutil
    import tempfile

    from boxer_tpu_torch.dataset.synthetic import synthetic_batch, \
        write_waymo
    from boxer_tpu_torch.parallel.distributed import launch
    from boxer_tpu_torch.tools.preprocess.create_gt_database import \
        create_gt_database

    label = "data parallel"
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        write_coco(root)
        write_waymo(root / "waymo", WAYMO_DP_FRAMES, PC_RANGE_3D,
                    SERVE_POINTS, WAYMO_OBJECTS, seed=1)
        create_gt_database(str(root / "waymo"), "infos/infos_train.pkl")

        # 12a, world 1: one f32 update on 2 images in this process
        trainer = trainer_on_card(root, DP_F32_CUTS + [
            f"training.save_dir={root}/w1_f32"])
        batch = synthetic_batch(2, *E2E_CANVAS, num_targets=20,
                                num_classes=trainer.num_classes,
                                with_masks=True, seed=1, iter_per_update=1)
        as_torch = lambda x: ({k: as_torch(v) for k, v in x.items()}
                              if isinstance(x, dict) else torch.from_numpy(x))
        batch = as_torch(batch)
        weights = {k: v.detach().cpu().clone() for k, v in
                   trainer.state.model.state_dict().items()}
        _, want = trainer._train_step(
            trainer.state, tree_map(batch, lambda t: t.to(dev)))
        want_params = {n: p.detach().cpu() for n, p in
                       trainer.state.model.named_parameters()}
        del trainer
        torch.cuda.empty_cache()
        task = root / "task.pt"
        torch.save(dict(root=str(root), batch=batch, weights=weights), task)
        log(f"{label} [{smi}]: data in {time.perf_counter() - t0:.1f} s; "
            f"{TRAINER_CONFIG} and {TRAINER_3D_CONFIG} at 2 ranks over gloo "
            f"on the one card")

        t_ranks = time.perf_counter()
        launch(dp_ranks, 2, "gloo", args=(str(task),), devices=[0, 0],
               timeout=900)
        t_ranks = time.perf_counter() - t_ranks
        ranks = [torch.load(root / f"rank{r}.pt", weights_only=False)
                 for r in range(2)]

        # 12a: the world-2 update against the world-1 update
        got = ranks[0]["f32_stats"]
        keys = [k for k in want if k.startswith("loss_")] + [
            "total_loss", "num_boxes", "grad_norm"]
        stat_err = max(rel_err(got[k], want[k]) for k in keys)
        upd = {n: rel_err(p - weights[n], want_params[n] - weights[n])
               for n, p in ranks[0]["f32_params"].items()}
        worst = max(upd, key=upd.get)
        ranks_equal = all(torch.equal(p, ranks[1]["f32_params"][n])
                          for n, p in ranks[0]["f32_params"].items())
        log(f"12a [{smi}]: f32 update at {E2E_CANVAS}, world 2 (1 image a "
            f"rank) vs world 1 (2 images): {len(keys)} stats worst rel err "
            f"{stat_err:.3e} (num_boxes {got['num_boxes']:g} vs "
            f"{want['num_boxes']:g}), updated parameters worst leaf "
            f"{upd[worst]:.3e} ({worst}), median leaf "
            f"{float(np.median(list(upd.values()))):.3e}; the ranks' "
            f"parameters bitwise equal {ranks_equal}; each rank's initial "
            f"weights equal world 1's {[r['init_equal'] for r in ranks]}")
        # phase 8's rules: stats 1e-4; a leaf within 0.1 (a ReLU input
        # within rounding of 0 can take the other branch)
        if not (stat_err <= 1e-4 and upd[worst] <= 0.1 and ranks_equal
                and all(r["init_equal"] for r in ranks)):
            raise AssertionError("12a: world 2 and world 1 disagree")

        a0 = ranks[0]
        ar_bytes = {b for r in ranks for b, _ in r["allreduce"]}
        ar_ms = [ms for r in ranks for _, ms in r["allreduce"]]
        log(f"12a [{smi}]: bf16 updates at 1344x1344, world 2, rank 0 ms "
            f"{', '.join(f'{t:.2f}' for t in a0['ms'])} (phase 10's world "
            f"1: {phase10_ms:.2f} ms an update of 2 microbatches; two ranks "
            f"share one card here, so this is no scaling number); gradient "
            f"all-reduce {sorted(ar_bytes)} bytes an update, ms "
            f"{', '.join(f'{t:.2f}' for t in ar_ms)} (gloo stages the CUDA "
            f"buffer through the host: nothing of NCCL over NVLink); "
            f"optimizer {a0['sharded']}; resumed at world 2: model bitwise "
            f"{[r['resume_model'] for r in ranks]}, optimizer state bitwise "
            f"{a0['resume_opt']}, (update, epoch, skip) "
            f"{a0['resume_position']}, step after "
            f"{[r['resume_step'] for r in ranks]}")
        if not (all(r["resume_model"] and r["resume_step"] == 3
                    and r["resume_position"] == (2, 0, 2) for r in ranks)
                and a0["resume_opt"] and len(ar_bytes) == 1
                and a0["sharded"] == "ZeroRedundancyOptimizer"):
            raise AssertionError("12a: the world-2 checkpoint's resume")

        # 12a: the world-2 ZeRO-1 checkpoint resumed at world 1
        os.makedirs(root / "w1_resume/checkpoints")
        shutil.copy(root / "dp2/checkpoints/model_2.pth",
                    root / "w1_resume/checkpoints")
        one = trainer_on_card(root, DP_CUTS + [
            "training.max_update=3", "training.resume=true",
            f"training.save_dir={root}/w1_resume"])
        one_step = one.state.step
        rec = record_steps(one, lambda i, u: None)
        one.train()
        one_ok = (one_step == 2 and one.state.step == 3 and
                  rec["updates"][0]["stats"]["skipped"] == 0.0
                  and np.isfinite(rec["updates"][0]["stats"]["total_loss"]))
        log(f"12a [{smi}]: the world-2 checkpoint resumed at world 1 at "
            f"step {one_step}, one update: {rec['updates'][0]['ms']:.2f} ms,"
            f" total_loss {rec['updates'][0]['stats']['total_loss']:.5g}")
        if not one_ok:
            raise AssertionError("12a: the world-1 resume")
        del one, rec
        torch.cuda.empty_cache()

        # 12c
        state_mb = {k: [r[f"state_{k}"] / 2 ** 20 for r in ranks]
                    for k in ("zero1", "plain")}
        peak = {k: [r[f"peak_{k}"] for r in ranks] for k in ("zero1",
                                                           "plain")}
        log(f"12c [{smi}]: optimizer state MiB per rank, zero1 true "
            f"{[round(v, 2) for v in state_mb['zero1']]} (sum "
            f"{sum(state_mb['zero1']):.2f}), false "
            f"{[round(v, 2) for v in state_mb['plain']]}; GiB (peak, "
            f"allocated) after the first update per rank, zero1 true "
            f"{[tuple(round(v, 3) for v in p) for p in peak['zero1']]}, "
            f"false {[tuple(round(v, 3) for v in p) for p in peak['plain']]};"
            f" the state gathered to rank 0 in {a0['gather_s']:.2f} s "
            f"(gather_object), ZeRO's consolidate_state_dict "
            f"{a0['consolidate_s']:.2f} s")
        if not (abs(sum(state_mb["zero1"]) - state_mb["plain"][0]) < 1.0
                and max(state_mb["zero1"]) < 0.75 * state_mb["plain"][0]
                and a0["sharded_plain"] == "AdamW"):
            raise AssertionError("12c: the optimizer state is not sharded")

        # 12d
        draws_differ = not draws_equal(ranks[0]["draws"], ranks[1]["draws"])
        records_ok = all(r["records"][s] == r["tokens"][s] for r in ranks
                         for s in ("val", "test"))
        log(f"12d [{smi}]: Waymo bf16 world 2, rank 0 ms "
            f"{', '.join(f'{t:.2f}' for t in a0['ms_3d'])}; the ranks' draws "
            f"differ {draws_differ}; results.pkl val and test frames "
            f"{ {s: len(a0['records'][s]) for s in ('val', 'test')} } of "
            f"{ {s: len(a0['tokens'][s]) for s in ('val', 'test')} }, every "
            f"frame once {records_ok}; resumed with the checkpoint's "
            f"{a0['saved_draws']} ranks' cursors, each rank's restored "
            f"{[r['restored_draws'] for r in ranks]}, step after "
            f"{[r['resume_step_3d'] for r in ranks]}; peak GiB "
            f"{[round(r['peak_3d'][0], 2) for r in ranks]}")
        if not (draws_differ and records_ok and a0["saved_draws"] == 2
                and len(a0["tokens"]["val"]) == 3
                and all(r["restored_draws"] and r["resume_step_3d"] == 3
                        for r in ranks)):
            raise AssertionError("12d: the Waymo trainer at world 2")

        # 12b: NCCL at world 1 against the no-group trainer, twice
        t_nccl = time.perf_counter()
        launch(nccl_rank, 1, "nccl", args=(str(task),), devices=[0],
               timeout=600)
        t_nccl = time.perf_counter() - t_nccl
        nccl = torch.load(root / "nccl.pt", weights_only=False)
        alone = []
        for i in range(2):
            trainer, rec, _, _, _ = dp_train(
                lambda: trainer_on_card(root, DP_CUTS + [
                    "training.max_update=2",
                    f"training.save_dir={root}/alone{i}"]),
                "segm bf16 no group", TRAIN_LAUNCHES[True], False)
            alone.append(({n: p.detach().cpu() for n, p in
                           trainer.state.model.named_parameters()},
                          [u["ms"] for u in rec["updates"]],
                          [u["stats"] for u in rec["updates"]]))
            del trainer, rec
            torch.cuda.empty_cache()

        # the largest parameter difference (an element whose gradient is
        # near 0 may step by +lr or -lr: a leaf's relative error says
        # nothing after AdamW's first steps)
        def max_diff(a, b):
            return max(float((p - b[n]).abs().max()) for n, p in a.items())

        bitwise = all(torch.equal(p, alone[0][0][n])
                      for n, p in nccl["params"].items())
        nccl_err = max_diff(nccl["params"], alone[0][0])
        noise = max_diff(alone[1][0], alone[0][0])
        losses = [[st["total_loss"] for st in run] for run in
                  (nccl["stats"], alone[0][2], alone[1][2])]
        log(f"12b [{smi}]: NCCL world 1 vs no group after 2 AdamW updates: "
            f"parameters bitwise {bitwise}, at most {nccl_err:.3e} apart; "
            f"two no-group runs {noise:.3e} apart (K5/K6's "
            f"f32 atomics and cuDNN's backward add in a run-dependent "
            f"order); total_loss of updates 1 and 2, NCCL {losses[0]}, no "
            f"group {losses[1]} and {losses[2]}; ms per update NCCL "
            f"{', '.join(f'{t:.2f}' for t in nccl['ms'])} (the first "
            f"builds NCCL's communicator), no group "
            f"{', '.join(f'{t:.2f}' for t in alone[0][1])} and "
            f"{', '.join(f'{t:.2f}' for t in alone[1][1])} (phase 10: "
            f"{phase10_ms:.2f} ms an update of two 1-image microbatches)")
        # the same weights and batch: update 1's forward (K2, K3 and cuDNN's
        # forward are deterministic) gives the same loss; after it, each
        # AdamW step moves an element by about the LR either way
        if not (len({run[0] for run in losses}) == 1 and (
                bitwise or nccl_err <= max(2 * noise, 4 * nccl["lr"]))):
            raise AssertionError("12b: NCCL world 1 departs from the "
                                 "no-group trainer beyond run-to-run noise")
        log(f"phase 12 [{smi}]: ranks {t_ranks:.1f} s, NCCL {t_nccl:.1f} s")
        runs = {"dp2 segm rank 0": ranks[0]["counts"],
                "dp2 segm rank 1": ranks[1]["counts"],
                "dp2 waymo rank 0": ranks[0]["counts_3d"],
                "dp2 waymo rank 1": ranks[1]["counts_3d"],
                "nccl world 1": nccl["counts"]}
    return runs, dict(stat_err=stat_err, leaf_err=upd[worst],
                      allreduce_ms=ar_ms, allreduce_bytes=sorted(ar_bytes),
                      state_mb=state_mb, peak=peak, ms=a0["ms"],
                      ms_3d=a0["ms_3d"], nccl_ms=nccl["ms"],
                      nccl_err=nccl_err, noise=noise, bitwise=bitwise)


@contextlib.contextmanager
def saved_sample_bytes():
    """Tally the bytes of the sampling outputs that remat keeps from its
    forwards for their recomputes (by dtype: bf16 box-attention level sums,
    f32 instance-attention taps under autocast)."""
    ba = importlib.import_module("boxer_tpu_torch.ops.box_attention")

    keeping = ba.keeping_samples
    tally = {}

    @contextlib.contextmanager
    def counting(outputs, replay):
        with keeping(outputs, replay):
            yield
        if not replay:
            for t in outputs:
                key = str(t.dtype).replace("torch.", "")
                tally[key] = tally.get(key, 0) + t.numel() * t.element_size()

    ba.keeping_samples = counting
    try:
        yield tally
    finally:
        ba.keeping_samples = keeping


def remat_dropout_step(dev, smi):
    """Phase 13a: phase 7's full-width segm step (batch 1 at CANVAS) at
    dropout DROPOUT from the same seeded weights under one dropout key:
    under bf16 autocast once without remat, once with it and once more
    without (the eager step's own run-to-run spread), then in f32 with and
    without remat. The loss terms of each dtype bitwise equal; the f32
    pre-clip gradients, remat against eager, within a worst-leaf rel err of
    1e-4 (the recompute replays the forward bitwise; K5/K6's f32 atomics
    add in another order); the bf16 ones within phase 8's 0.1, beside the
    two eager runs' own spread (a reordered f32 sum that rounds to another
    bf16 value moves every leaf upstream of it); every sampling
    projection's gradient non-zero; the same launches with and without
    remat (K2 48, K5 24, K6 24, H1 2; no K3: the decoder's self-attention
    draws dropout, so it runs the plain math); every mask drawn from a CUDA
    generator. Returns ({run: launch counts}, results)."""
    from boxer_tpu_torch.nn import dropout

    label = f"segm train R50 {CANVAS}, dropout {DROPOUT}"
    batch = train_batch(CANVAS, True, dev)
    generator = dropout.DropoutKey.generator
    draws = []

    def recording(key, site, device):
        g = generator(key, site, device)
        draws.append(g.device.type)
        return g

    cases = (("eager bf16", False, torch.bfloat16),
             ("remat bf16", True, torch.bfloat16),
             ("eager bf16 again", False, torch.bfloat16),
             ("remat f32", True, torch.float32),
             ("eager f32", False, torch.float32))
    runs, res = {}, {}
    dropout.DropoutKey.generator = recording
    try:
        for name, remat, dtype in cases:
            model = build_model(True, dropout=DROPOUT).to(dev).train()
            model.transformer.remat = remat
            _, state, step = train_setup(model, True, dtype,
                                         debug_grads=True)
            draws.clear()
            torch.cuda.reset_peak_memory_stats(dev)
            for f in counters().values():
                f.launches = 0
            t0 = time.perf_counter()
            with saved_sample_bytes() as saved:
                _, stats = step(state, batch, update=0)
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            runs[name] = {k: f.launches for k, f in counters().items()}
            check_grads(stats["_grads"], f"{label}, {name}")
            res[name] = dict(stats=stats, ms=ms, draws=list(draws),
                             peak=torch.cuda.max_memory_allocated(dev)
                             / 2 ** 30)
            log(f"{label}, {name} [{smi}]: {ms:.2f} ms, peak "
                f"{res[name]['peak']:.2f} GiB, {len(draws)} masks drawn, "
                f"total loss {stats['total_loss']!r}, launches {runs[name]}, "
                f"sampling outputs kept by remat {saved} bytes")
            del model, state, step
            torch.cuda.empty_cache()
    finally:
        dropout.DropoutKey.generator = generator

    def same_losses(a, b):
        keys = [k for k in res[b]["stats"] if k.startswith("loss_")]
        return len(keys) > 20 and all(
            res[a]["stats"][k] == res[b]["stats"][k]
            for k in keys + ["total_loss"])

    errs = {pair: leaf_errs(res[pair[0]]["stats"], res[pair[1]]["stats"])
            for pair in (("remat bf16", "eager bf16"),
                         ("eager bf16 again", "eager bf16"),
                         ("remat f32", "eager f32"))}
    for (a, b), (worst, leaf, median) in errs.items():
        log(f"  {a} against {b}: gradients' worst leaf {worst:.3e} ({leaf}),"
            f" median {median:.3e}; loss terms bitwise {same_losses(a, b)}")
    want = per_run(K2=48, K5=24, K6=24, H1=2)
    drawn = [d for r in res.values() for d in r["draws"]]
    ok = (same_losses("remat bf16", "eager bf16")
          and same_losses("eager bf16 again", "eager bf16")
          and same_losses("remat f32", "eager f32")
          and errs[("remat f32", "eager f32")][0] <= 1e-4
          and errs[("remat bf16", "eager bf16")][0] <= 0.1
          and all(r == want for r in runs.values())
          and set(drawn) == {"cuda"}
          and len(res["remat bf16"]["draws"]) > len(
              res["eager bf16"]["draws"]) > 0)
    if not ok:
        raise AssertionError(f"{label}: remat against eager failed")
    eager, remat = res["eager bf16"], res["remat bf16"]
    return ({f"dropout step, {k}": v for k, v in runs.items()},
            dict(on_ms=remat["ms"], off_ms=eager["ms"],
                 on_peak=remat["peak"], off_peak=eager["peak"],
                 worst=errs[("remat bf16", "eager bf16")][0],
                 spread=errs[("eager bf16 again", "eager bf16")][0],
                 worst_f32=errs[("remat f32", "eager f32")][0]))


def remat_memory(dev, smi):
    """Phase 13b: the shipped segm config through the trainer at the
    recipe's per-card microbatch of 4 on the 1344x1344 canvas, 3 updates
    with remat on, then 3 with it off (a new trainer from the same seed),
    in this one process: each update finite, not skipped, with phase 7's
    segm launches (K3 6 fewer without remat); ms per update and peak
    memory of each. Returns ({remat: launch counts}, results)."""
    import tempfile

    runs, res = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_coco(root)
        for remat in (True, False):
            label = (f"trainer, segm R50 1344x1344 bf16 autocast, "
                     f"microbatch 4, remat {'on' if remat else 'off'}")
            trainer = trainer_on_card(root, REMAT_CUTS + [
                f"training.save_dir={root}/save_{remat}"])
            trainer.state.model.transformer.remat = remat
            rec = record_steps(trainer, lambda i, u: log(
                f"  update {i}: {u['ms']:.2f} ms, total_loss "
                f"{u['stats']['total_loss']:.5g}, launches {u['launches']}"))
            torch.cuda.reset_peak_memory_stats(dev)
            for f in counters().values():
                f.launches = 0
            with saved_sample_bytes() as saved:
                trainer.train()
                torch.cuda.synchronize()
            runs[remat] = {k: f.launches for k, f in counters().items()}
            peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            updates = rec["updates"]
            want = dict(TRAIN_LAUNCHES[True], K3=12 if remat else 6)
            if len(updates) != 3 or any(
                    u["stats"]["skipped"] != 0.0
                    or not np.isfinite(u["stats"]["total_loss"])
                    or u["launches"] != want for u in updates):
                raise AssertionError(f"{label}: {updates}")
            times = [u["ms"] for u in updates]
            res[remat] = dict(ms=float(np.median(times[1:])), times=times,
                              peak=peak)
            log(f"{label} [{smi}]: ms per update "
                f"{', '.join(f'{t:.2f}' for t in times)} (median of updates "
                f"2-3 {res[remat]['ms']:.2f}); peak {peak:.2f} GiB; sampling "
                f"outputs kept by remat an update "
                f"{ {k: v // 3 for k, v in saved.items()} } bytes")
            del trainer, rec
            torch.cuda.empty_cache()
    return runs, res


def detr_on_card(root, opts):
    """The port's trainer on the card from the shipped DETR config, the
    synthetic COCO under root (train and val, as the config has them) and
    the dotlist `opts`, loaded."""
    from boxer_tpu_torch.trainer import build_trainer
    from boxer_tpu_torch.utils.config import Configuration

    data = [f"dataset_config.detection.imdb_files.{split}.{key}="
            f"{root}/{name}"
            for split in ("train", "val")
            for key, name in (("anno_file", f"{split}.json"),
                              ("image_folder", "images"))]
    configuration = Configuration(
        str(ROOT / DETR_CONFIG), opts=data + opts,
        extra={"task": "detection", "model": "detr"}, device="cuda")
    trainer = build_trainer(configuration, device="cuda")
    trainer.load()
    return trainer


def run_detr(dev, smi):
    """Phase 13c: the shipped DETR R50 config through the trainer on the
    card at full width (R50 C5, hidden 256, 8 heads, 6+6 layers, FFN 2048,
    100 queries, dropout 0.1, AdamW with lr_backbone, max_norm 0.1, bf16
    autocast, the 1344x1344 canvas and the config's processors), cut only
    to batch 2 and 4 updates (DETR_CUTS), on phase 10's synthetic COCO:
    every update finite and not skipped at the schedule's LR, every
    transformer layer's gradient non-zero, val AP in [0, 1]; a trainer
    resumed from update 2's checkpoint replays updates 3-4 bitwise (model
    and optimizer state; cuDNN held to its deterministic algorithms in
    both runs); ms per update (median of updates 2-4), peak memory and one
    inference forward's device time. Returns (launch counts, results)."""
    import shutil
    import tempfile

    label = "trainer, DETR R50 1344x1344 bf16 autocast, dropout 0.1"
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            write_coco(root)
            log(f"{label} [{smi}]: {DETR_CONFIG} with {' '.join(DETR_CUTS)}")
            trainer = detr_on_card(root, DETR_CUTS + [
                f"training.save_dir={root}/save"])
            rec = record_steps(trainer, lambda i, u: log(
                f"  update {i}: {u['ms']:.2f} ms, total_loss "
                f"{u['stats']['total_loss']:.5g}, loss_ce "
                f"{u['stats']['loss_ce']:.5g}, grad_norm "
                f"{u['stats']['grad_norm']:.5g}, skipped "
                f"{u['stats']['skipped']:g}"))
            evals = {}
            evaluate = trainer.evaluate
            trainer.evaluate = lambda split: evals.setdefault(
                split, evaluate(split))
            torch.cuda.reset_peak_memory_stats(dev)
            for f in counters().values():
                f.launches = 0
            trainer.train()
            torch.cuda.synchronize()
            counts = {k: f.launches for k, f in counters().items()}
            peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            updates = rec["updates"]
            for i, u in enumerate(updates):
                st = u["stats"]
                if st["skipped"] != 0.0 or not all(
                        np.isfinite(v) for v in st.values()) or any(
                        lr != want for lr, want in u["lrs"].values()):
                    raise AssertionError(f"{label}: update {i + 1}: {u}")
            model = trainer.state.model
            layers = {f"{kind}.{i}": layer for kind in ("encoder", "decoder")
                      for i, layer in enumerate(
                          getattr(model.transformer, kind).layers)}
            zero = [n for n, layer in layers.items() if not all(
                p.grad is not None and bool(p.grad.abs().max() > 0)
                for p in layer.parameters())]
            ap = [float(x) for x in evals["val"]["coco_eval_bbox"]]
            if len(updates) != 4 or trainer.state.step != 4 or zero or len(
                    layers) != 12 or not 0.0 <= ap[0] <= 1.0:
                raise AssertionError(f"{label}: {len(updates)} updates, "
                                     f"zero-gradient layers {zero}, AP {ap}")
            times = [u["ms"] for u in updates]
            median = float(np.median(times[1:]))
            final = {k: v.detach().cpu().clone()
                     for k, v in model.state_dict().items()}
            opt = trainer.state.optimizer.state_dict()["state"]
            batch = rec["first"][0]
            mb = {k: v[0] for k, v in batch.items() if k in ("image", "mask")}

            def forward():
                with torch.no_grad(), torch.autocast("cuda", torch.bfloat16):
                    return model(mb["image"], mb["mask"], inference=True)

            model.eval()
            t0 = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            busy = profile(forward, (time.perf_counter() - t0) * 1e3,
                           "DETR R50 inference forward, a batch of 2")
            log(f"{label} [{smi}]: ms per update "
                f"{', '.join(f'{t:.2f}' for t in times)} (median of updates "
                f"2-4 {median:.2f}); peak {peak:.2f} GiB; val AP bbox "
                f"{ap[0]:.4g}; every one of the 12 transformer layers has a "
                f"non-zero gradient; launches {counts}")
            del trainer, rec, batch, mb, model
            torch.cuda.empty_cache()

            cut = root / "resume" / "checkpoints"
            cut.mkdir(parents=True)
            shutil.copy(root / "save" / "checkpoints" / "model_2.pth", cut)
            resumed = detr_on_card(root, DETR_CUTS + [
                f"training.save_dir={root}/resume", "training.resume=true",
                "training.run_type=train"])
            position = resumed.current_update
            resumed.train()
            torch.cuda.synchronize()
            model_ok = all(torch.equal(v.cpu(), final[k]) for k, v in
                           resumed.state.model.state_dict().items())
            ropt = resumed.state.optimizer.state_dict()["state"]
            opt_ok = sorted(ropt) == sorted(opt) and all(
                torch.equal(v.cpu(), opt[i][k].cpu())
                for i, st in ropt.items() for k, v in st.items())
            log(f"  resumed at update {position}, took updates 3-4: model "
                f"bitwise {model_ok}, optimizer state bitwise {opt_ok}")
            if not (position == 2 and resumed.state.step == 4 and model_ok
                    and opt_ok):
                raise AssertionError(f"{label}: the resume did not replay "
                                     "updates 3-4 bitwise")
            del resumed
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return counts, dict(ms=median, times=times, peak=peak, busy=busy, ap=ap)


def detr_card_vs_cpu(dev):
    """Phase 13d: DETR R50 at full width with seeded weights, inference at
    E2E_CANVAS in f32 (no TF32) on the card against the CPU: pred_logits
    and pred_boxes within max abs 1e-3."""
    from boxer_tpu_torch.models.detr import DETR

    model = DETR(num_classes=80).init_weights(0).eval()
    image, mask = make_image(E2E_CANVAS, seed=5)
    mask[:, :, E2E_CANVAS[1] * 3 // 4:] = True
    with torch.no_grad():
        want = model(image, mask)
        model.to(dev)
        got = model(image.to(dev), mask.to(dev))
    errs = {k: float((got[k].cpu() - want[k]).abs().max())
            for k in ("pred_logits", "pred_boxes")}
    log(f"DETR R50 inference at {E2E_CANVAS} f32, card against CPU: max abs "
        f"{errs}")
    if not all(v <= 1e-3 for v in errs.values()):
        raise AssertionError(f"DETR card against CPU: {errs}")
    del model
    torch.cuda.empty_cache()
    return errs


def run_phase13(dev, smi):
    """Phase 13 (13a-13d). Returns ({label: launch counts}, results)."""
    runs, step = remat_dropout_step(dev, smi)
    memory_runs, memory = remat_memory(dev, smi)
    runs.update({f"remat trainer, remat {k}": v
                 for k, v in memory_runs.items()})
    runs["detr trainer"], detr = run_detr(dev, smi)
    detr["card_vs_cpu"] = detr_card_vs_cpu(dev)
    return runs, dict(step=step, memory=memory, detr=detr)


@contextlib.contextmanager
def analytic_vjp(on=True):
    """Inside, the sampling op's backward is the analytic one
    (`set_box_attention_impl("analytic_vjp")`) or, with on=False, the
    default; restored after."""
    ba = importlib.import_module("boxer_tpu_torch.ops.box_attention")
    saved = ba.get_box_attention_impl()
    ba.set_box_attention_impl("analytic_vjp" if on else "xla")
    try:
        yield
    finally:
        ba.set_box_attention_impl(saved)


def analytic_op(dev, smi):
    """Phase 14a at op level: `box_attention_qminor`'s gradients (value, gx,
    gy, attention weights; f32) under the analytic backward against the
    default backward and against the analytic one with K2 and K5 swapped
    for their plain versions, at the encoder's P=4, M=161,576 a level (4
    levels at 800x1216, 8 heads) and at P=196, M=2,400 (300 queries; folded
    in the forward). K5 launches each way; CUDA-event ms of each backward
    (the median of 3). Returns {case: results}."""
    ba = importlib.import_module("boxer_tpu_torch.ops.box_attention")
    from boxer_tpu_torch.ops import combine_reduce as cr
    from boxer_tpu_torch.ops import scatter_accum as sa

    shapes = ((100, 152), (50, 76), (25, 38), (13, 19))
    s, nh, ch = sum(h * w for h, w in shapes), 8, 32
    results = {}
    for p, lq in ((4, s), (196, 300)):
        rs = np.random.RandomState(p)
        shape = (1, nh, len(shapes), p, lq)
        arrays = (rs.randn(1, s, nh, ch).astype(np.float32),
                  *rs.uniform(-0.02, 1.02, (2, *shape)).astype(np.float32),
                  rs.rand(*shape).astype(np.float32) / (4 * p))
        cot = torch.from_numpy(rs.randn(1, nh, lq, ch).astype(
            np.float32)).to(dev)

        def grads(analytic):
            ts = [torch.from_numpy(a).to(dev).requires_grad_()
                  for a in arrays]
            with analytic_vjp(analytic):
                out = ba.box_attention_qminor(ts[0], shapes, *ts[1:],
                                              raw=True)
            before = {k: f.launches for k, f in counters().items()}
            times = []
            for i in range(3):
                for t in ts:
                    t.grad = None
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                out.backward(cot, retain_graph=i < 2)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            launches = {k: (f.launches - before[k]) // 3
                        for k, f in counters().items()}
            return [t.grad for t in ts], float(np.median(times)), launches

        got, ms, launches = grads(True)
        want, ms_default, launches_default = grads(False)
        kernels = (ba.quad_sample_reduce_w4, ba.scatter_add_rows_weighted_dw4)
        ba.quad_sample_reduce_w4 = (
            lambda table, idx, w4: cr.quad_sample_reduce_plain(table, idx,
                                                               w4=w4))
        ba.scatter_add_rows_weighted_dw4 = sa.scatter_accum_dw4_plain
        try:
            plain, ms_plain, launches_plain = grads(True)
        finally:
            ba.quad_sample_reduce_w4, ba.scatter_add_rows_weighted_dw4 = \
                kernels
        names = ("d_value", "d_gx", "d_gy", "d_aw")
        errs = {n: rel_err(g, w) for n, g, w in zip(names, got, want)}
        errs_plain = {n: rel_err(g, w) for n, g, w in zip(names, got, plain)}
        label = f"P={p} M={nh * lq}"
        log(f"analytic backward, {label} f32 [{smi}]: against the default "
            f"backward {', '.join(f'{n} {e:.3e}' for n, e in errs.items())};"
            f" against its plain K2/K5 "
            f"{', '.join(f'{n} {e:.3e}' for n, e in errs_plain.items())}; "
            f"backward {ms:.4f} ms (default {ms_default:.4f}, plain "
            f"{ms_plain:.4f}); K5 launches a backward {launches['K5']} "
            f"(default {launches_default['K5']}, K7b "
            f"{launches_default['K7b']})")
        if not (max(errs.values()) <= 1e-4 and max(errs_plain.values())
                <= 1e-5 and launches["K5"] == len(shapes)
                and not launches_plain["K5"]):
            raise AssertionError(f"analytic backward {label}: disagrees or "
                                 "launches no K5 a level")
        results[label] = dict(errs=errs, errs_plain=errs_plain, ms=ms,
                              ms_default=ms_default, ms_plain=ms_plain,
                              k5=launches["K5"],
                              k5_default=launches_default["K5"])
    return results


def analytic_step(dev, smi):
    """Phase 14a at model level: phase 7's full-width segm step (batch 1 at
    CANVAS, remat on, the default) from the same seeded weights with the
    analytic backward on and off, in turns in this call: in f32 (the
    train-mode forward's outputs and the loss terms bitwise equal, the
    pre-clip gradients' worst leaf within 1e-5) and under bf16 autocast
    (the worst leaf within 0.1 beside two default runs' own spread); each
    way K2 48, K3 12, K5 24, K6 24 a step, 3 more timed steps (ms/step, the
    median), peak memory and one profiled step's device ms. Then one
    BoxeR-3D step at phase 9c's batch with the switch on: K2 8, K5 8, K3 2
    and finite gradients. Returns ({run: launch counts}, results)."""
    label = f"segm train R50 {CANVAS}"
    batch = train_batch(CANVAS, True, dev)
    mask = batch["mask"][0]
    cases = (("default f32", False, torch.float32),
             ("analytic f32", True, torch.float32),
             ("default bf16", False, torch.bfloat16),
             ("analytic bf16", True, torch.bfloat16),
             ("default bf16 again", False, torch.bfloat16))
    runs, res = {}, {}
    for name, on, dtype in cases:
        model = build_model(True).to(dev).train()
        _, state, step = train_setup(model, True, dtype, debug_grads=True)
        with analytic_vjp(on):
            outputs = None
            if dtype == torch.float32:
                with torch.no_grad():
                    out = model(batch["image"][0], mask, train=True,
                                inference=False)
                outputs = {k: v for k, v in out.items()
                           if k.startswith("pred_")}
            torch.cuda.reset_peak_memory_stats(dev)
            for f in counters().values():
                f.launches = 0
            _, stats = step(state, batch)
            torch.cuda.synchronize()
            runs[name] = {k: f.launches for k, f in counters().items()}
            peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            check_grads(stats["_grads"], f"{label}, {name}")
            times, _, _ = timed(lambda: step(state, batch), 3, dev)
            ms = float(np.median(times))
            busy = profile(lambda: step(state, batch), ms,
                           f"{label}, {name}, one step")
        res[name] = dict(stats=stats, outputs=outputs, ms=ms, peak=peak,
                         busy=busy[0])
        log(f"{label}, {name} [{smi}]: {ms:.2f} ms/step (median of 3: "
            f"{', '.join(f'{t:.2f}' for t in times)}), device busy "
            f"{busy[0]:.2f} ms, peak {peak:.2f} GiB, total loss "
            f"{stats['total_loss']!r}, launches {runs[name]}")
        del model, state, step
        torch.cuda.empty_cache()

    def same_losses(a, b):
        keys = [k for k in res[b]["stats"] if k.startswith("loss_")]
        return len(keys) > 20 and all(
            res[a]["stats"][k] == res[b]["stats"][k]
            for k in keys + ["total_loss"])

    fa, fd = res["analytic f32"]["outputs"], res["default f32"]["outputs"]
    same_forward = sorted(fa) == sorted(fd) and all(
        torch.equal(fa[k], fd[k]) for k in fd)
    errs = {pair: leaf_errs(res[pair[0]]["stats"], res[pair[1]]["stats"])
            for pair in (("analytic f32", "default f32"),
                         ("analytic bf16", "default bf16"),
                         ("default bf16 again", "default bf16"))}
    log(f"  f32: the forward's {len(fd)} outputs bitwise {same_forward}")
    for (a, b), (worst, leaf, median) in errs.items():
        log(f"  {a} against {b}: gradients' worst leaf {worst:.3e} ({leaf}),"
            f" median {median:.3e}; loss terms bitwise {same_losses(a, b)}")
    want = TRAIN_LAUNCHES[True]
    if not (same_forward and same_losses("analytic f32", "default f32")
            and errs[("analytic f32", "default f32")][0] <= 1e-5
            and errs[("analytic bf16", "default bf16")][0] <= 0.1
            and all(r == want for r in runs.values())):
        raise AssertionError(f"{label}: the analytic backward against the "
                             "default failed")

    # BoxeR-3D: phase 9c's step with the switch on
    model = build_model_3d(PC_RANGE_3D).to(dev).train()
    _, state, step = train_setup_3d(model, torch.bfloat16, debug_grads=True)
    for f in counters().values():
        f.launches = 0
    with analytic_vjp():
        _, stats = step(state, train_batch_3d(dev))
        torch.cuda.synchronize()
    runs["3d step, analytic"] = {k: f.launches for k, f in counters().items()}
    log(f"BoxeR-3D train step, analytic backward [{smi}]: total loss "
        f"{stats['total_loss']:.6g}, launches {runs['3d step, analytic']}")
    check_grads_3d(stats.pop("_grads"), "BoxeR-3D step, analytic backward")
    if runs["3d step, analytic"] != TRAIN_3D_LAUNCHES or not all(
            np.isfinite(v) for v in stats.values()):
        raise AssertionError("BoxeR-3D step under the analytic backward")
    del model, state, step
    torch.cuda.empty_cache()
    out = {name: {k: v for k, v in r.items() if k in ("ms", "peak", "busy")}
           for name, r in res.items()}
    out.update(worst_f32=errs[("analytic f32", "default f32")][0],
               worst_bf16=errs[("analytic bf16", "default bf16")][0],
               spread=errs[("default bf16 again", "default bf16")][0])
    return ({f"analytic step, {k}": v for k, v in runs.items()}, out)


def host_ms(fn, reps=5):
    """fn() `reps` times after one warm-up: (the median host ms, the last
    result)."""
    out, times = fn(), []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), out


def run_native(smi):
    """Phase 14b: the native runtime (`boxer_tpu_torch/native`, built here
    with g++) against the port's numpy versions, host ms of each (median of
    5): phase 9's served cloud through the shipped Waymo train processor's
    voxelize (voxel 0.32 x 0.32 x 12 m over PC_RANGE_3D: the 469 x 469
    grid, 20 points and 32,000 voxels, `config/base_boxer3d_detection.yaml:
    30-55`), outputs bitwise; `box_collision_test` on 250 boxes against 250
    and `mask_to_rle_counts` on one 800x1216 mask, equal."""
    from boxer_tpu_torch import native
    from boxer_tpu_torch.dataset.helper.database_sampler import \
        box_collision_test
    from boxer_tpu_torch.dataset.processor.voxelizer import points_to_voxel
    from boxer_tpu_torch.utils.rle import mask_to_rle_counts

    t0 = time.perf_counter()
    lib = native.build()
    native.library()
    log(f"native: {lib.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.2f} s")
    cloud = lidar_cloud(PC_RANGE_3D, SERVE_POINTS, seed=3)
    args = (cloud, (0.32, 0.32, 12.0), PC_RANGE_3D)
    kw = dict(max_points=POINTS_3D, max_voxels=VOXELS_3D)
    rs = np.random.RandomState(14)

    def boxes(n):
        return np.concatenate([
            rs.uniform(-40, 40, (n, 2)), rs.uniform(-1, 1, (n, 1)),
            rs.uniform(1, 5, (n, 2)), rs.uniform(1, 2, (n, 1)),
            rs.uniform(-np.pi, np.pi, (n, 1))], 1).astype(np.float32)

    b1, b2 = boxes(250), boxes(250)
    yy, xx = np.mgrid[:800, :1216]
    mask = np.zeros((800, 1216), bool)
    for _ in range(6):
        cy, cx, ry, rx = rs.uniform(0, 800), rs.uniform(0, 1216), \
            *rs.uniform(20, 200, 2)
        mask |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1
    cases = (("voxelize 180,000 points", lambda: points_to_voxel(*args, **kw),
              lambda: native.points_to_voxel_native(*args, **kw)),
             ("box_collision_test 250 x 250",
              lambda: box_collision_test(b1, b2),
              lambda: native.box_collision_test_native(b1, b2)),
             ("mask_to_rle_counts 800x1216", lambda: mask_to_rle_counts(mask),
              lambda: native.mask_to_rle_counts_native(mask)))
    results = {}
    for name, numpy_fn, native_fn in cases:
        ms_numpy, want = host_ms(numpy_fn)
        ms_native, got = host_ms(native_fn)
        if isinstance(want, tuple):
            equal = all(a.dtype == b.dtype and a.shape == b.shape
                        and a.tobytes() == b.tobytes()
                        for a, b in zip(got, want))
            detail = f"{len(want[0])} voxels"
        elif isinstance(want, list):
            equal, detail = got == want, f"{len(want)} counts"
        else:
            equal = got.dtype == want.dtype and np.array_equal(got, want)
            detail = f"{int(want.sum())} overlapping pairs"
        log(f"native {name} [{smi}; host]: {ms_native:.3f} ms, numpy "
            f"{ms_numpy:.3f} ms ({detail}), equal {equal}")
        if not equal:
            raise AssertionError(f"native {name} differs from numpy")
        results[name] = dict(native_ms=ms_native, numpy_ms=ms_numpy)
    return results


def run_tools(dev, smi):
    """Phase 14c: the user tools on the card. `tools.analyze` with every
    task at full width (BoxeR-2D R50 from the shipped detection config,
    800x1216, bf16; 10 timed forwards): its parameter count equal to the
    model's `parameters()` sum, FLOPs > 0, a structure line a parameter;
    then `tools.visualize` (the shipped segm config, a generated 480x640
    image resized to 800x1066) and the segmentation demo (512x512), each
    with seeded weights, must write a PNG of the image's size."""
    import io
    import tempfile

    from PIL import Image

    from boxer_tpu_torch.models import build_model as build
    from boxer_tpu_torch.tools import analyze, visualize
    from boxer_tpu_torch.tools.examples import boxer2d_segmentation_demo
    from boxer_tpu_torch.utils.config import Configuration

    config = str(ROOT / "boxer_tpu_torch/config/COCO-Detection/"
                 "boxer2d_r50_3x.yaml")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        got = analyze.main(["--tasks", "parameter", "flop", "speed",
                            "structure", "--config", config, "--iters", "10"])
    lines = printed.getvalue().splitlines()
    for line in lines:
        if line.startswith(("parameters:", "flops:", "speed:")):
            log(f"analyze [{smi}]: {line}")
    cfg = Configuration(config_path=config, extra={
        "task": "detection", "model": "boxer2d"}).get_config()
    n_params = sum(p.numel() for p in build(cfg.model_config["boxer2d"],
                                            91).parameters())
    log(f"analyze: structure {got['structure']} lines; parameters() "
        f"{n_params}")
    if not (got["parameter"][0] == n_params and got["flop"] > 0
            and got["structure"] == len(lines) - 3 > 0 and got["speed"] > 0):
        raise AssertionError("tools.analyze at full width")

    segm = str(ROOT / "boxer_tpu_torch/config/COCO-InstanceSegmentation/"
               "boxer2d_r50_3x.yaml")
    with tempfile.TemporaryDirectory() as tmp:
        photo = os.path.join(tmp, "photo.png")
        Image.fromarray((np.random.RandomState(15).rand(480, 640, 3) * 255)
                        .astype(np.uint8)).save(photo)
        t0 = time.perf_counter()
        out, n = visualize.main(["--config", segm, "--image", photo, "--out",
                                 os.path.join(tmp, "viz.png")])
        viz = Image.open(out).size
        t1 = time.perf_counter()
        out, n_demo = boxer2d_segmentation_demo.main(
            ["--out", os.path.join(tmp, "demo.png")])
        demo = Image.open(out).size
        t2 = time.perf_counter()
    log(f"visualize [{smi}]: a {viz[0]}x{viz[1]} PNG, {n} detections, "
        f"{t1 - t0:.1f} s; demo: a {demo[0]}x{demo[1]} PNG, {n_demo} "
        f"instances, {t2 - t1:.1f} s")
    if viz != (1066, 800) or demo != (512, 512):
        raise AssertionError(f"tools: PNG sizes {viz}, {demo}")
    return dict(analyze=got, viz=viz, demo=demo)


def run_phase14(dev, smi):
    """Phase 14 (14a-14c). Returns ({label: launch counts}, results)."""
    op = analytic_op(dev, smi)
    runs, step = analytic_step(dev, smi)
    return runs, dict(op=op, step=step, native=run_native(smi),
                      tools=run_tools(dev, smi))



# ---------------------------------------------------------------------------
# phase 15: tensor (mp) and sequence (sp) parallelism

@contextlib.contextmanager
def sampling_shapes():
    """Record, a rank, each sampling call's (BH, S): its heads by batch and
    the tokens of its value table; each K2, K5 and K6 launch's index shape
    (P, M): M its output (or scattered) rows; each K3 launch's (BH, Lq,
    Lk); and under "inputs" a copy of the inputs of each kernel's first
    call at each of these shapes, {(kernel, shape): (args, kwargs)}."""
    ba = importlib.import_module("boxer_tpu_torch.ops.box_attention")
    da = importlib.import_module("boxer_tpu_torch.nn.dense_attention")
    seen = {k: set() for k in ("tables", "K2", "K5", "K6", "K3")}
    inputs = seen["inputs"] = {}
    names = ("_build_quad_tables", "quad_sample_reduce_w4",
             "scatter_add_rows_weighted_dw4")
    saved = {n: getattr(ba, n) for n in names}
    saved_attention = da.attention

    def record(kernel, shape, args, kw=None):
        seen[kernel].add(shape)
        if (kernel, shape) not in inputs:
            inputs[kernel, shape] = (
                [a.detach().clone() if torch.is_tensor(a) else a
                 for a in args], dict(kw or {}))

    def tables(value, shapes):
        seen["tables"].add((value.shape[0] * value.shape[2], value.shape[1]))
        return saved["_build_quad_tables"](value, shapes)

    def w4(table, idx, w):
        record("K2", tuple(idx.shape), (table, idx, w))
        return saved["quad_sample_reduce_w4"](table, idx, w)

    def dw4(idx, g, w, table, per_tap, **kw):
        record("K6" if per_tap else "K5", tuple(idx.shape),
               (idx, g, w, table, per_tap), kw)
        return saved["scatter_add_rows_weighted_dw4"](idx, g, w, table,
                                                      per_tap, **kw)

    def attention(q, k, v, mask=None, *args, **kw):
        record("K3", (q.shape[0], q.shape[1], k.shape[1]), (q, k, v, mask))
        return saved_attention(q, k, v, mask, *args, **kw)

    for n, fn in zip(names, (tables, w4, dw4)):
        setattr(ba, n, fn)
    da.attention = attention
    try:
        yield seen
    finally:
        for n, fn in saved.items():
            setattr(ba, n, fn)
        da.attention = saved_attention


@contextlib.contextmanager
def collective_ms():
    """Inside, each collective of `parallel/collectives.py` is timed on the
    host clock between two synchronizes. Yields {name: ms}, summed."""
    from boxer_tpu_torch.parallel import collectives

    ms = collections.defaultdict(float)
    saved = collectives._all_reduce, collectives._all_gather

    def timed(fn):
        def run(t, axis, name):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(t, axis, name)
            torch.cuda.synchronize()
            ms[name] += (time.perf_counter() - t0) * 1e3
            return out
        return run

    collectives._all_reduce, collectives._all_gather = map(timed, saved)
    try:
        yield ms
    finally:
        collectives._all_reduce, collectives._all_gather = saved


@contextlib.contextmanager
def plain_kernels(*names):
    """Inside, the model's call sites of the named kernels (K2, K3, K4, K9
    and K56, the fused K5/K6 scatter) run their plain versions."""
    ba = importlib.import_module("boxer_tpu_torch.ops.box_attention")
    from boxer_tpu_torch.ops import box_sample as bs
    from boxer_tpu_torch.ops import combine_reduce as cr
    from boxer_tpu_torch.ops import flash_attention as fa
    from boxer_tpu_torch.ops import instance_sample as isr
    from boxer_tpu_torch.ops import scatter_accum as sa

    swaps = {
        "K2": (ba, "quad_sample_reduce_w4",
               lambda table, idx, w4: cr.quad_sample_reduce_plain(
                   table, idx, w4=w4)),
        "K3": (fa, "flash_attention", fa.flash_attention_plain),
        "K4": (ba, "instance_sample_reduce", isr.instance_sample_reduce_plain),
        "K9": (ba, "box_sample_reduce", bs.box_sample_reduce_plain),
        "K56": (ba, "scatter_add_rows_weighted_dw4",
                sa.scatter_accum_dw4_plain)}
    saved = [(mod, attr, getattr(mod, attr))
             for mod, attr, _ in (swaps[n] for n in names)]
    for n in names:
        mod, attr, plain = swaps[n]
        setattr(mod, attr, plain)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def held_against_plain(inputs):
    """Each kernel on the inputs a model step gave it (`sampling_shapes`)
    against its plain version: {"kernel (shape)": max rel err} (of both
    outputs of the fused K5/K6 scatter)."""
    from boxer_tpu_torch.ops import combine_reduce as cr
    from boxer_tpu_torch.ops import flash_attention as fa
    from boxer_tpu_torch.ops import scatter_accum as sa

    errs = {}
    for (kernel, shape), (args, kw) in sorted(inputs.items()):
        if kernel == "K2":
            table, idx, w = args
            got = [cr.quad_sample_reduce_w4(table, idx, w)]
            want = [cr.quad_sample_reduce_plain(table, idx, w4=w)]
        elif kernel == "K3":
            got = [fa.flash_attention(*args)]
            want = [fa.flash_attention_plain(*args)]
        else:
            got = sa.scatter_add_rows_weighted_dw4(*args, **kw)
            want = sa.scatter_accum_dw4_plain(*args, **kw)
        errs[f"{kernel} {shape}"] = max(
            rel_err(a, b) for a, b in zip(got, want) if b is not None)
    return errs


def layout_opts(layout):
    dp, sp, mp = layout
    return [f"distributed.dp={dp}", f"distributed.sp={sp}",
            f"distributed.mp={mp}"]


def whole_params(model, layout):
    """A copy of every parameter of the whole model on the host (the mp
    parts gathered)."""
    from boxer_tpu_torch.parallel.sharding import gather_state

    return {n: p.detach().cpu().clone() for n, p in gather_state(
        dict(model.named_parameters()), layout).items()}


def f32_update(step_fn, state, batch, layout):
    """One update with the launch counters zeroed just before and read just
    after: (stats, whole parameters after, launches, shapes, whole
    parameters before); after the counts are read, each kernel against its
    plain version on the inputs the update gave it, under the shapes'
    "plain" (`held_against_plain`)."""
    before = whole_params(state.model, layout)
    for f in counters().values():
        f.launches = 0
    with sampling_shapes() as seen:
        _, stats = step_fn(state, batch)
        torch.cuda.synchronize()
    counts = {k: f.launches for k, f in counters().items()}
    seen["plain"] = held_against_plain(seen.pop("inputs"))
    torch.cuda.empty_cache()
    return stats, whole_params(state.model, layout), counts, seen, before


def update_3d_f32(dev, layout):
    """15d: one f32 update of the bench-width BoxeR-3D (seeded weights, the
    heads perturbed as 9b's) on phase 9c's batch, SGD at LR 10 (lr_backbone
    1), clip 1.0, cut to `layout`."""
    from boxer_tpu_torch.criterion.losses import Boxer3DCriterion
    from boxer_tpu_torch.nn.matcher import HungarianMatcher3d
    from boxer_tpu_torch.optim import build_optimizer
    from boxer_tpu_torch.parallel.sharding import shard_model
    from boxer_tpu_torch.parallel.steps import TrainState, make_train_step

    model = build_model_3d(PC_RANGE_3D, seed=0, noise_seed=1).to(dev)
    shard_model(model, layout)
    criterion = Boxer3DCriterion(BENCH_3D["num_classes"],
                                 HungarianMatcher3d(2, 5, 2, 4),
                                 TRAIN_WEIGHTS_3D, ["boxes", "focal_labels"])
    state = TrainState(model, build_optimizer(MP_SGD, model))
    step = make_train_step(criterion, max_norm=1.0, layout=layout)
    return f32_update(step, state, train_batch_3d(dev, seed=0), layout)


def detr_update_f32(root, batch, layout):
    """15d: one f32 update of the shipped DETR config (phase 13c's) through
    its trainer, SGD at LR 10, on `batch`, at `layout`."""
    trainer = detr_on_card(root, MP_DETR_CUTS + layout_opts(layout) + [
        f"training.save_dir={root}/detr_{'x'.join(map(str, layout))}"])
    dev = trainer.device
    return f32_update(trainer._train_step, trainer.state,
                      tree_map(batch, lambda t: t.to(dev)), trainer.layout)


def mp_ranks(task_path, name):
    """Phase 15 in one rank of the layout `name` (`run_model_parallel`
    launches them, every rank on the one card over gloo): 15a's f32 update,
    15b/15c's bf16 updates from the loader (sp2 x mp2: a checkpoint at
    update 2), at mp2 also 15d's BoxeR-3D and DETR updates. Writes what the
    parent checks to <root>/<name>_rank<r>.pt."""
    import torch.distributed as dist

    from boxer_tpu_torch.parallel import collectives
    from boxer_tpu_torch.parallel.sharding import (gather_state,
                                                   optimizer_state_dict,
                                                   param_names)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    task = torch.load(task_path, weights_only=False)
    root, rank = Path(task["root"]), dist.get_rank()
    layout = MP_LAYOUTS[name]
    out = {}

    # 15a: one f32 update of both images (one data shard)
    trainer = trainer_on_card(root, DP_F32_CUTS + layout_opts(layout) + [
        f"training.save_dir={root}/{name}_f32"])
    lay = trainer.layout
    out["coord"] = (lay.dp.index, lay.sp.index, lay.mp.index)
    out["init_equal"] = all(
        torch.equal(v.cpu(), task["weights"][k]) for k, v in
        gather_state(trainer.state.model.state_dict(), lay).items())
    dev = trainer.device
    batch = tree_map(task["batch"], lambda t: t.to(dev))
    if name == "sp2mp2":
        out["infer"] = inference_outputs(trainer, batch)
    out["f32_stats"], out["f32_params"], out["f32_counts"], seen, _ = \
        f32_update(trainer._train_step, trainer.state, batch, lay)
    out["f32_plain"] = seen.pop("plain")
    out["f32_shapes"] = {k: sorted(v) for k, v in seen.items()}
    if name == "sp2mp2":
        out["swapped"] = swapped_steps(trainer, batch, task["weights"])
    del trainer, batch, seen
    torch.cuda.empty_cache()

    # 15b, 15c: 2 bf16 updates from the loader, one image, the collectives
    # timed (a synchronize on each side of each)
    collectives.reset_counts()
    with collective_ms() as ms:
        trainer, rec, out["counts"], out["peak"], _ = dp_train(
            lambda: trainer_on_card(root, MP_CUTS + layout_opts(layout) + [
                f"training.save_dir={root}/{name}"]),
            f"segm bf16 {name}, rank 0", TRAIN_LAUNCHES[True], rank == 0)
    out["collectives"] = {k: (*v, ms[k]) for k, v in
                          collectives.COUNTS.items()}
    out["ms"] = [u["ms"] for u in rec["updates"]]
    if name == "sp2mp2":
        # the checkpoint of update 2 against this rank's gathered state
        st = trainer.state
        model = gather_state(st.model.state_dict(), trainer.layout)
        opt = optimizer_state_dict(st.optimizer, trainer.layout,
                                   param_names(st.model, st.optimizer))
        saved = torch.load(root / f"{name}/checkpoints/model_2.pth",
                           map_location="cpu", weights_only=True)
        out["ckpt_model"] = all(torch.equal(v.cpu(), saved["model"][k])
                                for k, v in model.items())
        out["ckpt_opt"] = rank != 0 or all(
            torch.equal(v.cpu(), saved["optimizer"]["state"][i][k])
            for i, s in opt["state"].items() for k, v in s.items()
            if torch.is_tensor(v))
    del trainer, rec
    torch.cuda.empty_cache()

    if name == "mp2":
        # 15d, each kernel also against its plain version on its inputs
        for key, update in (
                ("3d", lambda: update_3d_f32(dev, lay)),
                ("detr", lambda: detr_update_f32(root, task["detr_batch"],
                                                 layout))):
            stats, params, counts, seen, _ = update()
            out[key] = (stats, params, counts, seen["plain"])
            torch.cuda.empty_cache()
    torch.save(out, root / f"{name}_rank{rank}.pt")


def inference_outputs(trainer, batch):
    """15a: the trainer's inference step (fold=True: K9 in the encoder and
    the decoder's box attention, K4 in its last layer's instance attention)
    in f32 on the batch's first microbatch, with the kernels and then with
    K9, K3 and K4 swapped for their plain versions: [({output: host f32},
    launches)] in that order."""
    image = {"image": batch["image"][0], "mask": batch["mask"][0]}
    runs = []
    for names in ((), ("K9", "K3", "K4")):
        for f in counters().values():
            f.launches = 0
        with plain_kernels(*names):
            out = trainer._inference_step(trainer.state, image)
            torch.cuda.synchronize()
        runs.append(({k: v.float().cpu() for k, v in out.items()
                      if torch.is_tensor(v) and v.is_floating_point()},
                     {k: f.launches for k, f in counters().items()}))
        del out
        torch.cuda.empty_cache()
    return runs


def swapped_steps(trainer, batch, weights):
    """15a at sp2 x mp2: the sharded f32 step (debug gradients, whole)
    from the task's weights with the kernels, then with the fused K5/K6
    swapped for their plain version (the same forward), then with K2, K3,
    K5 and K6 all swapped (the gradients held on the host between runs;
    the four ranks share the card). Returns {swap: (the loss terms' worst
    rel err, the pre-clip gradients' worst leaf rel err, that leaf, the
    median leaf's, launches, peak GiB)} against the kernels' step, and the
    kernels' (launches, peak GiB) under "kernels"."""
    from boxer_tpu_torch.parallel.sharding import shard_state
    from boxer_tpu_torch.parallel.steps import make_train_step

    step = make_train_step(trainer.criterion, compute_dtype=torch.float32,
                           debug_grads=True, layout=trainer.layout)
    out, kernels = {}, None
    for label, names in (("kernels", ()), ("K5/K6 plain", ("K56",)),
                         ("K2/K3/K5/K6 plain", ("K2", "K3", "K56"))):
        trainer.state.model.load_state_dict(
            shard_state(weights, trainer.layout))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for f in counters().values():
            f.launches = 0
        with plain_kernels(*names):
            _, stats = step(trainer.state, batch, update=0)
            torch.cuda.synchronize()
        counts = {k: f.launches for k, f in counters().items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        stats["_grads"] = {n: g.cpu() for n, g in stats["_grads"].items()}
        if kernels is None:
            kernels, out[label] = stats, (counts, peak)
            keys = [k for k in stats if k.startswith("loss_")] + [
                "total_loss"]
            continue
        worst, leaf, median = leaf_errs(kernels, stats)
        out[label] = (max(rel_err(kernels[k], stats[k]) for k in keys),
                      worst, leaf, median, counts, peak)
        del stats
    torch.cuda.empty_cache()
    return out


def held_by_12a(got, want, want_params, weights, ranks):
    """Phase 12a's rule: (stats worst rel err, worst leaf, its name, every
    rank's whole parameters bitwise equal)."""
    keys = [k for k in want if k.startswith("loss_")] + [
        "total_loss", "num_boxes", "grad_norm"]
    stat_err = max(rel_err(got[k], want[k]) for k in keys)
    upd = {n: rel_err(p - weights[n], want_params[n] - weights[n])
           for n, p in ranks[0].items()}
    worst = max(upd, key=upd.get)
    equal = all(torch.equal(p, r[n]) for r in ranks[1:]
                for n, p in ranks[0].items())
    return stat_err, upd[worst], worst, equal


def run_model_parallel(dev, smi):
    """Phase 15: tensor (mp) and sequence (sp) parallelism through the
    port's trainer at full width on the one card, every rank of a layout
    on it over gloo (NCCL refuses two ranks on one card), at mp2, sp2 and
    sp2 x mp2 (4 ranks). 15a: one f32 update of the shipped segm config at
    256x384 (SGD, no autocast) on 2 images against a world-1 update of the
    same images and weights (phase 12a's rule), each kernel's launches and
    shapes a rank, each kernel against its plain version on its inputs;
    at sp2 x mp2 the step with the kernels swapped for their plain
    versions and the inference forward (K9) against world 1 and its plain
    kernels. 15b: 2 bf16 updates from the loader at sp2 x mp2 with a
    checkpoint at update 2, resumed at world 1 (model and optimizer state
    bitwise equal to the ranks' gathered state) for one more update. 15c:
    each rank's peak memory (one image a data shard) at world 1, mp2, sp2
    and sp2 x mp2, each collective's calls, bytes and ms a rank and update
    (gloo stages through the host), ms per update. 15d: one f32 update of
    BoxeR-3D (phase 9c's batch) and of DETR (phase 13c's config) at mp2
    against world 1; sp2 on either raises before anything is built.
    Returns (launch counts of the layouts' bf16 runs, results)."""
    import shutil
    import tempfile

    from boxer_tpu_torch.dataset.synthetic import synthetic_batch
    from boxer_tpu_torch.parallel.distributed import launch
    from boxer_tpu_torch.parallel.mesh import Layout
    from boxer_tpu_torch.trainer import build_trainer
    from boxer_tpu_torch.utils.config import Configuration

    label = "model parallel"
    world1 = Layout()
    as_torch = lambda x: ({k: as_torch(v) for k, v in x.items()}
                          if isinstance(x, dict) else torch.from_numpy(x))
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_coco(root)

        # sp2 on BoxeR-3D and DETR: refused before anything is built
        refused = {}
        for model, cfg, task in (("boxer3d", TRAINER_3D_CONFIG, "detection3d"),
                                 ("detr", DETR_CONFIG, "detection")):
            try:
                build_trainer(Configuration(
                    str(ROOT / cfg), opts=["distributed.sp=2"],
                    extra={"task": task, "model": model}, device="cuda"),
                    device="cuda")
                refused[model] = None
            except ValueError as e:
                refused[model] = str(e)
        if not all(refused.values()):
            raise AssertionError(f"15d: sp=2 not refused: {refused}")

        # world 1: 15a's update, 15d's updates
        trainer = trainer_on_card(root, DP_F32_CUTS + [
            f"training.save_dir={root}/w1_f32"])
        batch = as_torch(synthetic_batch(
            2, *E2E_CANVAS, num_targets=20, num_classes=trainer.num_classes,
            with_masks=True, seed=1, iter_per_update=1))
        weights = {k: v.detach().cpu().clone() for k, v in
                   trainer.state.model.state_dict().items()}
        on_card = tree_map(batch, lambda t: t.to(dev))
        w1_infer = inference_outputs(trainer, on_card)[0]
        want, want_params, want_counts, seen, _ = f32_update(
            trainer._train_step, trainer.state, on_card, world1)
        w1_plain = seen.pop("plain")
        w1_shapes = {k: sorted(v) for k, v in seen.items()}
        del on_card
        n_classes = trainer.num_classes
        del trainer
        torch.cuda.empty_cache()
        *want_3d, _, w3 = update_3d_f32(dev, world1)
        torch.cuda.empty_cache()
        detr_batch = as_torch(synthetic_batch(
            2, *E2E_CANVAS, num_targets=20, num_classes=n_classes, seed=2,
            iter_per_update=1))
        *want_detr, _, wd = detr_update_f32(root, detr_batch, (1, 1, 1))
        torch.cuda.empty_cache()
        task = root / "task.pt"
        torch.save(dict(root=str(root), batch=batch, weights=weights,
                        detr_batch=detr_batch), task)

        ranks, t_ranks = {}, {}
        for name, layout in MP_LAYOUTS.items():
            n = int(np.prod(layout))
            t0 = time.perf_counter()
            launch(mp_ranks, n, "gloo", args=(str(task), name),
                   devices=[0] * n, timeout=900)
            t_ranks[name] = time.perf_counter() - t0
            ranks[name] = [torch.load(root / f"{name}_rank{r}.pt",
                                      weights_only=False) for r in range(n)]

        # 15a
        keys_ok = True
        for name, rs in ranks.items():
            stat_err, leaf, worst, equal = held_by_12a(
                rs[0]["f32_stats"], want, want_params,
                {k: weights[k] for k in want_params},
                [r["f32_params"] for r in rs])
            shapes = rs[0]["f32_shapes"]
            log(f"15a [{smi}]: {name} {MP_LAYOUTS[name]} (dp, sp, mp), f32 "
                f"update at {E2E_CANVAS} on 2 images vs world 1: stats worst "
                f"rel err {stat_err:.3e}, updated parameters worst leaf "
                f"{leaf:.3e} ({worst}); every rank's whole parameters "
                f"bitwise equal {equal}; initial weights equal world 1's "
                f"{[r['init_equal'] for r in rs]}; launches a rank "
                f"{[{k: v for k, v in r['f32_counts'].items() if v} for r in rs]}"
                f" (world 1: { {k: v for k, v in want_counts.items() if v} });"
                f" rank 0's (BH, S) of the sampled tables {shapes['tables']} "
                f"(world 1: {w1_shapes['tables']}), K2 (P, M) "
                f"{shapes['K2']}, K5 {shapes['K5']}, K6 {shapes['K6']}, K3 "
                f"(BH, Lq, Lk) {shapes['K3']} (world 1 K3 {w1_shapes['K3']})")
            plain = {k: max(r["f32_plain"][k] for r in rs)
                     for k in rs[0]["f32_plain"]}
            log(f"15a [{smi}]: {name}, each kernel against its plain version "
                f"on the inputs the update gave it (every rank's worst rel "
                f"err at each shape): " + ", ".join(
                    f"{k} {e:.3e}" for k, e in plain.items()))
            keys_ok &= (stat_err <= 1e-4 and leaf <= 0.1 and equal
                        and all(r["init_equal"] for r in rs)
                        and all(r["f32_counts"] == want_counts for r in rs)
                        and {k.split()[0] for k in plain} == {
                            "K2", "K3", "K5", "K6"}
                        and max(plain.values()) <= 1e-5)
        log(f"15a [{smi}]: world 1, each kernel against its plain version: "
            + ", ".join(f"{k} {e:.3e}" for k, e in w1_plain.items()))
        keys_ok &= max(w1_plain.values()) <= 1e-5

        # 15a at sp2 x mp2: the kernels swapped for their plain versions in
        # the same sharded step; the sharded inference forward
        rs = ranks["sp2mp2"]
        swap_ok = True
        for r, got in enumerate(rs):
            sw = got["swapped"]
            k_counts, k_peak = sw["kernels"]
            for what, (loss, leaf, worst, median, counts, peak) in (
                    (k, v) for k, v in sw.items() if k != "kernels"):
                if r == 0:
                    log(f"15a [{smi}]: sp2 x mp2 f32 step, {what} against "
                        f"the kernels (rank 0): loss terms worst rel err "
                        f"{loss:.3e}, pre-clip gradients worst leaf "
                        f"{leaf:.3e} ({worst}), median leaf {median:.3e}; "
                        f"launches "
                        f"{ {k: v for k, v in counts.items() if v} }, peak "
                        f"{peak:.3f} GiB (the kernels' "
                        f"{ {k: v for k, v in k_counts.items() if v} }, "
                        f"{k_peak:.3f} GiB)")
                # K5/K6 swapped: the same forward, the leaves held at
                # phase 8's 1e-4. K2 and K3 swapped too: the forward moves
                # by their rounding (held above at 1e-5 on these inputs),
                # which can flip a ReLU input within rounding of 0 and move
                # every leaf upstream of it, so the worst leaf goes by
                # phase 8's card-vs-CPU 0.1 and the median leaf by 1e-4: a
                # forward moved at rounding moves it about 1e-5 (12a's
                # median), an error of a kernel on many rows far more
                same_forward = what == "K5/K6 plain"
                off = ("K5", "K6") if same_forward else (
                    "K2", "K3", "K5", "K6")
                swap_ok &= (loss <= 1e-4
                            and leaf <= (1e-4 if same_forward else 0.1)
                            and median <= 1e-4
                            and not any(counts[k] for k in off)
                            and all(k_counts[k] for k in off))
        (outs, counts), (plain_outs, plain_counts) = rs[0]["infer"]
        w1_outs, w1_counts = w1_infer
        vs_w1 = {k: rel_err(v, w1_outs[k]) for k, v in outs.items()}
        vs_plain = {k: rel_err(v, plain_outs[k]) for k, v in outs.items()}
        same = all(torch.equal(v, r["infer"][0][0][k]) for r in rs[1:]
                   for k, v in outs.items())
        log(f"15a [{smi}]: sp2 x mp2 f32 inference (fold=True) at "
            f"{E2E_CANVAS}: against world 1 " + ", ".join(
                f"{k} {e:.3e}" for k, e in vs_w1.items())
            + "; against K9, K3 and K4 swapped for their plain versions "
            + ", ".join(f"{k} {e:.3e}" for k, e in vs_plain.items())
            + f"; every rank's outputs bitwise equal {same}; launches a "
            f"rank { {k: v for k, v in counts.items() if v} } (world 1 "
            f"{ {k: v for k, v in w1_counts.items() if v} }, plain "
            f"{ {k: v for k, v in plain_counts.items() if v} })")
        infer_ok = (sorted(outs) == sorted(w1_outs) and len(outs) > 0
                    and max(vs_w1.values()) <= 1e-4
                    and max(vs_plain.values()) <= 1e-4 and same
                    and counts["K9"] > 0 and counts["K4"] == 1
                    and counts == w1_counts
                    and not any(plain_counts[k]
                                for k in ("K9", "K3", "K4")))
        if not (keys_ok and swap_ok and infer_ok):
            raise AssertionError(
                f"15a: a sharded update departs from world 1 ({keys_ok}) or "
                f"from its plain kernels ({swap_ok}), or the sharded "
                f"inference from world 1 or its plain kernels ({infer_ok})")

        # 15d; the sampling kernels are held against their plain versions
        # on the inputs the update gave them, H1 (the matcher's solve, whole
        # on every rank) in phase 3d
        ok_15d = True
        for what, w_params, (w_stats, w_whole, w_counts) in (
                ("BoxeR-3D", w3, want_3d), ("DETR", wd, want_detr)):
            rs = [r["3d" if what == "BoxeR-3D" else "detr"]
                  for r in ranks["mp2"]]
            stat_err, leaf, worst, equal = held_by_12a(
                rs[0][0], w_stats, w_whole, w_params, [r[1] for r in rs])
            plain = {k: max(r[3][k] for r in rs) for k in rs[0][3]}
            log(f"15d [{smi}]: {what} f32 update at mp2 vs world 1: stats "
                f"worst rel err {stat_err:.3e}, worst leaf {leaf:.3e} "
                f"({worst}), ranks bitwise {equal}, launches a rank "
                f"{[{k: v for k, v in r[2].items() if v} for r in rs]} "
                f"(world 1 { {k: v for k, v in w_counts.items() if v} }); "
                f"each kernel against its plain version on its inputs: "
                + ", ".join(f"{k} {e:.3e}" for k, e in plain.items()))
            ok_15d &= (stat_err <= 1e-4 and leaf <= 0.1 and equal
                       and all(r[2] == w_counts for r in rs)
                       and {k.split()[0] for k in plain} == {
                           k for k, v in w_counts.items() if v and k != "H1"}
                       and max(plain.values(), default=0.0) <= 1e-5)
        log(f"15d [{smi}]: distributed.sp=2 refused: "
            + "; ".join(f"{k}: {v}" for k, v in refused.items()))
        if not ok_15d:
            raise AssertionError("15d: BoxeR-3D or DETR at mp2 departs from "
                                 "world 1")

        # 15c: world 1, one image, 2 bf16 updates from the loader
        trainer, rec, w1_run, w1_peak, _ = dp_train(
            lambda: trainer_on_card(root, MP_CUTS + [
                f"training.save_dir={root}/w1"]),
            "segm bf16 world 1", TRAIN_LAUNCHES[True], False)
        w1_ms = [u["ms"] for u in rec["updates"]]
        del trainer, rec
        torch.cuda.empty_cache()
        peaks = {"world 1": [w1_peak[0]]}
        for name, rs in ranks.items():
            peaks[name] = [r["peak"][0] for r in rs]
            coll = rs[0]["collectives"]
            log(f"15c [{smi}]: {name} bf16 at 1344x1344, one image: ms per "
                f"update (rank 0) {', '.join(f'{t:.2f}' for t in rs[0]['ms'])}"
                f" (world 1 {', '.join(f'{t:.2f}' for t in w1_ms)}); peak GiB "
                f"a rank {[round(p, 3) for p in peaks[name]]} (world 1 "
                f"{w1_peak[0]:.3f}); rank 0's collectives an update (calls, "
                f"MiB, ms; gloo stages CUDA tensors through the host: no "
                f"NVLink number): " + "; ".join(
                    f"{k} {c[0] / 2:g}, {c[1] / 2 ** 21:.2f}, {c[2] / 2:.1f}"
                    for k, c in sorted(coll.items()))
                + f"; launches a rank {[r['counts'] for r in rs][:1]}; "
                f"ranks {t_ranks[name]:.1f} s")

        # 15b: the sp2 x mp2 checkpoint of update 2 resumed at world 1
        rs = ranks["sp2mp2"]
        os.makedirs(root / "w1_resume/checkpoints")
        shutil.copy(root / "sp2mp2/checkpoints/model_2.pth",
                    root / "w1_resume/checkpoints")
        saved = torch.load(root / "w1_resume/checkpoints/model_2.pth",
                           map_location="cpu", weights_only=True)
        one = trainer_on_card(root, MP_CUTS + [
            "training.max_update=3", "training.resume=true",
            f"training.save_dir={root}/w1_resume"])
        model_ok = all(torch.equal(v.cpu(), saved["model"][k]) for k, v in
                       one.state.model.state_dict().items())
        opt = one.state.optimizer.state_dict()
        opt_ok = sorted(opt["state"]) == sorted(saved["optimizer"]["state"]) \
            and all(torch.equal(v.cpu(), saved["optimizer"]["state"][i][k])
                    for i, s in opt["state"].items() for k, v in s.items()
                    if torch.is_tensor(v))
        step = one.state.step
        rec = record_steps(one, lambda i, u: None)
        one.train()
        after = rec["updates"][0]["stats"]
        log(f"15b [{smi}]: sp2 x mp2, 2 bf16 updates from the loader with a "
            f"checkpoint at update 2: each rank's gathered model equal to "
            f"the checkpoint's {[r['ckpt_model'] for r in rs]}, rank 0's "
            f"gathered optimizer state {rs[0]['ckpt_opt']}; resumed at world "
            f"1 at step {step}: model bitwise {model_ok},"
            f" optimizer state bitwise {opt_ok}; one more update: "
            f"{rec['updates'][0]['ms']:.2f} ms, total_loss "
            f"{after['total_loss']:.5g}, step after {one.state.step}")
        if not (model_ok and opt_ok and step == 2 and one.state.step == 3
                and all(r["ckpt_model"] and r["ckpt_opt"] for r in rs)
                and after["skipped"] == 0.0
                and np.isfinite(after["total_loss"])):
            raise AssertionError("15b: the sp2 x mp2 checkpoint at world 1")
        del one, rec, saved
        torch.cuda.empty_cache()
        runs = {f"{name} segm rank {r}": ranks[name][r]["counts"]
                for name in ranks for r in range(len(ranks[name]))}
        runs.update({f"mp2 3d rank {r}": ranks["mp2"][r]["3d"][2]
                     for r in range(2)})
    return runs, dict(peaks=peaks, w1_ms=w1_ms, t_ranks=t_ranks,
                      ms={n: rs[0]["ms"] for n, rs in ranks.items()},
                      collectives={n: rs[0]["collectives"]
                                   for n, rs in ranks.items()})


def main():
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card (torch.cuda.is_available()"
                         " is false); the port has no CPU path here")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build (the package comes from this checkout)
    sys.path.insert(0, str(ROOT))
    from boxer_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"build: {lib_path.relative_to(ROOT)} in {time.perf_counter() - t0:.1f}"
        f" s (torch {torch.__version__}, CUDA {torch.version.cuda})")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  ptxas:", line.strip())

    # 3. kernels against their plain versions (3b: K5, K6; 3c: K7a, K7b, K8)
    kern = check_kernels(dev)
    # 3c. the combine shootout (T1-T3) and the folded op's gradients
    from boxer_tpu_torch.tools import bench_combine

    shootout = bench_combine.run(dev, log=log)
    box_attention_grads(dev)
    # 3d. the matcher's solve (H1) at the shipped matching calls
    t3d = time.perf_counter()
    assign = check_assignment(dev, smi)
    log(f"phase 3d took {time.perf_counter() - t3d:.1f} s")

    # 4. the inference slice at full width (4c: removed)
    runs = {}
    segm_fps, runs["segm"] = run_slice(dev, True, SEGM_ITERS,
                                       f"segm R50 {CANVAS} bf16 [{smi}]")
    det_fps, runs["det"] = run_slice(dev, False, DET_ITERS,
                                     f"detection R50 {CANVAS} bf16 [{smi}]")

    # 5. card against CPU
    card_vs_cpu(dev)

    # 6. where the device time of a forward goes
    profile_forward(dev, 1e3 / segm_fps)

    # 7. the training slice at full width; 7c. the detection step folded
    segm_ms, segm_peak, runs["segm train"], segm_busy = run_train(
        dev, True, f"segm train R50 {CANVAS} bf16 autocast [{smi}]",
        profiled=True)
    det_ms, det_peak, runs["det train"], _ = run_train(
        dev, False, f"detection train R50 {CANVAS} bf16 autocast [{smi}]")
    with sampling(FOLD_TAP_THRESHOLD=0):
        fold_ms, fold_peak, runs["det train folded"], fold_busy = run_train(
            dev, False, f"detection train R50 {CANVAS} bf16 autocast, folded "
            f"[{smi}]", profiled=True, per_step=FOLDED_TRAIN_LAUNCHES,
            falling=True)

    # 7d. K5 and K7b on the model's own indices
    k5_in_model(dev)
    k7b_in_model(dev)

    # 8. one train step, card against CPU; 8c. folded against per-tap
    train_card_vs_cpu(dev)
    train_folded_vs_pertap(dev)

    # 9. BoxeR-3D inference at full width and a served frame; 9b. card
    # against CPU; 9c. its train step at full width; 9d. one f32 step, card
    # against CPU
    t9 = time.perf_counter()
    fps_3d, runs["3d"], infer_3d = run_3d_inference(dev, smi)
    card_vs_cpu_3d(dev)
    ms_3d, peak_3d, runs["3d train"], train_3d = run_train_3d(dev, smi)
    train_card_vs_cpu_3d(dev)
    log(f"phases 9-9d took {time.perf_counter() - t9:.1f} s")

    # 10. the trainer: the shipped segm config at full width, from a COCO
    # directory through the loader, checkpoint, resume and COCO eval
    t10 = time.perf_counter()
    runs["trainer"], trainer_run = run_trainer(dev, smi)
    log(f"phase 10 took {time.perf_counter() - t10:.1f} s")

    # 11. the Waymo trainer: the shipped BoxeR-3D config at full width, from
    # a Waymo frame directory through the loader (GT-database sampler, 3D
    # augmentations, voxelizer), checkpoint, resume and the offline metrics
    t11 = time.perf_counter()
    runs["trainer 3d"], trainer_3d = run_trainer_3d(dev, smi)
    log(f"phase 11 took {time.perf_counter() - t11:.1f} s")

    # 12. data parallel: two ranks sharing the card over gloo (the segm and
    # Waymo configs, ZeRO-1 checkpoints and resumes), NCCL in a group of one
    t12 = time.perf_counter()
    dp_runs, dp = run_data_parallel(dev, smi, trainer_run["ms"])
    runs.update(dp_runs)
    log(f"phase 12 took {time.perf_counter() - t12:.1f} s")

    # 13. dropout and remat on the segm step and trainer; DETR through the
    # trainer from its shipped config, and card against CPU
    t13 = time.perf_counter()
    p13_runs, p13 = run_phase13(dev, smi)
    runs.update(p13_runs)
    log(f"phase 13 took {time.perf_counter() - t13:.1f} s")

    # 14. the analytic box-attention backward (K2, K5) against the default
    # one, op and model level; the native runtime against numpy; the tools
    t14 = time.perf_counter()
    p14_runs, p14 = run_phase14(dev, smi)
    runs.update(p14_runs)
    log(f"phase 14 took {time.perf_counter() - t14:.1f} s")

    # 15. tensor and sequence parallelism: mp2, sp2 and sp2 x mp2 through
    # the trainer against world 1 (ranks sharing the card over gloo),
    # checkpoints across layouts, memory and collectives a rank
    t15 = time.perf_counter()
    p15_runs, p15 = run_model_parallel(dev, smi)
    runs.update(p15_runs)
    log(f"phase 15 took {time.perf_counter() - t15:.1f} s")

    # K7a has no caller in the package: its launches are those of its
    # op-level run in phase 3c; the T rows' those of the shootout
    qsr, sacc = "quad_sample_reduce.cu", "scatter_accum.cu"
    pallas = "boxer_tpu/ops/pallas/"
    rows = [("K1", "quad_sample_reduce_raw", qsr,
             pallas + "combine_reduce.py:123"),
            ("K2", "quad_sample_reduce_w4", qsr,
             pallas + "combine_reduce.py:264"),
            ("K3", "flash_attention", "flash_attention.cu",
             pallas + "flash_attention.py:69"),
            ("K4", "instance_sample_reduce", "instance_sample.cu",
             "boxer_tpu/ops/box_attention.py:639"),
            ("K5", "scatter_add_rows_weighted_dw4 (shared g)", sacc,
             pallas + "scatter_accum.py:330"),
            ("K6", "scatter_add_rows_weighted_dw4 (per-tap g)", sacc,
             pallas + "scatter_accum.py:401"),
            ("K7a", "scatter_add_rows", sacc, pallas + "scatter_accum.py:428"),
            ("K7b", "scatter_add_rows_pmajor", sacc,
             pallas + "scatter_accum.py:208"),
            ("K8", "quad_sample_reduce_mmajor", qsr,
             pallas + "combine_reduce.py:249"),
            ("K9", "box_sample_reduce", "box_sample.cu",
             pallas + "combine_reduce.py:123,264 with their feed in "
             "boxer_tpu/ops/box_attention.py:437"),
            ("K10", "pillar_features", "pillar_net.cu",
             "no pallas_call: the XLA pillar net of "
             "boxer_tpu/nn/point_pillar.py")]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = []
    for key, name, src, replaces in rows:
        r = kern[key]
        launches = (r["op_launches"] if key in ("K7a", "K8")
                    else sum(c[key] for c in runs.values()))
        kernels.append(dict(name=name, route="cuda",
                            source=f"boxer_tpu_torch/csrc/{src}",
                            replaces=replaces, launches=launches,
                            **{k: r[k] for k in keys}))
    # H1's row at the Waymo encoder's call, its largest
    kernels.append(dict(name="solve_assignment", route="cuda",
                        source="boxer_tpu_torch/csrc/hungarian.cu",
                        replaces="boxer_tpu/nn/matcher.py:33",
                        launches=sum(c["H1"] for c in runs.values()),
                        **{k: assign["Waymo encoder"][k] for k in keys}))
    for t, label, name, wrapper_src in (
            ("T1", "T1 f32 out", "quad_sample_reduce_mmajor", qsr),
            ("T2", "T2 onepass/early", "quad_sample_reduce_w4", qsr),
            ("T3", "T3 onepass_big", "quad_sample_reduce_w4", qsr)):
        variants = [r for r in shootout if r["label"].startswith(t + " ")]
        r = next(v for v in variants if v["label"] == label)
        kernels.append(dict(name=f"{t}: {name}", route="cuda",
                            source=f"boxer_tpu_torch/csrc/{wrapper_src}",
                            replaces=r["replaces"],
                            launches=sum(v["launches"] for v in variants),
                            **{k: r[k] for k in keys}))
    log(f"slices [{smi}]: segm {segm_fps:.3f} img/s, detection "
        f"{det_fps:.3f} img/s; train segm {segm_ms:.2f} ms/step (peak "
        f"{segm_peak:.2f} GiB, device busy {100 * segm_busy[1]:.1f}%), "
        f"train detection {det_ms:.2f} ms/step (peak {det_peak:.2f} GiB), "
        f"folded {fold_ms:.2f} ms/step (peak {fold_peak:.2f} GiB, device busy "
        f"{100 * fold_busy[1]:.1f}%)")
    log(f"BoxeR-3D [{smi}]: {fps_3d:.3f} frames/s at 468x468 (peak "
        f"{infer_3d['peak']:.2f} GiB, device busy {infer_3d['busy'][0]:.2f} "
        f"ms of {infer_3d['ms']:.2f}); train {ms_3d:.2f} ms/step at batch "
        f"{TRAIN_BATCH_3D} (peak {peak_3d:.2f} GiB, device busy "
        f"{train_3d['busy'][0]:.2f} ms)")
    log(f"trainer [{smi}]: {trainer_run['ms']:.2f} ms per update of 2 x 1 "
        f"images at 1344x1344 (median of updates 2-6; min "
        f"{min(trainer_run['times']):.2f}"
        f", max {max(trainer_run['times']):.2f}), peak "
        f"{trainer_run['peak']:.2f} GiB, device busy "
        f"{trainer_run['busy'][0]:.2f} ms of an update "
        f"({100 * trainer_run['busy'][1]:.1f}%), matcher syncs per update "
        f"{trainer_run['syncs']}")
    stages = trainer_3d["stages"]
    loader_ms = stages["collate (a batch of 2)"] + 2 * sum(
        v for k, v in stages.items() if not k.startswith("collate"))
    log(f"trainer 3D [{smi}]: {trainer_3d['ms']:.2f} ms per update of 2 "
        f"frames (median of updates 2-6; min {min(trainer_3d['times']):.2f}"
        f", max {max(trainer_3d['times']):.2f}), peak "
        f"{trainer_3d['peak']:.2f} GiB, device busy "
        f"{trainer_3d['busy'][0]:.2f} ms of an update "
        f"({100 * trainer_3d['busy'][1]:.1f}%), matcher syncs per update "
        f"{trainer_3d['syncs']}, K5 {trainer_3d['k5_ms']:.4f} device ms a "
        f"call in the update (phase 9c's random rows: "
        f"{train_3d['k5_ms']:.4f}), the matcher's cost matrices "
        f"{trainer_3d['cost_peak']:.2f} GiB at their peak, the loader's "
        f"host ms per batch "
        f"{loader_ms:.2f} one frame after another, val pass "
        f"{trainer_3d['val_s']:.1f} s")
    nccl = "bitwise" if dp["bitwise"] else f"{dp['nccl_err']:.3e} apart"
    log(f"data parallel [{smi}] (two ranks sharing the card over gloo; no "
        f"scaling number): world 2 vs world 1 stats {dp['stat_err']:.3e}, "
        f"worst leaf {dp['leaf_err']:.3e}; segm bf16 ms per update "
        f"{', '.join(f'{t:.2f}' for t in dp['ms'])}, Waymo "
        f"{', '.join(f'{t:.2f}' for t in dp['ms_3d'])}; gradient all-reduce "
        f"{dp['allreduce_bytes']} bytes in "
        f"{', '.join(f'{t:.2f}' for t in dp['allreduce_ms'])} ms; optimizer "
        f"state MiB a rank {[round(v, 2) for v in dp['state_mb']['zero1']]} "
        f"(replicated {dp['state_mb']['plain'][0]:.2f}); NCCL world 1 ms "
        f"per update {', '.join(f'{t:.2f}' for t in dp['nccl_ms'])}, "
        f"{nccl} from the no-group run (two no-group runs "
        f"{dp['noise']:.3e})")
    mem, detr = p13["memory"], p13["detr"]
    st = p13["step"]
    log(f"dropout, remat, DETR [{smi}]: segm step at dropout {DROPOUT} "
        f"remat on {st['on_ms']:.2f} ms, peak {st['on_peak']:.2f} GiB / off "
        f"{st['off_ms']:.2f} ms, peak {st['off_peak']:.2f} GiB (worst leaf "
        f"bf16 {st['worst']:.3e}, eager's own spread {st['spread']:.3e}, "
        f"f32 {st['worst_f32']:.3e}); segm trainer at microbatch 4 remat on "
        f"{mem[True]['ms']:.2f} ms per update, peak {mem[True]['peak']:.2f} "
        f"GiB, off {mem[False]['ms']:.2f} ms, peak {mem[False]['peak']:.2f} "
        f"GiB; DETR R50 {detr['ms']:.2f} ms per update of 2 images, peak "
        f"{detr['peak']:.2f} GiB, an inference forward's device busy "
        f"{detr['busy'][0]:.2f} ms, val AP {detr['ap'][0]:.4g}, card vs CPU "
        f"{detr['card_vs_cpu']}")
    op, st14, nat = p14["op"], p14["step"], p14["native"]
    log(f"analytic backward, native, tools [{smi}]: op backward ms analytic "
        f"/ default " + "; ".join(
            f"{k} {v['ms']:.4f} / {v['ms_default']:.4f}"
            for k, v in op.items())
        + f"; segm step ms analytic / default f32 "
        f"{st14['analytic f32']['ms']:.2f} / {st14['default f32']['ms']:.2f},"
        f" bf16 {st14['analytic bf16']['ms']:.2f} / "
        f"{st14['default bf16']['ms']:.2f} (worst leaf f32 "
        f"{st14['worst_f32']:.3e}, bf16 {st14['worst_bf16']:.3e} beside "
        f"{st14['spread']:.3e}); native / numpy host ms " + "; ".join(
            f"{k} {v['native_ms']:.3f} / {v['numpy_ms']:.3f}"
            for k, v in nat.items())
        + f"; analyze {p14['tools']['analyze']['speed']:.3f} img/s")
    log(f"model parallel [{smi}] (ranks sharing the card over gloo; no "
        f"scaling number): peak GiB a rank at one image " + "; ".join(
            f"{k} {[round(v, 3) for v in p]}" for k, p in p15["peaks"].items())
        + "; ms per update (rank 0) " + "; ".join(
            f"{k} {', '.join(f'{t:.2f}' for t in v)}"
            for k, v in dict(p15["ms"], **{"world 1": p15["w1_ms"]}).items()))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))

if __name__ == "__main__":
    main()
