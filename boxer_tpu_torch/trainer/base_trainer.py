"""Training orchestrator; port of `boxer_tpu/trainer/base_trainer.py`.

Parity target: reference `e2edet/trainer/base_trainer.py` (load →
device/logger/datasets/model/optimizer, train loop until max_update,
interval-driven checkpoint/eval, resume, inference), as the JAX package
restructures it around one train step. One process drives one device:
`cuda` (the default: the process's current card) or `cpu`, chosen by the
caller and never by fallback. In a `torch.distributed` process group
(`parallel/distributed.py:launch` or torchrun) every process is one rank
of the layout `distributed.{dp,sp,mp}` gives (`parallel/mesh.py`, as the
JAX trainer builds its mesh from them): the config's global `batch_size`
split evenly over dp, one seed drawn on rank 0, rank 0's weights cut to
this rank's part (`parallel/sharding.py:shard_model`, after the model is
built, where the JAX trainer declares sp), and, with `distributed.zero1`
(the default) at dp above 1, the optimizer state sharded over dp. Train,
eval and inference all run on the layout. Checkpoints hold the whole
model and optimizer state, so a run resumes at any layout. Without a
group the trainer runs alone, as it always has.
"""

import os
from typing import Dict

import torch

from boxer_tpu_torch.criterion.losses import build_loss
from boxer_tpu_torch.criterion.metrics import build_metrics
from boxer_tpu_torch.dataset import build_dataloader, build_dataset
from boxer_tpu_torch.models import build_model, check_seq_shard
from boxer_tpu_torch.optim import build_optimizer, build_schedule
from boxer_tpu_torch.parallel import distributed
from boxer_tpu_torch.parallel.mesh import create_layout
from boxer_tpu_torch.parallel.sharding import shard_model, zero1
from boxer_tpu_torch.parallel.steps import (TrainState, make_eval_step,
                                            make_inference_step,
                                            make_train_step)
from boxer_tpu_torch.utils.checkpoint import Checkpoint
from boxer_tpu_torch.utils.logger import Logger, ScalarWriter
from boxer_tpu_torch.utils.meter import Meter
from boxer_tpu_torch.utils.registry import TRAINER_REGISTRY
from boxer_tpu_torch.utils.timer import Timer


def register_trainer(name):
    return TRAINER_REGISTRY.register(name)


def build_trainer(configuration, device: str = "cuda"):
    """Parity: reference `trainer/__init__.py:8-26` (freezes config)."""
    config = configuration.get_config()
    trainer_cls = TRAINER_REGISTRY.get(config.training.get("trainer",
                                                           "base_trainer"))
    trainer = trainer_cls(configuration, device)
    configuration.freeze()
    return trainer


def resolve_device(device: str) -> torch.device:
    """`cuda` (the current card: a rank's own, set by its launcher) or
    `cpu`; `cuda` without a card raises: the port has no CPU fallback."""
    if device == "cpu":
        return torch.device("cpu")
    if device != "cuda":
        raise ValueError(f"device must be cuda or cpu, not {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "false; pass --device cpu to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def check_layout(config):
    """The run's layout (`parallel/mesh.py:create_layout`, its groups made
    here); ValueError when the model cannot take it (sp > 1 on a model
    without sequence parallelism) or this run's processes cannot hold
    it."""
    dist = config.get("distributed", {}) or {}
    if int(dist.get("sp", 1) or 1) > 1:
        check_seq_shard(config.model_config[config.get("model")])
    return create_layout(dist.get("dp"), dist.get("mp", 1),
                         dist.get("sp", 1))


@register_trainer("base_trainer")
class BaseTrainer:
    def __init__(self, configuration, device: str = "cuda"):
        self.configuration = configuration
        self.config = configuration.get_config()
        self.running_config = self.config.training
        self.layout = check_layout(self.config)
        self.device = resolve_device(device)
        self.rank = distributed.get_rank()
        self.world_size = distributed.get_world_size()
        self.current_update = 0
        self.current_epoch = 0
        # batches of current_epoch already consumed (the resume position)
        self.epoch_batches_done = 0
        self.meter = Meter()

    # ------------------------------------------------------------------
    def load(self):
        rc = self.running_config
        self.save_dir = rc.get("save_dir", "./save")
        self.logger = Logger(self.save_dir, level=rc.get("logger_level", "info"),
                             log_format=rc.get("log_format", "simple"))
        self.writer = (ScalarWriter(self.save_dir)
                       if rc.get("tensorboard") else None)
        self.timer = Timer()

        seed = rc.get("seed", -1)
        if seed is None or seed == -1:
            # drawn on rank 0: every rank must build the same weights and
            # the same sampler order
            seed = distributed.shared_random_seed(1, 100000)
        self.seed = int(seed)
        lay = self.layout
        self.logger.info(f"device: {self.device} seed={self.seed} ranks="
                         f"{self.world_size} (dp={lay.dp.size} "
                         f"sp={lay.sp.size} mp={lay.mp.size})")

        self.load_task()
        self.load_model_and_optimizer()
        self._init_intervals_and_checkpoint()

    # ------------------------------------------------------------------
    def load_task(self):
        run_type = self.running_config.get("run_type", "train_val_test")
        task_name = self.config.get("task")
        dataset_cfg = self.config.dataset_config[task_name]
        self.datasets: Dict[str, object] = {}
        self.loaders: Dict[str, object] = {}

        bs = int(self.running_config.get("batch_size", 16))
        ipu = int(self.running_config.get("iter_per_update", 1))
        workers = int(self.running_config.get("num_workers", 2))
        dp = self.layout.dp
        if bs % (dp.size * ipu):
            raise ValueError(
                f"training.batch_size {bs} (the global batch) does not "
                f"split into {dp.size} data shards x iter_per_update "
                f"{ipu} microbatches")
        # each data shard loads its share of the global batch (of a
        # BoxeR-3D update, bs // dp // ipu frames a microbatch: the JAX
        # trainer's static batch)
        bs //= dp.size
        for split in ("train", "val", "test"):
            if split not in run_type:
                continue
            ds = build_dataset(task_name, dataset_cfg, split)
            if ds is None:
                continue
            self.datasets[split] = ds
            self.loaders[split] = build_dataloader(
                ds, split, batch_size=bs, num_workers=workers,
                iter_per_update=ipu if split == "train" else 1,
                seed=self.seed, device=self.device, replicas=dp.size,
                rank=dp.index)
        if not self.datasets:
            raise RuntimeError("No datasets loaded")
        self.num_classes = self.datasets.get(
            "train", next(iter(self.datasets.values()))).get_answer_size()

    # ------------------------------------------------------------------
    def load_model_and_optimizer(self):
        rc = self.running_config
        model_cfg = self.config.model_config[self.config.get("model")]
        mixed = rc.get("mixed_precision", "bfloat16")
        self.compute_dtype = (torch.bfloat16 if mixed == "bfloat16"
                              else torch.float32)
        layout = self.layout
        model = build_model(model_cfg, self.num_classes,
                            seq_shard=layout.sp.size > 1).init_weights(
            self.seed)
        bb_cfg = model_cfg.get("backbone")
        ppath = bb_cfg["params"].get("pretrained_path") if bb_cfg else None
        if ppath and os.path.exists(ppath):
            load_pretrained_backbone(model, ppath)
            self.logger.info(f"Loaded pretrained backbone from {ppath}")
        model.to(self.device)
        if distributed.is_dist_avail_and_initialized():
            for t in model.state_dict().values():
                distributed.broadcast(t)
        shard_model(model, layout)
        self.criterion = build_loss(
            model_cfg["loss"], self.num_classes,
            int(rc.get("iter_per_update", 1)), dp=layout.dp)

        opt_cfg = self.config.get("optimizer", {}).to_dict()
        opt_cfg.setdefault("params", {})
        opt_cfg["params"]["deform_lr_multi"] = model_cfg.get(
            "deform_lr_multi", 1.0)
        base_lr = opt_cfg["params"].get("lr", 1e-4)
        sched_cfg = self.config.get("scheduler", {})
        schedule = None
        if sched_cfg and "type" in sched_cfg:
            sched_cfg = sched_cfg.to_dict()
            # epoch-clock schedulers (reference `lr_scheduler.py:108-144`)
            # need the epoch length in updates
            if "train" in self.loaders:
                sched_cfg.setdefault("params", {})["_steps_per_epoch"] = max(
                    1, len(self.loaders["train"]))
            schedule = build_schedule(sched_cfg, base_lr)
        optimizer = build_optimizer(opt_cfg, model)
        dist_cfg = self.config.get("distributed", {}) or {}
        if dist_cfg.get("zero1", True) and layout.dp.size > 1:
            optimizer = zero1(optimizer, layout.dp.group)
        self.state = TrainState(model, optimizer, schedule)

        self._train_step = make_train_step(
            self.criterion, max_norm=float(rc.get("max_norm", 0) or 0),
            compute_dtype=self.compute_dtype,
            metrics=build_metrics(model_cfg.get("metric")),
            # the dropout key's seed, as JAX's PRNGKey(seed + 7)
            # (`boxer_tpu/trainer/base_trainer.py:285`)
            dropout_seed=self.seed + 7, layout=layout)
        # the engine reads only the outputs of a val batch, so the eval step
        # computes no losses
        self._eval_step = make_eval_step(self.compute_dtype)
        self._inference_step = make_inference_step(self.compute_dtype)

        n_params = sum(p.numel() for p in model.parameters())
        self.logger.info(f"Model parameters: {n_params / 1e6:.1f}M on "
                         "this rank")

    # ------------------------------------------------------------------
    def _init_intervals_and_checkpoint(self):
        rc = self.running_config
        self.max_update = int(rc.get("max_update") or 0)
        max_epoch = rc.get("max_epoch")
        if "train" in self.loaders:
            updates_per_epoch = len(self.loaders["train"])
            if not updates_per_epoch:
                raise ValueError("the train split holds less than one batch")
            if max_epoch and not self.max_update:
                self.max_update = int(max_epoch * updates_per_epoch)
            # intervals in epoch-fractions (reference base_trainer.py:161-166)
            ci = rc.get("checkpoint_interval", 1000)
            ei = rc.get("evaluation_interval", 1000)
            self.checkpoint_interval = int(
                ci * updates_per_epoch if isinstance(ci, float) and ci <= 1
                else ci)
            self.evaluation_interval = int(
                ei * updates_per_epoch if isinstance(ei, float) and ei <= 1
                else ei)
        self.log_interval = int(rc.get("log_interval", 100))

        self.checkpoint = Checkpoint(
            self.save_dir, num_checkpoint=int(rc.get("num_checkpoint", 1)),
            device=self.device, layout=self.layout)
        self.checkpoint.save_config(self.config)

        if rc.get("resume") or rc.get("resume_file"):
            restored, extra = self.checkpoint.restore(self.state)
            if restored is not None:
                self.current_update = self.state.step
                self.current_epoch = int(extra["epoch"])
                self.epoch_batches_done = int(extra["epoch_batches"])
                draws = extra.get("draw_states")
                dp = self.layout.dp
                if "train" in self.loaders and draws is not None:
                    if len(draws) != dp.size:
                        raise ValueError(
                            f"the checkpoint holds the GT-database draws of "
                            f"{len(draws)} data shards; this run has "
                            f"{dp.size}: resume it at dp={len(draws)}")
                    self.loaders["train"].draw_state = {
                        name: (order.cpu(), idx)
                        for name, (order, idx) in draws[dp.index].items()}
                if ("train" in self.loaders and self.epoch_batches_done
                        >= len(self.loaders["train"])):
                    # saved on an epoch's last batch: resume at the next
                    self.current_epoch += 1
                    self.epoch_batches_done = 0
                self.logger.info(
                    f"Resumed from update {self.current_update}, epoch "
                    f"{self.current_epoch} (skipping "
                    f"{self.epoch_batches_done} batches)")

    def checkpoint_extra(self):
        """What a checkpoint records of the run's position: the mid-epoch
        skip on resume comes from it, not from the update count, so an
        update skipped on a non-finite gradient or a save on an epoch's
        last batch replays exactly (the global batch is fixed, so the
        position in updates holds at any world size); and, where the train
        loader draws from a GT database, each data shard's draws' state
        after the last batch taken, in dp order (from the shard's lead
        rank: its sp and mp ranks load the same batches). Every rank calls
        it."""
        extra = {"epoch": self.current_epoch, "update": self.current_update,
                 "epoch_batches": self.epoch_batches_done,
                 "world_size": self.world_size}
        train = self.loaders.get("train")
        draws = [d for lead, d in distributed.all_gather(
            (self.layout.leads_shard,
             None if train is None else train.draw_state)) if lead]
        if any(d is not None for d in draws):
            extra["draw_states"] = draws
        return extra

    # ------------------------------------------------------------------
    def train(self):
        from boxer_tpu_torch.trainer.engine import train_epoch

        if "train" not in self.loaders:
            return self.inference()
        self.logger.info(f"Starting training: max_update={self.max_update}")
        loader = self.loaders["train"]
        while self.current_update < self.max_update:
            loader.sampler.set_epoch(self.current_epoch)
            train_epoch(self)
            if self.epoch_batches_done >= len(loader):
                self.current_epoch += 1
                self.epoch_batches_done = 0
        self.finalize()

    def finalize(self):
        if "val" in self.loaders:
            self.evaluate("val")
        if "test" in self.loaders:
            self.inference()
        self.checkpoint.finalize(self.state.model)
        self.logger.info("Training finalized.")

    # ------------------------------------------------------------------
    def evaluate(self, split: str):
        from boxer_tpu_torch.trainer.engine import evaluate

        return evaluate(split, self)

    def inference(self):
        from boxer_tpu_torch.trainer.engine import evaluate

        if "test" in self.loaders:
            return evaluate("test", self)
        return None

    # ------------------------------------------------------------------
    def calculate_time_left(self, updates_done_window, window_seconds):
        if updates_done_window <= 0:
            return "n/a"
        ups = updates_done_window / max(window_seconds, 1e-6)
        remaining = max(self.max_update - self.current_update, 0)
        secs = remaining / max(ups, 1e-9)
        m, s = divmod(secs, 60)
        h, m = divmod(m, 60)
        return f"{int(h):02d}:{int(m):02d}:{int(s):02d}"


def load_pretrained_backbone(model, path: str):
    """A torchvision-named ResNet state dict (optionally under `state_dict`
    or `model`) into `model.backbone`; `fc.*` and `num_batches_tracked` are
    dropped, any other key the backbone lacks raises, as does a shape
    mismatch."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):
        if isinstance(obj.get(key), dict):
            obj = obj[key]
    sd = {k: v for k, v in obj.items()
          if not k.startswith("fc.") and not k.endswith("num_batches_tracked")}
    unexpected = model.backbone.load_state_dict(sd, strict=False).unexpected_keys
    if unexpected:
        raise ValueError(f"pretrained backbone {path}: keys the backbone "
                         f"lacks: {unexpected[:8]}")
