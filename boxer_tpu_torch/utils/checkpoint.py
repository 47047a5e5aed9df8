"""Checkpoint save/resume (torch.save); port of
`boxer_tpu/utils/checkpoint.py`.

Parity: reference `e2edet/utils/checkpoint.py` — rolling saves of {model,
optimizer, update, epoch} (:160-192), latest-checkpoint resume (:112-140),
`finalize` weights-only export (:194-196), sanitized config companion
(:91-107).

Files under `save_dir`: `checkpoints/model_<update>.pth` holding {"model":
state_dict, "optimizer": state_dict, "step": completed updates, "extra":
the trainer's metadata}, the newest `num_checkpoint` kept; `model_final`,
the model's state_dict alone; `config.yaml`. In a process group every
rank calls `save` and `finalize` (a ZeRO-1 optimizer's state is gathered
over dp, the mp parts of the model and its moments over mp:
`parallel/sharding.py`), rank 0 writes, and the ranks meet at a barrier
after; every rank restores, cutting the whole state to its part. The
files do not depend on the layout: the whole model's own keys and a plain
optimizer's state_dict, so a checkpoint resumes at any (dp, sp, mp).
"""

import os
import re
from typing import Any, Dict, Optional

import torch
import yaml

from boxer_tpu_torch.parallel.distributed import is_master, synchronize
from boxer_tpu_torch.parallel.mesh import Layout
from boxer_tpu_torch.parallel.sharding import (gather_state,
                                               load_optimizer_state,
                                               optimizer_state_dict,
                                               param_names, shard_state)

_CKPT_RE = re.compile(r"^model_(\d+)\.pth$")


class Checkpoint:
    def __init__(self, save_dir: str, num_checkpoint: int = 5,
                 device: Optional[torch.device] = None,
                 layout: Optional[Layout] = None):
        self.layout = layout or Layout()
        self.save_dir = os.path.abspath(save_dir)
        self.ckpt_dir = os.path.join(self.save_dir, "checkpoints")
        self.num_checkpoint = max(1, num_checkpoint)
        self.device = device
        os.makedirs(self.ckpt_dir, exist_ok=True)

    def path(self, update: int) -> str:
        return os.path.join(self.ckpt_dir, f"model_{update}.pth")

    def steps(self):
        """The updates of the checkpoints on disk, oldest first."""
        return sorted(int(m.group(1)) for m in map(
            _CKPT_RE.match, os.listdir(self.ckpt_dir)) if m)

    def save(self, state, update: int, extra: Optional[Dict[str, Any]] = None):
        """state: parallel.steps.TrainState; extra: plain metadata (epoch,
        position in the epoch...). Every rank calls it."""
        optimizer = optimizer_state_dict(
            state.optimizer, self.layout,
            param_names(state.model, state.optimizer))
        model = gather_state(state.model.state_dict(), self.layout)
        if is_master():
            _save(self.path(update), {
                "model": model, "optimizer": optimizer,
                "step": int(state.step), "extra": extra})
            for old in self.steps()[:-self.num_checkpoint]:
                os.remove(self.path(old))
        synchronize()

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, state, step: Optional[int] = None):
        """Load a checkpoint (the latest by default) into `state`'s model,
        optimizer and step, on the checkpoint's `device`. Returns (state,
        extra|None) or (None, None) if nothing is saved."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        ckpt = torch.load(self.path(step), map_location=self.device,
                          weights_only=True)
        state.model.load_state_dict(shard_state(ckpt["model"], self.layout))
        load_optimizer_state(state.optimizer, ckpt["optimizer"], self.layout,
                             param_names(state.model, state.optimizer))
        state.step = int(ckpt["step"])
        return state, ckpt.get("extra")

    def finalize(self, model: torch.nn.Module, name: str = "model_final"):
        """Weights-only export (reference `checkpoint.py:194-196`); every
        rank calls it."""
        path = os.path.join(self.save_dir, name)
        whole = gather_state(model.state_dict(), self.layout)
        if is_master():
            _save(path, whole)
        synchronize()
        return path

    def save_config(self, config):
        """Sanitized yaml companion (reference `checkpoint.py:91-107`)."""
        if not is_master():
            return
        path = os.path.join(self.save_dir, "config.yaml")
        data = config.to_dict() if hasattr(config, "to_dict") else dict(config)
        with open(path, "w") as f:
            yaml.safe_dump(data, f, default_flow_style=False)


def _save(path: str, obj):
    """torch.save through a temporary file, so a cut run leaves no torn
    checkpoint under the final name."""
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)
