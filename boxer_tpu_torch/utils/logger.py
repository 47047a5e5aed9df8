"""Logging + TensorBoard-style scalar export; port of
`boxer_tpu/utils/logger.py`.

Parity: reference `e2edet/utils/logger.py` — master-gated file+stdout logger
with json/simple formats (:21-127) and scalar summary writer (:130-169).
Non-master print suppression (reference `distributed.py:327-351`) gates on
the torch.distributed rank (`parallel/distributed.py:is_master`; rank 0
without a process group).

TensorBoard protobufs aren't available in this image; `ScalarWriter` writes
JSONL scalars (one {"step", "tag", "value"} per line) which TensorBoard's
JSONL importers or any plotting tool can consume.
"""

import json
import logging
import os
import sys
import time
from typing import Dict, Optional

from boxer_tpu_torch.parallel.distributed import is_master


class Logger:
    def __init__(self, save_dir: Optional[str] = None, name: str = "boxer_tpu_torch",
                 level: str = "info", log_format: str = "simple"):
        self.logger = logging.getLogger(name)
        self.logger.setLevel(getattr(logging, level.upper(), logging.INFO))
        self.logger.propagate = False
        self._master = is_master()
        self.log_format = log_format

        if self._master and not self.logger.handlers:
            fmt = (
                logging.Formatter("%(message)s") if log_format == "json"
                else logging.Formatter(
                    "%(asctime)s %(levelname)s: %(message)s",
                    datefmt="%Y-%m-%dT%H:%M:%S")
            )
            sh = logging.StreamHandler(sys.stdout)
            sh.setFormatter(fmt)
            self.logger.addHandler(sh)
            if save_dir:
                os.makedirs(save_dir, exist_ok=True)
                fh = logging.FileHandler(
                    os.path.join(save_dir, f"train_{int(time.time())}.log"))
                fh.setFormatter(fmt)
                self.logger.addHandler(fh)
        logging.captureWarnings(True)

    def write(self, message, level: str = "info"):
        if not self._master:
            return
        if self.log_format == "json" and isinstance(message, dict):
            message = json.dumps(message)
        getattr(self.logger, level)(message)

    def info(self, message):
        self.write(message, "info")

    def debug(self, message):
        self.write(message, "debug")

    def warning(self, message):
        self.write(message, "warning")


class ScalarWriter:
    """Scalar sink: JSONL + TensorBoard event files
    (TensorboardLogger.add_scalars parity, reference `logger.py:130-169`)."""

    def __init__(self, save_dir: str):
        self.path = None
        self._tb = None
        if is_master():
            os.makedirs(save_dir, exist_ok=True)
            self.path = os.path.join(save_dir, "scalars.jsonl")
            self._f = open(self.path, "a")
            from boxer_tpu_torch.utils.tb_writer import TensorboardWriter

            self._tb = TensorboardWriter(os.path.join(save_dir, "tb"))

    def add_scalars(self, scalars: Dict[str, float], step: int):
        if self.path is None:
            return
        for tag, value in scalars.items():
            self._f.write(json.dumps(
                {"step": int(step), "tag": tag, "value": float(value)}) + "\n")
        self._f.flush()
        self._tb.add_scalars(scalars, step)

    def close(self):
        if self.path is not None:
            self._f.close()
        if self._tb is not None:
            self._tb.close()
