"""The trainer (`base_trainer`) and its loops (`engine`); port of
`boxer_tpu/trainer/`."""

from boxer_tpu_torch.trainer.base_trainer import (  # noqa: F401
    BaseTrainer, build_trainer, register_trainer)
