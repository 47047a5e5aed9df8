"""Plain-dict registries.

The reference discovers plugins by auto-importing every file in a directory
(e.g. `e2edet/model/__init__.py:48-57`). Here a plain dict populated at import
time is simpler and import-order explicit. Copy of
`boxer_tpu/utils/registry.py`: the port's own registries.
"""

from typing import Callable, Dict, TypeVar

T = TypeVar("T")


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._registry: Dict[str, T] = {}

    def register(self, key: str) -> Callable[[T], T]:
        def deco(obj: T) -> T:
            if key in self._registry:
                raise ValueError(f"Duplicate {self.name} registration: {key}")
            self._registry[key] = obj
            return obj

        return deco

    def get(self, key: str) -> T:
        if key not in self._registry:
            raise KeyError(
                f"{self.name} '{key}' not found. Available: {sorted(self._registry)}"
            )
        return self._registry[key]

    def __contains__(self, key: str) -> bool:
        return key in self._registry

    def keys(self):
        return sorted(self._registry.keys())


MODEL_REGISTRY = Registry("model")
TRAINER_REGISTRY = Registry("trainer")
TASK_REGISTRY = Registry("task")
OPTIM_REGISTRY = Registry("optimizer")
SCHEDULER_REGISTRY = Registry("scheduler")
LOSS_REGISTRY = Registry("loss")
METRIC_REGISTRY = Registry("metric")
PROCESSOR_REGISTRY = Registry("processor")
