"""Windowed metric smoothing; copy of `boxer_tpu/utils/meter.py`.

Parity: reference `e2edet/utils/meter.py` — SmoothedValue (:14-57) windowed
median/avg/global-avg and Meter (:60-121) dict-of-SmoothedValues with
delimiter-joined summaries.
"""

from collections import defaultdict, deque
from typing import Dict


class SmoothedValue:
    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        if not d:
            return 0.0
        n = len(d)
        return d[n // 2] if n % 2 else (d[n // 2 - 1] + d[n // 2]) / 2

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / self.count if self.count else 0.0

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value)


class Meter:
    def __init__(self, delimiter: str = ", "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, update_dict: Dict):
        for k, v in update_dict.items():
            self.meters[k].update(float(v))

    def get_scalar_dict(self) -> Dict[str, float]:
        return {k: v.global_avg for k, v in self.meters.items()}

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items())

    def reset(self):
        self.meters.clear()
