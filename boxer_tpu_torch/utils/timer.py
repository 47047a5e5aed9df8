"""Wall-clock timing helpers; port of `boxer_tpu/utils/timer.py`.

Parity: reference `e2edet/utils/timer.py:12-74` (ms resolution, hh:mm:ss
formatting, ETA computation). Plus a `phase` context manager used for the
trainer's debug-level phase profiling (reference `base_trainer.py:286-290`)
with a `torch.cuda.synchronize` fence for honest device timings.
"""

import contextlib
import time


class Timer:
    DEFAULT_TIME_FORMAT = "%m/%d/%Y %H:%M:%S"

    def __init__(self):
        self.start = time.time() * 1000

    def get_current(self) -> str:
        return self.get_time_hhmmss(self.start)

    def reset(self):
        self.start = time.time() * 1000

    def get_time_since_start(self, fmt=None) -> str:
        return self.get_time_hhmmss(self.start, format=fmt)

    def unix_time_since_start(self) -> float:
        return (time.time() * 1000 - self.start) / 1000.0

    def get_time_hhmmss(self, start=None, end=None, gap=None, format=None) -> str:
        if start is None and end is None:
            if format is None:
                format = self.DEFAULT_TIME_FORMAT
            return time.strftime(format)
        if end is None:
            end = time.time() * 1000
        if gap is None:
            gap = end - start
        secs = gap / 1000.0
        m, s = divmod(secs, 60)
        h, m = divmod(m, 60)
        return f"{int(h):02d}:{int(m):02d}:{int(s):02d}"


@contextlib.contextmanager
def phase_timer(store: dict, name: str, fence=None):
    """Accumulate wall-time of a phase; with `fence` (a tensor) wait for
    the card's queued work first, so the time includes device execution."""
    t0 = time.perf_counter()
    yield
    if fence is not None and fence.is_cuda:
        import torch

        torch.cuda.synchronize(fence.device)
    store[name] = store.get(name, 0.0) + (time.perf_counter() - t0)
