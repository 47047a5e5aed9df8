"""Wall-clock timing helpers; port of `boxer_tpu/utils/timer.py`.

Parity: reference `e2edet/utils/timer.py:12-74` (ms resolution, hh:mm:ss
formatting, ETA computation). Plus `span`, the named profiler ranges the
model and the train step open at their layer boundaries (`boxer.*`): they
land in a torch profiler's trace, on its clock, beside the kernels the
host launched inside them, and cost one check each while nothing profiles.
"""

import contextlib
import time

import torch

_profiling = torch._C._autograd._profiler_enabled
# the one context `span` hands out while no profiler runs: a
# `record_function` costs a dispatcher call even then
_OFF = contextlib.nullcontext()
# every span's name starts with it: a profiler also lists each span as a
# device-side annotation over the kernels it holds, which `device_events`
# leaves out
SPAN_PREFIX = "boxer."


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


def span(name: str):
    """A profiler range `name` (`torch.profiler.record_function`) while a
    torch profiler runs in this process, else a shared no-op context."""
    if _profiling():
        return torch.profiler.record_function(name)
    return _OFF


def device_events(prof):
    """The device's entries of a finished torch profiler's `key_averages()`:
    kernels, copies and memsets, without the spans' annotations."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith(SPAN_PREFIX)]
