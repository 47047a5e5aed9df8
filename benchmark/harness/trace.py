"""The device trace of a traced run: `torch.profiler` over a stretch of
batches, read back from its Chrome trace into kernel intervals, the
host's launch of each kernel, and the benchmark's own ranges. A profile of
the device alone records no host event and slows the host least; its
window runs from its first device operation's start to its last one's end.

The benchmark opens its ranges itself (`torch.profiler.record_function`),
around the calls it makes into the program and around the program's
sampling ops as `nn/attention.py` binds them; a kernel belongs to the range
that was open on the host when it was launched, found by the trace's
correlation ids.
"""

import bisect
import contextlib
import json
import os
from dataclasses import dataclass, field
from pathlib import Path

from harness import stats

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the host-side stretches of a batch that the idle gaps are named by
HOST_RANGES = ("bench.h2d", "bench.forward", "bench.d2h")
WINDOW = "bench.window"
NAME_CHARS = 120


@dataclass
class Trace:
    """Times in seconds on the trace's clock."""
    ops: list = field(default_factory=list)       # (name, start, end, corr)
    launches: dict = field(default_factory=dict)  # corr -> host launch time
    ranges: list = field(default_factory=list)    # (name, start, end)
    window: tuple = (0.0, 0.0)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        """Seconds of the window in which an operation ran on the device."""
        return stats.union_length([(s, e) for _, s, e, _ in self.ops],
                                  *self.window)

    def ops_in(self, name: str) -> list:
        """The device operations launched while a range `name` was open."""
        spans = sorted((s, e) for n, s, e in self.ranges if n == name)
        starts = [s for s, _ in spans]
        out = []
        for op in self.ops:
            t = self.launches.get(op[3])
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and spans[i][0] <= t <= spans[i][1]:
                out.append(op)
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps of the window by the benchmark range open on the host when
        each began."""
        by_name = {}
        for name, s, e, _ in self.ops:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        # kernel names carry whole template argument lists: keep their head
        ops = [(n if len(n) <= NAME_CHARS else n[:NAME_CHARS] + "...", t)
               for n, t in ops]
        host = sorted((s, e, n) for n, s, e in self.ranges
                      if n in HOST_RANGES)
        idle = []
        for s, e in stats.gaps([(a, b) for _, a, b, _ in self.ops],
                               *self.window):
            open_ = [n for a, b, n in host if a <= s < b]
            idle.append((open_[-1] if open_ else "bench.between_batches",
                         e - s))
        idle.sort(key=lambda kv: -kv[1])
        return {"device_ops": [[n, t] for n, t in ops],
                "idle_gaps": [[n, t] for n, t in idle[:top]]}


def parse(events) -> Trace:
    """A Trace from a Chrome trace's `traceEvents`."""
    tr = Trace()
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        s = float(ev["ts"]) * 1e-6
        e = s + float(ev.get("dur", 0.0)) * 1e-6
        corr = (ev.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            tr.ops.append((ev["name"], s, e, corr))
        elif cat in LAUNCH_CATS and corr is not None:
            tr.launches[corr] = s
        elif cat == "user_annotation":
            tr.ranges.append((ev["name"], s, e))
    windows = [(s, e) for n, s, e in tr.ranges if n == WINDOW]
    if windows:
        tr.window = (min(s for s, _ in windows), max(e for _, e in windows))
    elif tr.ops:
        tr.window = (min(s for _, s, _, _ in tr.ops),
                     max(e for _, _, e, _ in tr.ops))
    return tr


@contextlib.contextmanager
def profiled(out: dict, scratch: Path, host: bool = True):
    """Profile the body, the host's events too with `host`, else the
    device alone; `out["trace"]` is its Trace afterwards. The Chrome trace
    goes through `scratch` and is deleted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    # without a card (the CPU tests) the host's events are all there is
    host = host or not torch.cuda.is_available()
    prof = profile(activities=[ProfilerActivity.CPU] * host
                   + [ProfilerActivity.CUDA])
    prof.start()
    try:
        yield
    finally:
        prof.stop()
    scratch.mkdir(parents=True, exist_ok=True)
    path = scratch / "trace.json"
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as f:
            out["trace"] = parse(json.load(f)["traceEvents"])
    finally:
        os.unlink(path)
