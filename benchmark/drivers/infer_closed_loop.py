"""Closed-loop inference: one client hands the port a batch from host
memory, waits for its results on the host, and hands it the next.

Traffic parameters (the mix's file): `batch` samples a batch, `pool`
distinct batches drawn from the seed and served in turn, `warmup` batches
before the window, `trace_batches` batches profiled after it in a traced
run, twice (the device alone, then host and device), and `check`:
`batches` batches among the window's first `within`, and `samples` of
each, drawn from the seed, whose results the reference judges.

Metrics: `infer_samples_s`, the samples of every batch completed in the
window over the window's seconds; `infer_ms_p95`, the 95th percentile over
every batch of the time from handing the host batch to the port to its
results on the host; `peak_gib`, the allocator's peak over set-up and
window; per batch, the host's time in the forward call.
"""

import gc
import time

import numpy as np
import torch

from harness import hooks, stats, trace


def _checked(traffic: dict, seed: int):
    """{batch index: [sample indices]} that the reference judges."""
    chk = traffic["check"]
    rng = np.random.default_rng([seed % 2 ** 64, 7])
    at = rng.choice(chk["within"], chk["batches"], replace=False)
    return {int(i): sorted(int(j) for j in rng.choice(
        traffic["batch"], chk["samples"], replace=False)) for i in at}


def _batch(prog, host_batch, timing=None):
    """One batch through the port: copy in, forward, results out. Returns
    (host results, device outputs)."""
    with torch.profiler.record_function(trace.HOST_RANGES[0]):
        dev_batch = prog.to_device(host_batch)
    t = time.perf_counter()
    with torch.profiler.record_function(trace.HOST_RANGES[1]):
        out = prog.forward(dev_batch)
    if timing is not None:
        timing.append(time.perf_counter() - t)
    with torch.profiler.record_function(trace.HOST_RANGES[2]):
        host = prog.to_host(out)
    return host, out


def run(cell, family, seed: int, seconds: float, traced: bool, device,
        t_start: float, scratch) -> dict:
    traffic = cell.traffic
    prog = family.Program(cell.config, traffic, device, seed)
    pool = prog.inputs
    with torch.no_grad():
        for i in range(traffic["warmup"]):
            _batch(prog, pool[i % len(pool)])
        _sync(device)
        setup_s = time.perf_counter() - t_start

        checked = _checked(traffic, seed)
        records, latencies, dispatch = [], [], []
        n = 0
        # no collector pauses inside the window: what set-up made is frozen
        gc.collect()
        gc.freeze()
        gc.disable()
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            host, out = _batch(prog, pool[n % len(pool)], dispatch)
            z = time.perf_counter()
            latencies.append(z - a)
            if n in checked:
                records += prog.keep(n % len(pool), checked[n], host, out)
            n += 1
            if z - t0 >= seconds:
                break
        window_s = z - t0
        gc.enable()
        gc.unfreeze()

        ctx = {"samples": n * traffic["batch"], "window_s": window_s,
               "latencies": latencies, "dispatch": dispatch,
               "flops_per_sample": prog.flops_per_sample(), "trace": None,
               "device_trace": None}
        if traced:
            # the device alone, then the host's ranges and the device
            dev, calls, out_trace = {}, [], {}
            with trace.profiled(dev, scratch, host=False):
                for i in range(traffic["trace_batches"]):
                    _batch(prog, pool[(n + i) % len(pool)])
                _sync(device)
            with trace.profiled(out_trace, scratch):
                with hooks.sampling_ranges(calls):
                    with torch.profiler.record_function(trace.WINDOW):
                        for i in range(traffic["trace_batches"]):
                            _batch(prog, pool[(n + i) % len(pool)])
                        _sync(device)
            ctx["device_trace"] = dev["trace"]
            ctx["trace"] = out_trace["trace"]
            ctx["sampling_bytes"] = calls
    peak = _peak(device)
    missing = sorted(set(checked) - set(range(n)))
    prog.free()
    return {"setup_s": setup_s, "peak_bytes": peak, "ctx": ctx,
            "records": records, "missing": missing,
            "metrics": {
                "infer_samples_s": ctx["samples"] / window_s,
                "infer_ms_p95": stats.percentile(latencies, 95) * 1e3,
                "peak_gib": peak / 2 ** 30,
                "setup_s": setup_s},
            "attempted": n * traffic["batch"]}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0
