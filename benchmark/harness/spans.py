"""The port's own spans in a traced stretch with host events: the ranges
`boxer_tpu_torch/utils/timer.py:span` opens at the layer boundaries of the
forward (`boxer.forward`, `boxer.backbone`, `boxer.sampling.taps`, ...),
which land in the profiler's trace beside the benchmark's ranges.

A batch is one `boxer.forward` range. A device operation belongs to a span
when the host launched it while that span was open (`Trace.ops_in`); a
parent span's operations include its children's. The forward's idle time
is read from the profile of the device alone instead, which runs the same
batches (`idle_ms`). Every reader returns None where the trace has no
`boxer.forward` range (a program without the spans) or the forward launched
no device operation (a run without a card).
"""

import bisect

from harness import stats

FORWARD = "boxer.forward"


def _forward_ops(tr):
    """(batches, the device operations launched in them), or None."""
    if tr is None:
        return None
    batches = sum(1 for n, _, _ in tr.ranges if n == FORWARD)
    ops = tr.ops_in(FORWARD) if batches else []
    if not ops:
        return None
    return batches, ops


def device_ms(tr, *names):
    """Device ms a batch of the operations launched in any of `names`."""
    found = _forward_ops(tr)
    if found is None:
        return None
    batches = found[0]
    ops = {id(op): op for name in names for op in tr.ops_in(name)}
    return 1e3 * sum(e - s for _, s, e, _ in ops.values()) / batches


def launches(tr):
    """Device operations (kernels, copies, memsets) launched in the
    forward, a batch."""
    found = _forward_ops(tr)
    if found is None:
        return None
    batches, ops = found
    return len(ops) / batches


def idle_ms(tr, dev):
    """Device idle ms a batch inside the forward, from the profile of the
    device alone `dev`, where the host runs nearly as in the window: the
    gaps between the first and the last device operation a forward
    launched. The stretch with host events `tr` runs the same batches and
    says which operations those are, matched by their place in device
    order as far as both stretches name the same operations (a profile may
    lose its last records); None where no forward lies that far."""
    if _forward_ops(tr) is None or dev is None:
        return None
    host = sorted(tr.ops, key=lambda op: op[1:3])
    alone = sorted(dev.ops, key=lambda op: op[1:3])
    same = 0
    for a, b in zip(host, alone):
        if a[0] != b[0]:
            break
        same += 1
    forwards = sorted((s, e) for n, s, e in tr.ranges if n == FORWARD)
    starts = [s for s, _ in forwards]
    places = {}     # forward -> the places of the operations it launched
    for i, op in enumerate(host):
        t = tr.launches.get(op[3])
        k = -1 if t is None else bisect.bisect_right(starts, t) - 1
        if k >= 0 and t <= forwards[k][1]:
            places.setdefault(k, []).append(i)
    idle = []
    for at in places.values():
        if max(at) >= same:
            continue
        run = [(s, e) for _, s, e, _ in alone[min(at):max(at) + 1]]
        idle.append(sum(b - a for a, b in stats.gaps(
            run, run[0][0], max(e for _, e in run))))
    return 1e3 * sum(idle) / len(idle) if idle else None
