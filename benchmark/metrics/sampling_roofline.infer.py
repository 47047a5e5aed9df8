"""sampling_roofline.infer: the box- and instance-attention sampling ops'
share, in %, of their byte roofline: the bytes each call must move (`counts`,
from its argument shapes) at 3.35 TB/s, summed over the traced calls, over
the summed device time of the operations launched inside the ranges the
benchmark opens around those calls (`harness/hooks.py`)."""

import counts
from harness import hooks


def read(ctx):
    tr, calls = ctx["trace"], ctx.get("sampling_bytes")
    if tr is None or not calls:
        return None
    ops = tr.ops_in(hooks.BOX_RANGE) + tr.ops_in(hooks.INSTANCE_RANGE)
    busy = sum(e - s for _, s, e, _ in ops)
    if busy <= 0:
        return None
    return 100.0 * sum(calls) / counts.HBM_BYTES_PER_S / busy
