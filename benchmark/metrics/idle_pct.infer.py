"""idle_pct.infer: the share, in %, of a stretch of batches in which no
operation ran on the device, from a profile of the device alone (no host
events, so the host runs nearly as in the window): one minus the union of
its kernel, copy and memset intervals, overlapping operations counted
once, over the stretch from its first operation's start to its last one's
end."""


def read(ctx):
    tr = ctx["device_trace"]
    if tr is None or not tr.ops or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
