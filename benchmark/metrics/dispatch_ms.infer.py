"""dispatch_ms.infer: the host's milliseconds from the forward call to its
return, before the results' copy, the mean over every batch of the
window: the enqueue that a device-paced forward hides."""


def read(ctx):
    if not ctx["dispatch"]:
        return None
    return 1e3 * sum(ctx["dispatch"]) / len(ctx["dispatch"])
