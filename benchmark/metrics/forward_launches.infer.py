"""forward_launches.infer: device operations (kernels, copies, memsets) a
batch that the host launched inside the port's `boxer.forward` span, over
the traced stretch with host events (`harness/spans.py`)."""

from harness import spans


def read(ctx):
    return spans.launches(ctx["trace"])
