"""tap_prep_ms.infer: device ms a batch of the operations the host launched
inside the port's `boxer.sampling.taps` spans (the p-major reorder of the
grids and weights, each level's quad-table rows, fractions and tap
weights), over the traced stretch with host events (`harness/spans.py`)."""

from harness import spans


def read(ctx):
    return spans.device_ms(ctx["trace"], "boxer.sampling.taps")
