"""pillars_ms.pp3d: device ms a batch of the operations the host launched
inside the port's `boxer.pillars` span (the pillar net's decoration, its
two layers and the BEV scatter), over the traced stretch with host events
(`harness/spans.py`)."""

from harness import spans


def read(ctx):
    return spans.device_ms(ctx["trace"], "boxer.pillars")
