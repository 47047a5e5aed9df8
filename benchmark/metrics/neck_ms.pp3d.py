"""neck_ms.pp3d: device ms a batch of the operations the host launched
inside the port's `boxer.neck` span (the BEV ConvNet's convolutions,
GroupNorms and ReLUs), over the traced stretch with host events
(`harness/spans.py`)."""

from harness import spans


def read(ctx):
    return spans.device_ms(ctx["trace"], "boxer.neck")
