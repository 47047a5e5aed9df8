"""backbone_ms.infer: device ms a batch of the operations the host launched
inside the port's `boxer.backbone` span (the ResNet, the input
projections, the extra levels, the position encodings), over the traced
stretch with host events (`harness/spans.py`)."""

from harness import spans


def read(ctx):
    return spans.device_ms(ctx["trace"], "boxer.backbone")
