"""encoder_ms.infer: device ms a batch of the operations the host launched
inside the port's `boxer.encoder` span (reference windows, flatten,
position concat and every encoder layer), over the traced stretch with
host events (`harness/spans.py`)."""

from harness import spans


def read(ctx):
    return spans.device_ms(ctx["trace"], "boxer.encoder")
