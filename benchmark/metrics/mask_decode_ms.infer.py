"""mask_decode_ms.infer: device ms a batch of the operations the host
launched inside the port's `boxer.mask_decode` span (the heads on all
queries, the top-k, the RoI tail, the mask head, paste and rescore), over
the traced stretch with host events (`harness/spans.py`)."""

from harness import spans


def read(ctx):
    return spans.device_ms(ctx["trace"], "boxer.mask_decode")
