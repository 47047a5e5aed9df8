"""decoder_ms.infer: device ms a batch of the operations the host launched
inside the port's `boxer.proposals` and `boxer.decoder` spans (top-k
proposal selection and every decoder layer, K4's call in the last one
included), over the traced stretch with host events (`harness/spans.py`)."""

from harness import spans


def read(ctx):
    return spans.device_ms(ctx["trace"], "boxer.proposals",
                           "boxer.decoder")
