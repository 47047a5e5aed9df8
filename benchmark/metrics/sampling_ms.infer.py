"""sampling_ms.infer: device ms a batch of the operations the host launched
inside the port's sampling-op spans (`boxer.sampling.box`,
`boxer.sampling.instance`: quad tables, tap preparation and the combine
kernels K1, K2, K8 and K4), over the traced stretch with host events
(`harness/spans.py`)."""

from harness import spans


def read(ctx):
    return spans.device_ms(ctx["trace"], "boxer.sampling.box",
                           "boxer.sampling.instance")
