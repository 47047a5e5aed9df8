"""forward_idle_ms.infer: device idle ms a batch inside the port's
`boxer.forward`, from the profile of the device alone, where the host runs
nearly as in the window: the gaps between the first and the last device
operation the forward launched, which the stretch with host events (the
same batches) names (`harness/spans.py`)."""

from harness import spans


def read(ctx):
    return spans.idle_ms(ctx["trace"], ctx["device_trace"])
