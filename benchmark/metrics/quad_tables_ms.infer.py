"""quad_tables_ms.infer: device ms a batch of the operations the host
launched inside the port's `boxer.sampling.quad_tables` span (the value's
permute, the zero pad and the `torch.cat` of each level's 2x2 tables),
over the traced stretch with host events (`harness/spans.py`)."""

from harness import spans


def read(ctx):
    return spans.device_ms(ctx["trace"], "boxer.sampling.quad_tables")
