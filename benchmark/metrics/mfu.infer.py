"""mfu.infer: the forward's FLOPs (`counts`: what the shapes need,
whatever implements them) for every sample completed in the window, over
the window's seconds, as a share in % of one H100's dense bf16 peak (989
TFLOP/s at 700 W; the run prints the card's power limit beside it)."""

import counts


def read(ctx):
    if not ctx["samples"] or ctx["window_s"] <= 0:
        return None
    rate = ctx["flops_per_sample"] * ctx["samples"] / ctx["window_s"]
    return 100.0 * rate / counts.PEAK_FLOPS["bf16"]
