"""The window's model FLOPs (encoder and decoder of the real windows,
``portbench.counts``) over its wall time at 989 TFLOP/s (bf16, dense), in %."""
from portbench import counts


def value(ctx):
    w = ctx["work"]
    if not w["wall_s"] or not w["flops"]:
        return None
    return 100.0 * w["flops"] / (w["wall_s"] * counts.PEAK_BF16_FLOPS)
