"""The window's model FLOPs (every row the language model generated: its
prompt, a shared transcript once, and its generated tokens; active
parameters and attention, ``portbench.llm_counts``) over the window's
wall time at 989 TFLOP/s (bf16, dense), in %."""
from portbench import llm_counts


def value(ctx):
    w = ctx["work"]
    if not w["wall_s"] or not w.get("flops"):
        return None
    return 100.0 * w["flops"] / (w["wall_s"] * llm_counts.PEAK_BF16_FLOPS)
