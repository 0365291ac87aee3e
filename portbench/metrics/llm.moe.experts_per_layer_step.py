"""Distinct routed experts a MoE layer reads in a decode step: the
program's ``llm.moe.experts_touched`` (summed on the device over the
steps and MoE layers; finished rows choose none) over the steps
(``llm.decode.steps``) times the configuration's MoE layers, from the
window's traces.  At 6 of 64 experts a row, 16 rows touch about 50 and
32 about 61."""
from portbench import llm_counts, spans


def value(ctx):
    trs = spans.traces(ctx)
    steps = spans.counter(trs, "llm.decode.steps")
    if not steps:
        return None
    return spans.counter(trs, "llm.moe.experts_touched") / (steps * llm_counts.moe_layers(ctx["cfg"]))
