"""``kda_chunk_state``'s share of its roofline over the traced item: the
least time its work needs (the tokens through the chunked form,
``llm.kda.prefill_tokens``, at its bytes over 3.35 TB/s or its products
over 989 TFLOP/s, whichever is larger; ``portbench.kimi_counts``) over
the profiler's time of its kernels, in %."""
from portbench import kimi_counts


def value(ctx):
    tr, run = ctx.get("trace"), ctx.get("run")
    traced = getattr(run, "traced", None)
    if tr is None or not traced:
        return None
    tokens = traced[0]["result"]["trace"]["counters"].get("llm.kda.prefill_tokens", 0)
    t = sum(v[0] for k, v in tr["kernels"].items() if "kda_chunk_state" in k)
    if t <= 0 or not tokens:
        return None
    return 100.0 * kimi_counts.chunk_state_bound_s(ctx["cfg"], tokens) / t
