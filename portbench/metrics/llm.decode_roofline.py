"""The decode steps' share of their roofline in the traced item: the bytes
they must read (every weight outside the routed experts, the experts some
row chose, each valid latent-cache token once: ``portbench.llm_counts``,
from the program's ``llm.decode.steps``, ``llm.moe.experts_touched`` and
``llm.decode.cache_tokens``) at 3.35 TB/s, over the steps' time on the
card (``llm.decode.card_us``: CUDA events around the decode loops), in %."""
from portbench import llm_counts


def value(ctx):
    run = ctx.get("run")
    traced = getattr(run, "traced", None)
    if not traced:
        return None
    c = traced[0]["result"]["trace"]["counters"]
    card_s = c.get("llm.decode.card_us", 0) / 1e6
    if card_s <= 0 or not c.get("llm.decode.steps"):
        return None
    need = llm_counts.decode_bytes(ctx["cfg"], c["llm.decode.steps"],
                                   c.get("llm.moe.experts_touched", 0),
                                   c.get("llm.decode.cache_tokens", 0))
    return 100.0 * need / llm_counts.PEAK_BYTES_PER_S / card_s
