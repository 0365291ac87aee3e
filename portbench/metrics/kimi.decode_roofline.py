"""Kimi-Linear's decode steps' share of their roofline in the traced item:
the bytes they must read and write (every weight outside the routed
experts, the held experts some row chose, each valid latent-cache token of
the 7 MLA layers once, the active rows' KDA states and windows;
``portbench.kimi_counts``, from the program's ``llm.decode.steps``,
``llm.moe.experts_touched``, ``llm.decode.cache_tokens`` and
``llm.kda.state_bytes``) at 3.35 TB/s, over the steps' time on the card
(``llm.decode.card_us``), in %."""
from portbench import kimi_counts


def value(ctx):
    run = ctx.get("run")
    traced = getattr(run, "traced", None)
    if not traced:
        return None
    c = traced[0]["result"]["trace"]["counters"]
    card_s = c.get("llm.decode.card_us", 0) / 1e6
    if card_s <= 0 or not c.get("llm.decode.steps") or "llm.kda.state_bytes" not in c:
        return None
    need = kimi_counts.decode_bytes(ctx["cfg"], c["llm.decode.steps"],
                                    c.get("llm.moe.experts_touched", 0),
                                    c.get("llm.decode.cache_tokens", 0), c["llm.kda.state_bytes"])
    return 100.0 * need / kimi_counts.PEAK_BYTES_PER_S / card_s
