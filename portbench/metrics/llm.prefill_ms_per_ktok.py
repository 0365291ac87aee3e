"""The language model's prefill: the program's ``llm.prefill`` spans (the
shared prefixes in chunks, then each row's own prompt; each span ends on
the read-back that follows its first tokens, so it holds their device
time), in ms a thousand prompt tokens (``llm.prefill_tokens``), from the
window's traces."""
from portbench import spans


def value(ctx):
    trs = spans.traces(ctx)
    tokens = spans.counter(trs, "llm.prefill_tokens")
    if not tokens:
        return None
    return 1e6 * spans.seconds(trs, "llm.prefill") / tokens
