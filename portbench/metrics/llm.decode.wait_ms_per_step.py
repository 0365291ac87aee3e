"""The host's wait for the card in the language model's decode loop: the
program's ``llm.decode.wait`` spans (the read-backs of the finished
flags), over the steps run (``llm.decode.steps``), from the window's
traces.  Where the steps are bound by the card, this is about the card's
time a step, less the issue time."""
from portbench import spans


def value(ctx):
    trs = spans.traces(ctx)
    steps = spans.counter(trs, "llm.decode.steps")
    if not steps:
        return None
    return 1e3 * spans.seconds(trs, "llm.decode.wait") / steps
