"""The host's time to issue a language-model decode step: the program's
``llm.decode.step`` spans (a CUDA-graph replay on the card) less the
``llm.decode.wait`` spans inside them (the finished flags, read every few
steps), over the steps run (``llm.decode.steps``), from the window's
traces."""
from portbench import spans


def value(ctx):
    trs = spans.traces(ctx)
    steps = spans.counter(trs, "llm.decode.steps")
    if not steps:
        return None
    return 1e3 * (spans.seconds(trs, "llm.decode.step") - spans.seconds(trs, "llm.decode.wait")) / steps
