"""The host's time to issue a decode step: the program's ``decode.step``
spans less the ``decode.wait`` spans inside them (the step's one read-back
of the finished flags), over the steps run (``decode.steps``), from the
window's ``result["trace"]``."""
from portbench import spans


def value(ctx):
    trs = spans.traces(ctx)
    steps = spans.counter(trs, "decode.steps")
    if not steps:
        return None
    return 1e3 * (spans.seconds(trs, "decode.step") - spans.seconds(trs, "decode.wait")) / steps
