"""The host's wait for the card in a decode step: the program's
``decode.wait`` spans (the step's one read-back of the finished flags),
over the steps run (``decode.steps``), from the window's
``result["trace"]``.  The first step's wait of each decode also holds the
device time of the work queued before it that no read-back has waited
for: the cache and prefill, and the encoder where nothing synchronised
after it (the traced run's probe does)."""
from portbench import spans


def value(ctx):
    trs = spans.traces(ctx)
    steps = spans.counter(trs, "decode.steps")
    if not steps:
        return None
    return 1e3 * spans.seconds(trs, "decode.wait") / steps
