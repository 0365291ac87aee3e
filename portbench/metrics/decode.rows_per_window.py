"""The rows the decode runs for each real window: the program's
``decode.rows`` (every slab row decoded, the slab's padding and the
fallback ladder's re-decodes included) over ``transcribe.windows`` (the
real windows of the grid and of the seek repair), from the window's
``result["trace"]``.  1.0 is a decode that pays for no padding and no
retry; the excess is the decode work the slab cut and the retries add."""
from portbench import spans


def value(ctx):
    trs = spans.traces(ctx)
    windows = spans.counter(trs, "transcribe.windows")
    if not windows:
        return None
    return spans.counter(trs, "decode.rows") / windows
