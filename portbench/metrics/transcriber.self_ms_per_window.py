"""The Transcriber's own host work a window: the self seconds of the
program's ingest, trim, slab cut, collect (the read-backs and the retry
ladder), seek repair and segments spans, over the real windows decoded
(``transcribe.windows``), from the window's ``result["trace"]``.  Self
seconds leave out the encode and decode spans nested in them."""
from portbench import spans

STAGES = ("transcribe.ingest", "transcribe.trim", "transcribe.slab_cut", "transcribe.collect",
          "transcribe.seek_repair", "transcribe.segments")


def value(ctx):
    trs = spans.traces(ctx)
    windows = spans.counter(trs, "transcribe.windows")
    if not windows:
        return None
    return 1e3 * sum(spans.seconds(trs, s, "self_s") for s in STAGES) / windows
