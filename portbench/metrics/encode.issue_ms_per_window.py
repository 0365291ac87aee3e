"""The host's time in the frontend and encoder calls: the program's
``transcribe.encode`` spans (log-mel and the encoder layers enqueued; the
span ends before any device sync), over the real windows decoded
(``transcribe.windows``), from the window's ``result["trace"]``.

It reads issue time alone only while the launch queue has room.  Where
the encoder enqueues more than the queue holds, as whisper-large-v3-turbo
does (32 layers of 48-window slabs), the launches block until the card
drains it, and the span holds most of the encoder's device time too."""
from portbench import spans


def value(ctx):
    trs = spans.traces(ctx)
    windows = spans.counter(trs, "transcribe.windows")
    if not windows:
        return None
    return 1e3 * spans.seconds(trs, "transcribe.encode") / windows
