"""The Transcriber's own time a window (trim, slab cut, seek repair,
segments): the transcribe calls' wall time minus the encode and decode
spans, over the windows decoded (grid and seek-repair rows)."""


def value(ctx):
    w = ctx["work"]
    if not w["windows"]:
        return None
    return 1e3 * (w["items_s"] - w["encode_s"] - w["decode_s"]) / w["windows"]
