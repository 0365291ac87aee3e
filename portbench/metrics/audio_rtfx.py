"""Audio seconds of every recording finished in the window, over the wall
time from the window's start to the last one's end."""


def value(ctx):
    w = ctx["work"]
    return w["audio_s"] / w["wall_s"] if w["wall_s"] > 0 else None
