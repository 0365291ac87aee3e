"""The frontend and encoder span (log-mel, encoder, ending in a device
sync in the traced run), over the windows decoded."""


def value(ctx):
    w = ctx["work"]
    return 1e3 * w["encode_s"] / w["windows"] if w["windows"] else None
