"""The decode loops' span (cache, prefill, steps, ending in a device sync
in the traced run), over the steps they ran."""


def value(ctx):
    w = ctx["work"]
    return 1e3 * w["decode_s"] / w["decode_steps"] if w["decode_steps"] else None
