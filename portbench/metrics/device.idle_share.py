"""The share of the traced item's wall time in which no kernel or copy
ran on the card, in %, from the profile that records the card's activity
alone (``portbench.trace``)."""


def value(ctx):
    tr = ctx["trace"]
    if tr is None or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
