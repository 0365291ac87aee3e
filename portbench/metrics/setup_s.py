"""Seconds from the process's start to the first timed item: imports,
weights, the Transcriber, the traffic, and the warm-up at the cell's own
shapes."""


def value(ctx):
    return ctx["setup_s"]
