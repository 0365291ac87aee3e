"""Sums over the program's own trace of the window's items.

The port's Transcriber returns the trace of its request as
``result["trace"]`` (the port's ``runtime/trace.py``): each span name's
total and self seconds and count, and the counters.  The per-layer
metrics that read the program's spans sum them over the items finished in
the window.  A program without that trace, and a window with no items,
give no traces, and those metrics read None.
"""
from __future__ import annotations


def traces(ctx) -> list[dict]:
    """The trace of each item of the window, or [] where any lacks one."""
    items = getattr(ctx.get("run"), "items", None) or []
    found = [it["result"].get("trace") for it in items]
    return found if found and all(t is not None for t in found) else []


def seconds(trs: list[dict], name: str, key: str = "total_s") -> float:
    """Seconds of the span ``name`` (``total_s`` or ``self_s``) over the traces."""
    return sum(t["spans"].get(name, {}).get(key, 0.0) for t in trs)


def counter(trs: list[dict], name: str) -> int:
    return sum(t["counters"].get(name, 0) for t in trs)
