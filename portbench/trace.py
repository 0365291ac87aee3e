"""Device time from torch.profiler's traces of the traced item.

``profile(fn, host=False)`` runs fn under a profiler that records the
card's activity alone, which adds little to the host's time, and reduces
the trace to what the per-layer metrics read: the traced window's wall
seconds, the seconds in which some kernel or copy ran on the card (the
union of their intervals, so overlapping streams count once), and each
kernel name's summed time and count.  ``profile(fn, host=True)`` also
records the host's ops, which slows the host about twofold, and adds the
idle gaps between device intervals labelled by the innermost host op
running at their middle: that profile feeds only the breakdown.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

import torch


def _intervals(events, device: bool) -> list[tuple[int, int, str]]:
    from torch.autograd import DeviceType

    out = []
    for e in events:
        on_device = e.device_type() == DeviceType.CUDA
        if on_device == device and e.duration_ns() > 0:
            out.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    return sorted(out)


def union(iv: list[tuple[int, int, str]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for s, e, _ in iv:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def host_at(host: list[tuple[int, int, str]], starts: list[int], t: int) -> str:
    """The innermost host op running at t: the latest started of those
    that span it, among the 64 that started last before t."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - 64), -1):
        s, e, name = host[j]
        if e >= t:
            return name
    return "(between host ops)"


def profile(fn, host: bool = False) -> dict:
    """Run fn under the profiler; returns the reduced trace."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    activities = [ProfilerActivity.CPU] * host + [ProfilerActivity.CUDA]
    sync()
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    events = prof.profiler.kineto_results.events()
    dev = _intervals(events, device=True)
    busy = union(dev)
    by_name: dict[str, list] = defaultdict(lambda: [0.0, 0])
    for s, e, name in dev:
        by_name[name][0] += (e - s) / 1e9
        by_name[name][1] += 1
    idle: dict[str, float] = defaultdict(float)
    if host:
        host_ops = _intervals(events, device=False)
        starts = [h[0] for h in host_ops]
        for (_, e0), (s1, _) in zip(busy, busy[1:]):
            idle[host_at(host_ops, starts, (e0 + s1) // 2)] += (s1 - e0) / 1e9
    return {
        "window_s": wall,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "kernels": {k: tuple(v) for k, v in by_name.items()},
        "idle_by_host_op": dict(idle),
    }


@contextlib.contextmanager
def record_calls(module, name: str):
    """Within the block, every call of ``module.<name>`` appends its
    (args, kwargs) to the list it yields; the function is restored after."""
    fn = getattr(module, name)
    calls: list = []

    def wrapped(*args, **kw):
        calls.append((args, kw))
        return fn(*args, **kw)

    setattr(module, name, wrapped)
    try:
        yield calls
    finally:
        setattr(module, name, fn)
