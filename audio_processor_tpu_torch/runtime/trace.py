"""Spans and counters of the port's requests, on the profiler's clock.

``request(request_id)`` opens a request's record in the calling context (a
contextvar: each thread, the ``/v1`` batch leader's included, keeps its
own); ``span(name)`` times a block of it (``perf_counter_ns``) under the
span that encloses it; ``count(name, n)`` adds to a counter.  A record sums
its spans by name as they close (total, self = total less the child spans,
count).  A request opened inside another (the Transcriber's inside a job)
takes that one's id unless given one, and hands its sums to it on close,
as children of the span open there; one opened with none around it adds
its ``v1.*`` names, which the server exports, to the process's totals.

With no request open and no profiler running, ``span`` returns one shared
no-op and ``count`` returns at once: one check, no allocation.  While a
``torch.profiler`` runs, each span also opens a ``record_function`` of its
name, so the program's stages lie in the profiler's timeline beside the
kernels they launch.  A profile of the host's ops shows them (kineto also
draws each over its kernels on the card's stream as a
``gpu_user_annotation``); a profile of the card's activity alone does not.
"""
from __future__ import annotations

import contextlib
import contextvars
import threading
from time import perf_counter_ns

from torch.autograd import profiler as _profiler

_current: contextvars.ContextVar = contextvars.ContextVar("aptpu_trace", default=None)


class Record:
    """One request's spans, summed by name, and its counters."""

    __slots__ = ("request_id", "spans", "counters", "_open", "_root_ns")

    def __init__(self, request_id=None):
        self.request_id = request_id
        self.spans: dict[str, list[int]] = {}  # name -> [total ns, self ns, count]
        self.counters: dict[str, int] = {}
        self._open: list[Span] = []  # the open spans, innermost last
        self._root_ns = 0  # the spans closed with none open around them

    def _adopt(self, inner: "Record") -> None:
        """Take a closed inner request's sums, under the span open here."""
        for name, (total, self_ns, n) in inner.spans.items():
            a = self.spans.setdefault(name, [0, 0, 0])
            a[0] += total
            a[1] += self_ns
            a[2] += n
        for name, n in inner.counters.items():
            self.counters[name] = self.counters.get(name, 0) + n
        if self._open:
            self._open[-1]._child_ns += inner._root_ns
        else:
            self._root_ns += inner._root_ns

    def summary(self) -> dict:
        """{"request_id", "spans": {name: {"total_s", "self_s", "count"}},
        "counters": {name: n}} over the closed spans."""
        return {"request_id": self.request_id,
                "spans": {name: {"total_s": t / 1e9, "self_s": s / 1e9, "count": n}
                          for name, (t, s, n) in self.spans.items()},
                "counters": dict(self.counters)}


class Span:
    """A timed block of the open request (``span`` makes one)."""

    __slots__ = ("name", "_rec", "_t0", "_child_ns", "_rf")

    def __init__(self, name: str, rec: Record | None):
        self.name, self._rec, self._rf = name, rec, None

    def __enter__(self) -> "Span":
        if _profiler._is_profiler_enabled:
            self._rf = _profiler.record_function(self.name)
            self._rf.__enter__()
        if self._rec is not None:
            self._child_ns = 0
            self._rec._open.append(self)
        self._t0 = perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        dt = perf_counter_ns() - self._t0
        rec = self._rec
        if rec is not None:
            stack = rec._open
            i = len(stack) - 1
            if stack[i] is not self:  # closed out of order: a stage span closed by hand
                i = stack.index(self)
            del stack[i]
            if i:
                stack[i - 1]._child_ns += dt
            else:
                rec._root_ns += dt
            a = rec.spans.get(self.name)
            if a is None:
                a = rec.spans[self.name] = [0, 0, 0]
            a[0] += dt
            a[1] += dt - self._child_ns
            a[2] += 1
        if self._rf is not None:
            self._rf.__exit__(None, None, None)


_IDLE = contextlib.nullcontext()  # the span of no request, outside any profile


def span(name: str):
    """``with span(name): ...`` times the block in the open request, and
    names it in a running profiler's timeline."""
    rec = _current.get()
    if rec is None and not _profiler._is_profiler_enabled:
        return _IDLE
    return Span(name, rec)


def count(name: str, n: int = 1) -> None:
    """Add n to the open request's counter ``name``."""
    rec = _current.get()
    if rec is not None:
        rec.counters[name] = rec.counters.get(name, 0) + n


def current() -> Record | None:
    """The open request's record, or None."""
    return _current.get()


class request:
    """``with request(request_id) as record: ...`` opens a request's
    record for the block."""

    __slots__ = ("record", "_request_id", "_token", "_outer")

    def __init__(self, request_id=None):
        self._request_id = request_id

    def __enter__(self) -> Record:
        outer = self._outer = _current.get()
        rid = self._request_id
        self.record = Record(outer.request_id if rid is None and outer is not None else rid)
        self._token = _current.set(self.record)
        return self.record

    def __exit__(self, *exc) -> None:
        _current.reset(self._token)
        if self._outer is not None:
            self._outer._adopt(self.record)
        else:
            _add_to_totals(self.record)


# the process's totals of the exported names, over the requests opened with
# none around them
_TOTALS_PREFIX = "v1."
_totals_lock = threading.Lock()
_total_spans: dict[str, list] = {}  # name -> [seconds, count]
_total_counters: dict[str, int] = {}


def _add_to_totals(rec: Record) -> None:
    spans = [(k, v) for k, v in rec.spans.items() if k.startswith(_TOTALS_PREFIX)]
    counters = [(k, n) for k, n in rec.counters.items() if k.startswith(_TOTALS_PREFIX)]
    if not (spans or counters):
        return
    with _totals_lock:
        for name, (ns, _, n) in spans:
            a = _total_spans.setdefault(name, [0.0, 0])
            a[0] += ns / 1e9
            a[1] += n
        for name, n in counters:
            _total_counters[name] = _total_counters.get(name, 0) + n


def totals() -> dict:
    """{"spans": {name: {"total_s", "count"}}, "counters": {name: n}} of the
    ``v1.*`` names over every finished outermost request of the process."""
    with _totals_lock:
        return {"spans": {k: {"total_s": s, "count": n} for k, (s, n) in _total_spans.items()},
                "counters": dict(_total_counters)}


def reset_totals() -> None:
    with _totals_lock:
        _total_spans.clear()
        _total_counters.clear()
