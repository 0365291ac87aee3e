"""Timestamp utilities: HH:MM:SS, filename dates, trim-time mapping.

A copy of the JAX package's ``utils/timestamps.py`` (TimeMap,
compose_intervals, format_timestamp, extract_date_from_filename and
parse_clip_timestamps): the port imports nothing from that package.
"""
from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field


def format_timestamp(seconds: float) -> str:
    """Seconds -> 'HH:MM:SS'."""
    s = max(0, int(round(seconds)))
    return f"{s // 3600:02d}:{(s % 3600) // 60:02d}:{s % 60:02d}"


_DATE_PATTERNS = (
    re.compile(r"REC_(\d{4})(\d{2})(\d{2})_\d{6}"),   # REC_YYYYMMDD_HHMMSS
    re.compile(r"\[(\d{4})-(\d{2})-(\d{2})\]"),        # [YYYY-MM-DD]
    re.compile(r"(\d{4})-(\d{2})-(\d{2})"),            # bare YYYY-MM-DD
)


def extract_date_from_filename(filename: str) -> str | None:
    """Pull a YYYY-MM-DD date out of a recording filename:
    REC_YYYYMMDD_HHMMSS, [YYYY-MM-DD] or a bare YYYY-MM-DD."""
    for pat in _DATE_PATTERNS:
        m = pat.search(filename)
        if m:
            y, mo, d = m.groups()
            if 1970 <= int(y) <= 2100 and 1 <= int(mo) <= 12 and 1 <= int(d) <= 31:
                return f"{y}-{mo}-{d}"
    return None


@dataclass
class TimeMap:
    """Maps times in a silence-trimmed signal back to the original timeline.

    Built from the kept_intervals returned by ops.frontend.trim_silence_host.
    Needed so transcript timestamps refer to the *original* recording even
    after silence removal shifted everything.
    """

    intervals: list[tuple[float, float]]
    _trimmed_starts: list[float] = field(default_factory=list, repr=False)

    def __post_init__(self):
        t = 0.0
        self._trimmed_starts = []
        for s, e in self.intervals:
            self._trimmed_starts.append(t)
            t += e - s
        self.trimmed_duration = t

    def to_original(self, t: float) -> float:
        """Trimmed-timeline seconds -> original-timeline seconds."""
        if not self.intervals:
            return t
        i = bisect.bisect_right(self._trimmed_starts, t) - 1
        i = max(0, min(i, len(self.intervals) - 1))
        s, e = self.intervals[i]
        return min(s + (t - self._trimmed_starts[i]), e)

    @classmethod
    def identity(cls, duration: float) -> "TimeMap":
        return cls([(0.0, duration)])


def compose_intervals(
    outer: "TimeMap", inner_intervals: list[tuple[float, float]]
) -> list[tuple[float, float]]:
    """Map kept-intervals expressed in OUTER's trimmed timeline back to the
    original timeline, splitting any interval that spans an outer-interval
    boundary (where to_original is discontinuous).

    Used to stack clip_timestamps with silence trimming: clips cut the
    original first, the trim then cuts the clipped signal, and segment
    timestamps must still come out in original-recording seconds.
    """
    out: list[tuple[float, float]] = []
    for s, e in inner_intervals:
        for j, (os_, oe) in enumerate(outer.intervals):
            ts = outer._trimmed_starts[j]
            te = ts + (oe - os_)
            a, b = max(s, ts), min(e, te)
            if b > a:
                out.append((os_ + (a - ts), os_ + (b - ts)))
    return out


def parse_clip_timestamps(spec: str, duration: float) -> list[tuple[float, float]]:
    """openai-whisper's --clip_timestamps string: comma-separated start,end
    pairs in seconds; a trailing lone start runs to the end.  Pairs pass
    through unclamped (``Transcriber.transcribe`` clamps them and raises
    when none selects audio); only pairs the user typed must not end
    before they start."""
    vals = [float(v) for v in spec.split(",") if v.strip() != ""]
    if not vals:
        return []
    lone_start = len(vals) % 2 == 1
    if lone_start:
        vals.append(max(duration, vals[-1]))
    clips = []
    for i, (s, e) in enumerate(zip(vals[0::2], vals[1::2])):
        user_pair = not (lone_start and i == len(vals) // 2 - 1)
        if user_pair and e < s:
            raise ValueError(f"clip end before start in {spec!r}: {s},{e}")
        clips.append((s, e))
    if clips != sorted(clips):
        raise ValueError(f"clip_timestamps must be sorted: {spec!r}")
    return clips
