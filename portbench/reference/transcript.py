"""The transcript's host rules, worked out again from their definitions:
the silence trim and its time map, the windows, the seek rewind of a
window whose text runs past its last closed segment, and segments from
timestamp tokens.

These decide which audio each decoded window holds and where a served
token's segment lands on the recording's timeline.  The check holds the
program's windows and segments to them.
"""
from __future__ import annotations

import bisect
import math

import numpy as np

SR = 16_000
HOP = 160
WINDOW = 30 * SR
TS_S = 0.02


# ---------------------------------------------------------------------------
# Silence trim: frames of 400 samples at hop 160 whose RMS lies within
# 40 dB of the loudest, dilated by 0.25 s; gaps of silence longer than 1 s
# are cut out, and a time map leads trimmed seconds back to the original
# ---------------------------------------------------------------------------

def keep_frames(audio: np.ndarray, threshold_db: float = -40.0, pad_s: float = 0.25) -> np.ndarray:
    """Per-hop keep flags.  A frame's energy is the sum of its five
    80-sample blocks' float32 squares, summed in float64."""
    n_frames = max(len(audio) // HOP, 1)
    x = np.pad(audio.astype(np.float32), (200, 200 + 400))
    blocks = (x[: (len(x) // 80) * 80] ** 2).reshape(-1, 80).sum(axis=1, dtype=np.float64)
    energy = sum(blocks[k: k + 2 * n_frames: 2] for k in range(5))
    db = 20.0 * np.log10(np.sqrt(energy / 400 + 1e-12) + 1e-12)
    keep = db > db.max() + threshold_db
    pad = int(pad_s * SR / HOP)
    if pad > 0:
        keep = np.convolve(keep.astype(np.float64), np.ones(2 * pad + 1), mode="same") > 0.5
    return keep


def trim(audio: np.ndarray, min_gap_s: float = 1.0):
    """(trimmed audio, kept (start_s, end_s) intervals).  Audio of 2 s or
    less, or with nothing kept, stays whole."""
    if len(audio) <= 2 * SR:
        return audio, [(0.0, len(audio) / SR)]
    idx = np.flatnonzero(keep_frames(audio))
    if idx.size == 0:
        return audio, [(0.0, len(audio) / SR)]
    gap = int(min_gap_s * SR / HOP)
    cut = np.flatnonzero(np.diff(idx) > gap)
    starts = np.concatenate([[idx[0]], idx[cut + 1]]) * HOP
    ends = np.minimum((np.concatenate([idx[cut], [idx[-1]]]) + 1) * HOP, len(audio))
    pieces = [audio[s:e] for s, e in zip(starts, ends)]
    return np.concatenate(pieces), [(s / SR, e / SR) for s, e in zip(starts, ends)]


class TimeMap:
    def __init__(self, intervals):
        self.intervals = list(intervals)
        self.starts, t = [], 0.0
        for s, e in self.intervals:
            self.starts.append(t)
            t += e - s

    def to_original(self, t: float) -> float:
        i = max(0, min(bisect.bisect_right(self.starts, t) - 1, len(self.intervals) - 1))
        s, e = self.intervals[i]
        return min(s + (t - self.starts[i]), e)


def to_i16(x: np.ndarray) -> np.ndarray:
    """The int16 samples a window carries to the card."""
    return np.clip(x * 32768.0, -32768, 32767).astype(np.int16)


def window(audio: np.ndarray, start: int) -> np.ndarray:
    out = np.zeros(WINDOW, np.int16)
    piece = audio[start:start + WINDOW]
    out[:len(piece)] = to_i16(piece)
    return out


def n_windows(audio: np.ndarray) -> int:
    return max(1, math.ceil(len(audio) / WINDOW))


def voting_rows(audio: np.ndarray, real: int) -> list[int]:
    """The leading windows whose language distributions are averaged: the
    first k (the largest power of two up to min(real, 8)) that are at or
    above -54 dBFS and within 20 dB of the loudest of them."""
    k = 1 << (max(1, min(real, 8)).bit_length() - 1)
    rms = np.array([np.sqrt(np.mean(np.square(audio[i * WINDOW:(i + 1) * WINDOW],
                                               dtype=np.float64)) + 1e-12) for i in range(k)])
    rows = np.flatnonzero((rms >= 2e-3) & (rms >= 0.1 * rms.max()))
    return list(rows) if rows.size else [int(rms.argmax())]


# ---------------------------------------------------------------------------
# Timestamp tokens: segments, and the seek rewind
# ---------------------------------------------------------------------------

def _toks(row, eot):
    return [int(t) for t in row if int(t) != eot]


def closed_pairs(row, st):
    """[(index of the opening ts, index of the closing ts)] in order."""
    out, cur = [], None
    for i, t in enumerate(int(x) for x in row):
        if t == st["eot"]:
            break
        if t >= st["timestamp_begin"]:
            if cur is None:
                cur = i
            else:
                out.append((cur, i))
                cur = None
    return out


def consumed(row, st) -> tuple[float, bool]:
    """Seconds of the window the decode consumed, and whether it rewinds:
    text after the last closed segment rewinds to that segment's end; a
    pair of timestamps at the very end rewinds to the first of them."""
    tb = st["timestamp_begin"]
    toks = _toks(row, st["eot"])
    if not toks:
        return 30.0, False
    if toks[-1] >= tb:
        if len(toks) >= 2 and toks[-2] >= tb:
            c = (toks[-2] - tb) * TS_S
            return (c, True) if 0.0 < c < 30.0 else (30.0, False)
        return 30.0, False
    pairs = closed_pairs(row, st)
    if not pairs or toks[-1] >= st["eot"]:
        return 30.0, False
    c = (int(row[pairs[-1][1]]) - tb) * TS_S
    return (c, True) if c > 0.0 else (30.0, False)


def truncate_after_last_pair(row, st):
    out = np.asarray(row).copy()
    pairs = closed_pairs(out, st)
    if pairs:
        out[pairs[-1][1] + 1:] = st["eot"]
    return out


def keep_pairs_starting_before(row, st, cut_s):
    """Closed segments that start before cut_s; (row, last kept end or None)."""
    out = np.asarray(row).copy()
    tb = st["timestamp_begin"]
    keep = [(a, b) for a, b in closed_pairs(out, st) if (int(out[a]) - tb) * TS_S < cut_s]
    if not keep:
        return np.full_like(out, st["eot"]), None
    out[keep[-1][1] + 1:] = st["eot"]
    return out, (int(out[keep[-1][1]]) - tb) * TS_S


def drop_segments_before(row, st, cut_s):
    """The row from its first segment that opens at or after cut_s."""
    out = np.asarray(row).copy()
    tb = st["timestamp_begin"]
    opening = True
    for i, t in enumerate(int(x) for x in out):
        if t == st["eot"]:
            break
        if t >= tb:
            if opening and (t - tb) * TS_S >= cut_s:
                res = np.full_like(out, st["eot"])
                res[:len(out) - i] = out[i:]
                return res
            opening = not opening
    return np.full_like(out, st["eot"])


def segments(rows, offsets, durations, st, decode) -> list[dict]:
    """Segments of every row: a closed pair of timestamps around non-empty
    text; text after the last pair ends at the window's audio."""
    tb, eot = st["timestamp_begin"], st["eot"]
    out = []
    for row, off, dur in zip(rows, offsets, durations):
        start, text, last_end = None, [], 0.0
        for t in _toks(row, eot):
            if t >= tb:
                ts = (t - tb) * TS_S
                if start is None:
                    start = ts
                else:
                    if decode(text).strip():
                        out.append({"start": off + start, "end": off + ts})
                    start, text, last_end = None, [], ts
            elif t < eot:
                if start is None:
                    start = last_end
                text.append(t)
        if text and decode(text).strip():
            end = min(max(float(dur), start + TS_S), max(30.0, start + TS_S))
            out.append({"start": off + start, "end": off + end})
    return out
