"""Dynamic time warping for word timestamps, over a batch of rows.

``dtw_starts`` takes a float32 cost (B, T, Ta) with each row's own (t, ta)
and returns (B, T) int64: for each of a row's t text rows, the audio
column where it starts (openai-whisper's DTW backtrace).  A row's
sub-rectangle of the padded batch is exactly its own DTW, since a cell
depends only on cells above and to the left.

On the card's path (``device`` a CUDA device) it calls the C++ function of
``csrc/dtw.cu`` on the host, built at first use; a failed build raises.
On the CPU path it runs the plain twin, a numpy wavefront over the
anti-diagonals, which makes the same float32 sums and the same decisions
(ties fall through to the right step, openai's ``dtw_cpu``), so the two
return equal starts.  Neither switches to the other.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("dtw")
    fn = lib.dtw_batch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _rows(cost: np.ndarray, t_rows, ta_rows):
    cost = np.ascontiguousarray(cost, np.float32)
    b, t, ta = cost.shape
    t_rows = np.ascontiguousarray(np.broadcast_to(np.asarray(t_rows, np.int64), (b,)))
    ta_rows = np.ascontiguousarray(np.broadcast_to(np.asarray(ta_rows, np.int64), (b,)))
    if ((t_rows < 0) | (t_rows > t) | (ta_rows < 0) | (ta_rows > ta)).any():
        raise ValueError(f"row sizes {t_rows}, {ta_rows} exceed the cost's {t}x{ta}")
    return cost, t_rows, ta_rows


def dtw_native(cost: np.ndarray, t_rows, ta_rows) -> np.ndarray:
    """The C++ DTW (``csrc/dtw.cu``) over a batch of rows."""
    cost, t_rows, ta_rows = _rows(cost, t_rows, ta_rows)
    b, t, ta = cost.shape
    out = np.zeros((b, t), np.int64)
    if _library().dtw_batch(cost.ctypes.data, b, t, ta, t_rows.ctypes.data,
                            ta_rows.ctypes.data, out.ctypes.data) != 0:
        raise ValueError("dtw_batch failed")
    dtw_native.launches += 1
    return out


dtw_native.launches = 0


def dtw_wavefront(cost: np.ndarray, t_rows, ta_rows) -> np.ndarray:
    """The plain twin: the same recurrence in float32, one anti-diagonal
    (all cells with i + j = d) at a time across the batch, then each row's
    backtrace."""
    cost, t_rows, ta_rows = _rows(cost, t_rows, ta_rows)
    b, t, ta = cost.shape
    out = np.zeros((b, t), np.int64)
    if b == 0 or t == 0 or ta == 0:
        return out
    w = ta + 1
    acc = np.full((b, (t + 1) * w), np.inf, np.float32)
    acc[:, 0] = 0.0
    trace = np.zeros((b, (t + 1) * w), np.int8)
    flat_cost = cost.reshape(b, t * ta)
    for d in range(2, t + ta + 1):
        i = np.arange(max(1, d - ta), min(t, d - 1) + 1)
        j = d - i
        idx = i * w + j
        c0 = acc[:, idx - w - 1]  # diagonal
        c1 = acc[:, idx - w]  # down
        c2 = acc[:, idx - 1]  # right
        step0 = (c0 < c1) & (c0 < c2)
        step1 = ~step0 & (c1 < c0) & (c1 < c2)
        best = np.where(step0, c0, np.where(step1, c1, c2))
        acc[:, idx] = flat_cost[:, (i - 1) * ta + (j - 1)] + best
        trace[:, idx] = np.where(step0, 0, np.where(step1, 1, 2))
    for r in range(b):
        i, j = int(t_rows[r]), int(ta_rows[r])
        tr = trace[r]
        while i > 0 and j > 0:
            out[r, i - 1] = j - 1
            step = tr[i * w + j]
            if step == 0:
                i, j = i - 1, j - 1
            elif step == 1:
                i -= 1
            else:
                j -= 1
    return out


def dtw_starts(cost: np.ndarray, t_rows, ta_rows, device) -> np.ndarray:
    """Starts (B, T) of a batch of DTW rows: the C++ function when
    ``device`` is a CUDA device, else the numpy twin."""
    if torch.device(device).type == "cuda":
        return dtw_native(cost, t_rows, ta_rows)
    return dtw_wavefront(cost, t_rows, ta_rows)
