"""ctypes binding for the native audio module (``native/audio_io.cc``).

The port's copy of the JAX package's ``native/audio_io.py``: a WAV parser
and polyphase resampler in C++, built with g++ at first use
(``native/build.py``).  Every entry point raises RuntimeError when the
library is missing, and ``pipeline/ingest.py`` then takes the pure-Python
reader (``utils.wavio``) and ``frontend.resample_host``.  ``dtw`` is the
source's own ``aptpu_dtw`` (a host g++ build, so it also serves where no
nvcc is); the word-timestamp path runs ``ops/kernels/dtw.py`` instead.
"""
from __future__ import annotations

import ctypes
import logging
import threading

import numpy as np

from . import build

logger = logging.getLogger(__name__)

_lib = None
_lock = threading.Lock()
_build_attempted = False
_error: str | None = None


def _load():
    global _lib, _build_attempted, _error
    # fast path without the lock (assignment is atomic; the value never
    # changes once set)
    if _lib is not None:
        return _lib
    # non-blocking for concurrent callers: the first-ever call may run a
    # compile (up to 120 s) — other request threads must NOT queue behind
    # it (they fall back to the pure-Python decoder immediately and pick
    # up the .so on a later call)
    if not _lock.acquire(blocking=False):
        return None
    try:
        if _lib is not None or _build_attempted:
            return _lib
        _build_attempted = True
        try:
            lib = build.load("audio_io")
        except (RuntimeError, OSError) as exc:  # optional component
            _error = str(exc)
            logger.info("native audio library unavailable: %s", exc)
            return None
        lib.aptpu_decode_wav.restype = ctypes.c_int64
        lib.aptpu_decode_wav.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ]
        lib.aptpu_wav_out_size.restype = ctypes.c_int64
        lib.aptpu_wav_out_size.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.aptpu_wav_info.restype = ctypes.c_int
        lib.aptpu_wav_info.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.aptpu_resample.restype = ctypes.c_int64
        lib.aptpu_resample.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ]
        lib.aptpu_dtw.restype = ctypes.c_int
        lib.aptpu_dtw.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
        return _lib
    finally:
        _lock.release()


def available() -> bool:
    return _load() is not None


def build_status() -> dict:
    """``{"built": True, "library": path}``, or ``{"built": False, "why":
    the compiler's or loader's message}`` (the library is optional: ingest
    takes the pure-Python reader without it)."""
    if available():
        return {"built": True, "library": str(build.library_path("audio_io"))}
    return {"built": False, "why": _error or "another thread is building the library"}


def _lib_or_raise():
    lib = _load()
    if lib is None:
        raise RuntimeError("native audio library not available")
    return lib


def decode(path: str, target_sr: int = 16_000) -> tuple[np.ndarray, int]:
    """WAV file -> (mono float32 at target_sr, target_sr)."""
    lib = _lib_or_raise()
    with open(path, "rb") as f:
        data = f.read()
    # header-only size query, then one decode + resample into the buffer
    n = lib.aptpu_wav_out_size(data, len(data), target_sr)
    if n < 0:
        raise ValueError(f"native decode failed for {path!r}")
    out = np.empty(n, np.float32)
    got = lib.aptpu_decode_wav(
        data, len(data), target_sr,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
    )
    if got != n:
        raise ValueError("native decode size mismatch")
    return out, target_sr


def wav_info(path: str) -> dict:
    lib = _lib_or_raise()
    with open(path, "rb") as f:
        data = f.read()
    sr = ctypes.c_int64()
    ch = ctypes.c_int()
    bits = ctypes.c_int()
    if lib.aptpu_wav_info(data, len(data), ctypes.byref(sr), ctypes.byref(ch), ctypes.byref(bits)) != 0:
        raise ValueError(f"not a WAV file: {path!r}")
    return {"sample_rate": sr.value, "channels": ch.value, "bits": bits.value}


def dtw(cost: np.ndarray) -> np.ndarray:
    """DTW backtrace over a (t, ta) cost matrix -> per-row start columns."""
    lib = _lib_or_raise()
    c = np.ascontiguousarray(cost, np.float32)
    t, ta = c.shape
    out = np.zeros(t, np.int64)
    if lib.aptpu_dtw(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), t, ta,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    ) != 0:
        raise ValueError("dtw failed")
    return out


def resample(samples: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    lib = _lib_or_raise()
    x = np.ascontiguousarray(samples, np.float32)
    n = lib.aptpu_resample(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x), sr_in, sr_out, None, 0
    )
    if n < 0:
        raise ValueError("native resample failed")
    out = np.empty(n, np.float32)
    got = lib.aptpu_resample(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x), sr_in, sr_out,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
    )
    if got != n:
        raise ValueError("native resample size mismatch")
    return out
