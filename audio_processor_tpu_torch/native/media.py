"""ctypes binding for the native media module (``native/media_decode.cc``).

The port's copy of the JAX package's ``native/media.py``: in-process
compressed-audio decode (m4a/aac/mp3/ogg/flac/...) and AAC-LC .m4a encode,
linking the system codec libraries (libavformat, libavcodec, libavutil,
libswresample) — the product's input is .m4a Drive recordings, decoded
with no ``ffmpeg`` binary.  Built with g++ at first use
(``native/build.py``).  The module is optional, as in the JAX package:
with no codec headers, or a failed build, ``available()`` is False and
``pipeline/ingest.py`` goes on to a host ``ffmpeg``.  ``build_status()``
tells the two apart: a deployment that has the headers must also have the
library.
"""
from __future__ import annotations

import ctypes
import logging
import os
import threading

import numpy as np

from . import build

logger = logging.getLogger(__name__)

# every header media_decode.cc includes
HEADERS = (
    "libavcodec/avcodec.h", "libavformat/avformat.h", "libavutil/channel_layout.h",
    "libavutil/opt.h", "libswresample/swresample.h",
)

_lib = None
_lock = threading.Lock()
_status: dict | None = None


def _headers() -> tuple[bool, str]:
    """(all the codec headers are on the compiler's search list, what was
    checked or found)."""
    dirs = build.include_dirs()
    if not dirs:
        return False, "no C++ compiler to search with"
    missing = [h for h in HEADERS if not any(os.path.isfile(os.path.join(d, h)) for d in dirs)]
    if missing:
        return False, f"no libav headers: {', '.join(missing)} in none of {', '.join(dirs)}"
    found = sorted({d for d in dirs for h in HEADERS if os.path.isfile(os.path.join(d, h))})
    return True, f"libav headers in {', '.join(found)}"


def _load():
    global _lib, _status
    with _lock:
        if _lib is not None or _status is not None:
            return _lib
        present, where = _headers()
        if not present:
            _status = {"built": False, "headers": False, "why": where, "headers_at": None,
                       "library": None}
            logger.info("native media library not built: %s", where)
            return None
        try:
            lib = build.load("media_decode", build.MEDIA_LIBS)
        except (RuntimeError, OSError) as exc:  # compile or codec runtime libs
            _status = {"built": False, "headers": True, "why": str(exc), "headers_at": where,
                       "library": None}
            logger.warning("native media library failed with the headers present: %s", exc)
            return None
        lib.aptpu_decode_media.restype = ctypes.c_int64
        lib.aptpu_decode_media.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ]
        lib.aptpu_decode_media_prefix.restype = ctypes.c_int64
        lib.aptpu_decode_media_prefix.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ]
        lib.aptpu_media_free.restype = None
        lib.aptpu_media_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.aptpu_media_info.restype = ctypes.c_int
        lib.aptpu_media_info.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.aptpu_encode_m4a.restype = ctypes.c_int
        lib.aptpu_encode_m4a.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64,
        ]
        _status = {"built": True, "headers": True, "why": None, "headers_at": where,
                   "library": str(build.library_path("media_decode", build.MEDIA_LIBS))}
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_status() -> dict:
    """Whether the library loads, and why not: ``headers`` False when the
    compiler finds no codec headers (the module is simply absent here;
    ``why`` names the headers and the directories searched), True with
    ``built`` False when it has them and the build or the load failed
    (``why`` holds the compiler's or loader's message).  ``headers_at``
    and ``library`` say where the headers and the library are."""
    _load()
    return dict(_status)


def _lib_or_raise():
    lib = _load()
    if lib is None:
        raise RuntimeError("native media library not available")
    return lib


def decode(
    path: str, target_sr: int = 16_000, max_samples: int | None = None
) -> tuple[np.ndarray, int]:
    """Any supported container/codec -> (mono float32 @ target_sr, rate).

    max_samples bounds the decode: demuxing stops once that many output
    samples exist (a 30 s probe of a long recording decodes ~30 s, not
    the file).
    """
    lib = _lib_or_raise()
    buf = ctypes.POINTER(ctypes.c_float)()
    if max_samples is not None:
        n = lib.aptpu_decode_media_prefix(
            path.encode(), target_sr, int(max_samples), ctypes.byref(buf)
        )
    else:
        n = lib.aptpu_decode_media(path.encode(), target_sr, ctypes.byref(buf))
    if n < 0:
        raise ValueError(f"native media decode failed for {path!r}")
    try:
        out = np.ctypeslib.as_array(buf, shape=(n,)).copy()
    finally:
        lib.aptpu_media_free(buf)
    if max_samples is not None:
        out = out[: int(max_samples)]
    return out, target_sr


def media_info(path: str) -> dict:
    lib = _lib_or_raise()
    sr = ctypes.c_int64()
    ch = ctypes.c_int()
    dur = ctypes.c_int64()
    name = ctypes.create_string_buffer(64)
    rc = lib.aptpu_media_info(
        path.encode(), ctypes.byref(sr), ctypes.byref(ch), ctypes.byref(dur),
        name, len(name),
    )
    if rc != 0:
        raise ValueError(f"no decodable audio stream in {path!r}")
    return {
        "sample_rate": sr.value,
        "channels": ch.value,
        "duration_ms": dur.value,
        "codec": name.value.decode(),
    }


def encode_m4a(
    samples: np.ndarray, sample_rate: int, path: str, bit_rate: int = 96_000
) -> None:
    """Mono float32 PCM -> AAC-LC .m4a (fixture generation / conversion)."""
    lib = _lib_or_raise()
    x = np.ascontiguousarray(samples, np.float32)
    rc = lib.aptpu_encode_m4a(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x),
        sample_rate, path.encode(), bit_rate,
    )
    if rc != 0:
        raise ValueError(f"m4a encode failed for {path!r}")
