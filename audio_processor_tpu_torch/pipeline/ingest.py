"""Audio ingest: any container -> 16 kHz mono float32 numpy.

The port of the JAX package's ``pipeline/ingest.py``, in its order:

  * WAV       -> native C++ parser+resampler (``native/audio_io.cc``), the
                 pure-Python ``utils.wavio`` reader as the fallback;
  * m4a/aac/mp3/ogg/flac/... -> native C++ module linking the system codec
                 libraries (``native/media_decode.cc``) — the product's
                 input is .m4a Drive recordings, decoded with no
                 subprocess and no ffmpeg binary;
  * last resort: a host ``ffmpeg`` binary, if one exists.

Ingest is host work: where the native resampler is missing, the CPU runs
``frontend.resample_host`` (the JAX package falls back to its device op).
"""
from __future__ import annotations

import logging
import os
import shutil
import subprocess
import tempfile

import numpy as np

from ..native import audio_io, media
from ..ops import frontend
from ..utils import wavio

logger = logging.getLogger(__name__)

TARGET_SR = 16_000


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def load_audio(
    path: str, target_sr: int = TARGET_SR, max_s: float | None = None
) -> np.ndarray:
    """Decode any supported audio file to mono float32 at target_sr.

    ``max_s`` bounds the decode to the first max_s seconds — bounded
    probes (detect_language's 30 s window) on multi-hour recordings stop
    demuxing/converting at the cap instead of decoding the whole file.
    """

    def cap(samples: np.ndarray) -> np.ndarray:
        if max_s is not None:
            return samples[: int(max_s * target_sr)]
        return samples

    max_samples = None if max_s is None else int(max_s * target_sr)
    ext = os.path.splitext(path)[1].lower()
    wav_error: Exception | None = None
    if ext in (".wav", ".wave"):
        # fastest path: native C++ decode+resample in one pass — but ONLY
        # for unbounded loads: the native ABI has no prefix form, so a
        # bounded probe (detect_language's 30 s) through it would read +
        # decode + resample the WHOLE multi-hour file; the pure-Python
        # reader slices the payload before conversion instead.
        if max_s is None:
            try:
                if audio_io.available():
                    samples, _ = audio_io.decode(path, target_sr)
                    return cap(samples)
            except Exception as exc:  # noqa: BLE001 — fall back to python
                logger.debug("native decode unavailable (%s)", exc)
        try:
            return cap(_load_wav(path, target_sr, max_s=max_s))
        except ValueError as exc:
            wav_error = exc
            logger.warning("WAV decode failed (%s); trying media decoders", exc)
    # compressed containers: in-process codec-library decode first
    media_error: Exception | None = None
    try:
        if media.available():
            samples, _ = media.decode(path, target_sr, max_samples=max_samples)
            return cap(samples)
    except Exception as exc:  # noqa: BLE001 — keep falling back: the host
        # ffmpeg binary may carry codecs the linked libav build lacks
        media_error = exc
        logger.debug("native media decode failed (%s)", exc)
    if ffmpeg_available():
        return cap(_load_via_ffmpeg(path, target_sr, max_s=max_s))
    if media_error is not None:
        raise ValueError(
            f"cannot decode {path!r}: no decodable audio stream"
        ) from media_error
    if wav_error is not None:
        # the file IS a WAV that failed for a specific reason (unsupported
        # format code, truncated chunk) — surface THAT, not a misleading
        # "not a WAV file"
        raise ValueError(
            f"cannot decode {path!r}: {wav_error}"
        ) from wav_error
    raise ValueError(
        f"cannot decode {path!r}: not a WAV file and no ffmpeg on host"
    )


def load_if_path(
    audio: "np.ndarray | str | os.PathLike",
    sample_rate: int,
    target_sr: int = TARGET_SR,
    max_s: float | None = None,
) -> tuple[np.ndarray, int]:
    """A str/PathLike decodes at ``target_sr``; an array passes through
    untouched with the caller's ``sample_rate``.  Returns (audio, rate)."""
    if isinstance(audio, (str, os.PathLike)):
        return load_audio(str(audio), target_sr, max_s=max_s), target_sr
    return audio, sample_rate


def _load_wav(
    path: str, target_sr: int, max_s: float | None = None
) -> np.ndarray:
    # cap at the SOURCE rate (read_wav slices pre-conversion), resample after
    samples, rate = wavio.read_wav_mono(path, max_s=max_s)
    return _resample_np(samples, rate, target_sr)


def _resample_np(samples: np.ndarray, rate: int, target_sr: int) -> np.ndarray:
    if rate == target_sr:
        return samples.astype(np.float32)
    # prefer the native host resampler; without it, the same filter in
    # torch on the CPU
    try:
        if audio_io.available():
            return audio_io.resample(samples, rate, target_sr)
    except Exception as exc:  # noqa: BLE001 — fall back to resample_host
        logger.debug("native resample unavailable (%s)", exc)
    return frontend.resample_host(samples, rate, target_sr)


def _load_via_ffmpeg(
    path: str, target_sr: int, max_s: float | None = None
) -> np.ndarray:
    """ffmpeg -> s16le pipe -> numpy (no temp WAV round-trip)."""
    cmd = [
        "ffmpeg", "-nostdin", "-threads", "0", "-i", path,
        *([] if max_s is None else ["-t", f"{max_s:.3f}"]),
        "-f", "s16le", "-ac", "1", "-acodec", "pcm_s16le",
        "-ar", str(target_sr), "-",
    ]
    proc = subprocess.run(cmd, capture_output=True, check=False)
    if proc.returncode != 0:
        raise ValueError(f"ffmpeg failed: {proc.stderr[-500:].decode(errors='ignore')}")
    return np.frombuffer(proc.stdout, np.int16).astype(np.float32) / 32768.0


def convert_to_wav(path: str, out_dir: str | None = None) -> str:
    """Materialise a 16 kHz mono 16-bit WAV in out_dir (default: a fresh
    temp dir).  Never overwrites the source: a .wav input with out_dir
    pointing at its own directory would otherwise replace a 24-bit/48 kHz
    original with the lossy downmix."""
    audio = load_audio(path)
    out_dir = out_dir or tempfile.mkdtemp(prefix="aptpu_audio_")
    stem = os.path.splitext(os.path.basename(path))[0]
    out_path = os.path.join(out_dir, stem + ".wav")
    if os.path.abspath(out_path) == os.path.abspath(path):
        out_path = os.path.join(out_dir, stem + ".16k.wav")
    wavio.write_wav(out_path, audio, TARGET_SR)
    return out_path
