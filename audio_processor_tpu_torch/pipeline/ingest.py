"""Audio ingest: numpy arrays, 16 kHz WAV, or any container via ffmpeg.

The port of the JAX package's ``pipeline/ingest.py`` on this slice's
path.  WAV files at 16 kHz are parsed in-process (``utils.wavio``);
anything else goes through a host ``ffmpeg`` binary, which resamples to
16 kHz mono.  The in-process resampler and the native codec decoders are
not ported yet: without ffmpeg, a WAV at another rate raises
NotImplementedError.
"""
from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np

from ..utils import wavio

TARGET_SR = 16_000


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def load_audio(
    path: str, target_sr: int = TARGET_SR, max_s: float | None = None
) -> np.ndarray:
    """Decode an audio file to mono float32 at target_sr (first max_s
    seconds when given)."""
    ext = os.path.splitext(path)[1].lower()
    wav_error: Exception | None = None
    wav_rate = None
    if ext in (".wav", ".wave"):
        try:
            samples, wav_rate = wavio.read_wav_mono(path, max_s=max_s)
        except ValueError as exc:
            wav_error = exc
        else:
            if wav_rate == target_sr:
                return samples.astype(np.float32)
    if ffmpeg_available():
        return _load_via_ffmpeg(path, target_sr, max_s=max_s)
    if wav_rate is not None:
        raise NotImplementedError(
            f"{path!r} is {wav_rate} Hz: resampling needs a host ffmpeg "
            "(the in-process resampler is not ported yet)"
        )
    if wav_error is not None:
        raise ValueError(f"cannot decode {path!r}: {wav_error}") from wav_error
    raise ValueError(f"cannot decode {path!r}: not a WAV file and no ffmpeg on host")


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
