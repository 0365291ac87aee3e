"""Audio ingest: numpy arrays, WAV, or any container via ffmpeg.

The port of the JAX package's ``pipeline/ingest.py`` on this slice's
path.  WAV files are parsed in-process (``utils.wavio``) and resampled to
the target rate on the host (``frontend.resample`` on the CPU: ingest is a
host stage, as in the JAX package's ``_resample_np``); anything else goes
through a host ``ffmpeg`` binary, which resamples to 16 kHz mono.  The
native codec decoders are not ported yet.
"""
from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np

from ..ops import frontend
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
    if ext in (".wav", ".wave"):
        try:
            # cap at the source rate (read_wav slices before conversion)
            samples, rate = wavio.read_wav_mono(path, max_s=max_s)
        except ValueError as exc:
            wav_error = exc
        else:
            out = frontend.resample_host(samples, rate, target_sr)
            return out if max_s is None else out[: int(max_s * target_sr)]
    if ffmpeg_available():
        return _load_via_ffmpeg(path, target_sr, max_s=max_s)
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
