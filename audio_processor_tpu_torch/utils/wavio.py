"""WAV/PCM file I/O on the stdlib only (no soundfile/librosa in the image).

The reference shells out to ffmpeg to produce 16 kHz mono s16le WAV
(reference: app/services/audio_processor.py:912-923).  Here WAV parsing is
first-party; non-WAV containers (m4a/ogg/...) are decoded by the optional
native decoder or an ffmpeg binary if one exists on the host (see
audio_processor_tpu_torch.pipeline.ingest).
A copy of the JAX package's module: the port imports nothing from it.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np


@dataclass
class WavInfo:
    sample_rate: int
    num_channels: int
    bits_per_sample: int
    num_frames: int
    audio_format: int  # 1 = PCM int, 3 = IEEE float


def _iter_chunks(data: bytes):
    """Yield (chunk_id, offset, size) for every RIFF chunk."""
    pos = 12  # skip RIFF header
    n = len(data)
    while pos + 8 <= n:
        cid = data[pos : pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        yield cid, pos + 8, size
        pos += 8 + size + (size & 1)  # chunks are word-aligned


def read_wav(path: str, max_s: float | None = None) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 samples in [-1, 1] of shape (frames, ch), rate).

    Supports PCM 8/16/24/32-bit and IEEE float32/float64, plus the
    WAVE_FORMAT_EXTENSIBLE wrapper — a superset of stdlib ``wave``.
    ``max_s`` caps the result to the first max_s seconds: the data payload
    is sliced BEFORE sample conversion, so a bounded probe of a long file
    skips the float conversion of everything past the cap.
    """
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 44 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")

    fmt = None
    payload = None
    for cid, off, size in _iter_chunks(data):
        if cid == b"fmt ":
            # bounds-check BEFORE unpacking: struct.error would escape the
            # ValueError contract ingest's decoder-fallback chain relies on
            if size < 16 or off + 16 > len(data):
                raise ValueError(f"{path}: truncated fmt chunk")
            audio_format, channels, rate, _, _, bits = struct.unpack_from(
                "<HHIIHH", data, off
            )
            if audio_format == 0xFFFE and size >= 40:  # EXTENSIBLE: real fmt in GUID
                if off + 26 > len(data):
                    raise ValueError(f"{path}: truncated extensible fmt chunk")
                (audio_format,) = struct.unpack_from("<H", data, off + 24)
            fmt = (audio_format, channels, rate, bits)
        elif cid == b"data":
            payload = data[off : off + size]
    if fmt is None or payload is None:
        raise ValueError(f"{path}: missing fmt/data chunk")

    audio_format, channels, rate, bits = fmt
    # mirror the native decoder's header bounds: rate 0 would divide by zero
    # downstream (resample), an absurd rate would size a multi-GB filter
    if not (0 < rate <= 768_000):
        raise ValueError(f"{path}: invalid sample rate {rate}")
    if channels < 1:
        raise ValueError(f"{path}: invalid channel count {channels}")
    if max_s is not None and max_s >= 0:
        frame_bytes = channels * max(bits // 8, 1)
        payload = payload[: int(max_s * rate) * frame_bytes]
    if audio_format == 1:  # integer PCM
        if bits == 8:
            x = (np.frombuffer(payload, np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(payload, "<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            raw = np.frombuffer(payload, np.uint8)
            raw = raw[: len(raw) - len(raw) % 3].reshape(-1, 3)
            as32 = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            as32 = (as32 ^ 0x800000) - 0x800000  # sign-extend
            x = as32.astype(np.float32) / 8388608.0
        elif bits == 32:
            x = np.frombuffer(payload, "<i4").astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        if bits == 32:
            x = np.frombuffer(payload, "<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(payload, "<f8").astype(np.float32)
        else:
            raise ValueError(f"unsupported float bit depth {bits}")
    else:
        raise ValueError(f"unsupported WAV format code {audio_format}")

    if channels > 1:
        x = x[: len(x) - len(x) % channels].reshape(-1, channels)
    else:
        x = x.reshape(-1, 1)
    return x, rate


def read_wav_mono(
    path: str, max_s: float | None = None
) -> tuple[np.ndarray, int]:
    """Read a WAV file and downmix to mono float32 (frames,)."""
    x, rate = read_wav(path, max_s=max_s)
    return x.mean(axis=1, dtype=np.float32), rate


def write_wav(path: str, samples: np.ndarray, rate: int) -> None:
    """Write float32/-1..1 (frames,) or (frames, ch) samples as 16-bit PCM WAV."""
    x = np.asarray(samples)
    if x.ndim == 1:
        x = x[:, None]
    pcm = np.clip(np.round(x * 32767.0), -32768, 32767).astype("<i2")
    payload = pcm.tobytes()
    channels = x.shape[1]
    byte_rate = rate * channels * 2
    header = b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
    header += b"fmt " + struct.pack(
        "<IHHIIHH", 16, 1, channels, rate, byte_rate, channels * 2, 16
    )
    header += b"data" + struct.pack("<I", len(payload))
    with open(path, "wb") as f:
        f.write(header + payload)
