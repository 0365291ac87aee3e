"""Kaldi-style log-mel filterbank features for the speaker-embedding net.

The port of the JAX package's ``ops/fbank.py``.  WeSpeaker-family
embedding checkpoints consume kaldi fbank (25 ms frames, 10 ms hop, povey
window, HTK mel, snip-edges), which differs from the Whisper mel contract
in ``ops/frontend.py`` (hann, slaney, centered).  Framing reuses
``frontend.frame_signal``; the DFT is two float32 matmuls against
window-folded bases, which must run in full float32 (the JAX package pins
``Precision.HIGHEST``; ``runtime.device.set_full_fp32`` turns TF32 off).
It is plain PyTorch on every device: the JAX package has no kernel here.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .frontend import frame_signal

SAMPLE_RATE = 16_000
FRAME_LENGTH = 400  # 25 ms
FRAME_SHIFT = 160  # 10 ms
N_FFT = 512  # kaldi rounds frame length up to a power of two


def hz_to_htk_mel(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)


def htk_mel_to_hz(m):
    return 700.0 * (np.exp(np.asarray(m, np.float64) / 1127.0) - 1.0)


@functools.lru_cache(maxsize=8)
def htk_mel_filterbank(
    n_mels: int = 80,
    n_fft: int = N_FFT,
    sample_rate: int = SAMPLE_RATE,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
) -> np.ndarray:
    """Triangular HTK-mel filters, (n_mels, n_fft//2+1): kaldi's
    construction (slopes linear in mel at each fft bin, high_freq <= 0
    meaning Nyquist + high_freq, a zero Nyquist column)."""
    if high_freq <= 0:
        high_freq = sample_rate / 2 + high_freq
    num_fft_bins = n_fft // 2
    fft_bin_width = sample_rate / n_fft
    mel_low = hz_to_htk_mel(low_freq)
    mel_high = hz_to_htk_mel(high_freq)
    mel_delta = (mel_high - mel_low) / (n_mels + 1)
    left_mel = mel_low + np.arange(n_mels)[:, None] * mel_delta
    center_mel = left_mel + mel_delta
    right_mel = center_mel + mel_delta
    mel = hz_to_htk_mel(fft_bin_width * np.arange(num_fft_bins))[None, :]
    up = (mel - left_mel) / (center_mel - left_mel)
    down = (right_mel - mel) / (right_mel - center_mel)
    weights = np.maximum(0.0, np.minimum(up, down))
    return np.concatenate([weights, np.zeros((n_mels, 1))], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=2)
def _fbank_bases(n_fft: int = N_FFT, frame_len: int = FRAME_LENGTH):
    """Real-DFT bases over a frame, povey window folded in: (frame_len, n_freqs)."""
    n_freqs = n_fft // 2 + 1
    window = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(frame_len) / (frame_len - 1))) ** 0.85
    t = np.arange(frame_len)[:, None] * np.arange(n_freqs)[None, :]
    ang = 2.0 * np.pi * t / n_fft
    cos_b = (np.cos(ang) * window[:, None]).astype(np.float32)
    sin_b = (-np.sin(ang) * window[:, None]).astype(np.float32)
    return cos_b, sin_b


def num_frames(n_samples: int) -> int:
    """snip_edges=True frame count."""
    if n_samples < FRAME_LENGTH:
        return 0
    return 1 + (n_samples - FRAME_LENGTH) // FRAME_SHIFT


def fbank(
    audio: torch.Tensor,
    n_mels: int = 80,
    *,
    preemphasis: float = 0.97,
    remove_dc: bool = True,
    mean_norm: bool = True,
) -> torch.Tensor:
    """audio (..., n_samples) at 16 kHz -> (..., n_frames, n_mels), in
    audio's dtype (float32 on the serving path).

    Snip-edges framing, per-frame DC removal, pre-emphasis, povey window,
    power spectrum, HTK mel, log, optional utterance CMN: the JAX
    function's steps in its order (``fbank.py:96-128``)."""
    nf = num_frames(audio.shape[-1])
    frames = frame_signal(audio, nf)[..., :nf, :]
    if remove_dc:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if preemphasis:
        shifted = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - preemphasis * shifted

    cos_np, sin_np = _fbank_bases()
    re = frames @ torch.from_numpy(cos_np).to(audio.device, audio.dtype)
    im = frames @ torch.from_numpy(sin_np).to(audio.device, audio.dtype)
    power = re * re + im * im
    filters = torch.from_numpy(htk_mel_filterbank(n_mels)).to(audio.device, audio.dtype)
    logmel = torch.log(torch.clamp(power @ filters.T, min=1.1921e-07))
    if mean_norm:
        logmel = logmel - logmel.mean(dim=-2, keepdim=True)
    return logmel
