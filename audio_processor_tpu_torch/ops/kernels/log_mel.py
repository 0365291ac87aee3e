"""Kernel A: the fused log-mel frontend (CUDA C++, ``csrc/log_mel.cu``).

Replaces the TPU kernel ``log_mel_pallas``
(``audio_processor_tpu/ops/pallas/mel_kernel.py:61``).  ``log_mel`` is the
port's frontend: on a CUDA tensor it launches the kernel, on a CPU tensor
it runs the plain PyTorch version (``ops.frontend.log_mel_spectrogram``),
which computes the same function.  Bound and design: see the source.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import frontend
from . import build


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("log_mel")
    fn = lib.log_mel_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.log_mel_tile_count.argtypes = [ctypes.c_int]
    lib.log_mel_tile_count.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=8)
def _constants(device: torch.device, n_mels: int):
    """The (400, 201) cos/sin bases and the (201, n_mels) filterbank on
    ``device``."""
    cos_b, sin_b = frontend.dft_bases(frontend.N_FFT)
    filt = frontend.mel_filterbank(n_mels).T
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (cos_b, sin_b, filt))


def log_mel(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """audio (B, n_samples) float32 at 16 kHz -> log-mel (B, n_mels,
    n_samples // 160) float32, Whisper-normalised.

    CUDA tensor: the kernel (or an error).  CPU tensor: the plain version.
    """
    if audio.device.type == "cpu":
        return frontend.log_mel_spectrogram(audio, n_mels)
    if audio.device.type != "cuda":
        raise ValueError(f"log_mel: unsupported device {audio.device}")
    if audio.dtype != torch.float32 or audio.ndim != 2 or not audio.is_contiguous():
        raise ValueError(
            "log_mel kernel takes a contiguous (B, n_samples) float32 tensor, "
            f"got {tuple(audio.shape)} {audio.dtype}"
        )
    b, n_samples = audio.shape
    n_frames = n_samples // frontend.HOP_LENGTH
    if n_samples <= frontend.N_FFT // 2 or n_frames < 1:
        raise ValueError(f"log_mel: {n_samples} samples is too short to frame")
    lib = _library()
    cos_b, sin_b, filt = _constants(audio.device, n_mels)
    out = torch.empty((b, n_mels, n_frames), dtype=torch.float32, device=audio.device)
    n_tiles = lib.log_mel_tile_count(n_samples)
    tile_max = torch.empty((b, n_tiles), dtype=torch.float32, device=audio.device)
    stream = torch.cuda.current_stream(audio.device).cuda_stream
    rc = lib.log_mel_launch(
        audio.data_ptr(), b, n_samples, cos_b.data_ptr(), sin_b.data_ptr(),
        filt.data_ptr(), n_mels, out.data_ptr(), tile_max.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(f"log_mel kernel launch failed: CUDA error {rc}")
    log_mel.launches += 1
    return out


log_mel.launches = 0
