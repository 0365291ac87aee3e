"""Kernel A: the fused log-mel frontend (CUDA C++, ``csrc/log_mel.cu``).

Replaces the TPU kernel ``log_mel_pallas``
(``audio_processor_tpu/ops/pallas/mel_kernel.py:61``).  ``log_mel`` is the
port's frontend: on a CUDA tensor it launches the kernel, on a CPU tensor
it runs the plain PyTorch version (``ops.frontend.log_mel_spectrogram``),
which computes the same function.  The kernel computes the windowed DFT as
a four-step FFT (400 = 20 x 20) and the mel projection from a band table;
``four_step_tables`` builds every table it reads, on the host.  Bound and
design: see the source.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import frontend
from . import build

RADIX = 20  # N_FFT = RADIX * RADIX
STAGE1_COLS = RADIX // 2 + 1  # k1 = 0..10; the rest mirror (real input)


@functools.lru_cache(maxsize=4)
def four_step_tables(n_mels: int) -> dict[str, np.ndarray]:
    """The tables kernel A reads, in its layouts, with n = 20*n1 + n2 and
    bin m = k1 + 20*k2:

    - ``stage1`` (20 n2, 20 n1, 2, 12) float32: ``[n2, n1, 0, k1]`` =
      w[n] cos(2 pi n k1 / 400) and ``[n2, n1, 1, k1]`` = -w[n] sin(...),
      the periodic hann window w and the four-step twiddle W400^(n2 k1)
      folded in; k1 = 0..10, column 11 zero (float4 rows);
    - ``w20`` (20 n2, 2, 20 k2) float32: cos and -sin of 2 pi n2 k2 / 20;
    - ``bands`` (n_mels, 3) int32: each filter's first bin, bin count and
      offset into ``weights``;
    - ``weights`` float32: the filters' non-zero runs, concatenated.

    Built in float64 and rounded once to float32.
    """
    n = RADIX * np.arange(RADIX)[None, :, None] + np.arange(RADIX)[:, None, None]  # (n2, n1, 1)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / frontend.N_FFT))
    ang = 2.0 * np.pi * n * np.arange(STAGE1_COLS)[None, None, :] / frontend.N_FFT
    stage1 = np.zeros((RADIX, RADIX, 2, 12), np.float32)
    stage1[:, :, 0, :STAGE1_COLS] = window * np.cos(ang)
    stage1[:, :, 1, :STAGE1_COLS] = -window * np.sin(ang)
    ang20 = 2.0 * np.pi * np.outer(np.arange(RADIX), np.arange(RADIX)) / RADIX
    w20 = np.stack([np.cos(ang20), -np.sin(ang20)], axis=1).astype(np.float32)

    fb = frontend.mel_filterbank(n_mels)
    bands = np.zeros((n_mels, 3), np.int32)
    runs, offset = [], 0
    for m, row in enumerate(fb):
        nz = np.flatnonzero(row)
        lo, hi = (nz[0], nz[-1] + 1) if nz.size else (0, 0)
        bands[m] = (lo, hi - lo, offset)
        runs.append(row[lo:hi])
        offset += hi - lo
    weights = np.concatenate(runs).astype(np.float32)
    return {"stage1": stage1, "w20": w20, "bands": bands, "weights": weights}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("log_mel")
    fn = lib.log_mel_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.log_mel_tile_count.argtypes = [ctypes.c_int]
    lib.log_mel_tile_count.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=8)
def _constants(device: torch.device, n_mels: int) -> dict[str, torch.Tensor]:
    """``four_step_tables(n_mels)`` on ``device``."""
    return {k: torch.from_numpy(a).to(device) for k, a in four_step_tables(n_mels).items()}


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
    tab = _constants(audio.device, n_mels)
    out = torch.empty((b, n_mels, n_frames), dtype=torch.float32, device=audio.device)
    n_tiles = lib.log_mel_tile_count(n_samples)
    tile_max = torch.empty((b, n_tiles), dtype=torch.float32, device=audio.device)
    stream = torch.cuda.current_stream(audio.device).cuda_stream
    rc = lib.log_mel_launch(
        audio.data_ptr(), b, n_samples, tab["stage1"].data_ptr(), tab["w20"].data_ptr(),
        tab["bands"].data_ptr(), tab["weights"].data_ptr(), n_mels, tab["weights"].numel(),
        out.data_ptr(), tile_max.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(f"log_mel kernel launch failed: CUDA error {rc}")
    log_mel.launches += 1
    return out


log_mel.launches = 0
