"""Audio frontend: resample, silence trim and the Whisper log-mel.

The silence trim has two halves, as in the JAX package: the host trim
(``trim_silence_host``, numpy) and the device trim (``silence_mask``, the
per-hop keep mask computed where the audio lives, and
``gather_kept_intervals``, which concatenates the kept intervals there);
``mask_to_intervals`` merges the small mask's gaps on the host between
the two, so both trims cut the same regions.

The log-mel is numerically the contract Whisper weights expect: hann(400),
hop 160, 80/128 slaney-scale mel bins, log10 -> per-window peak-8 clamp ->
(x+4)/4.  ``log_mel_spectrogram`` here is the plain PyTorch version
(float32 but for its two DFT products, taken in float64) of the JAX
package's ``ops/frontend.py:139``; on the card the port runs the fused
CUDA kernel in ``ops/kernels/log_mel.py`` instead, which computes the
same function.

Precision: every matmul below must be full float32.  TF32 keeps ~3
decimal digits, which is catastrophic in log space at quiet mel bins (the
JAX frontend pins Precision.HIGHEST for the same reason);
``runtime.device.set_full_fp32`` turns it off.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30  # seconds per Whisper window
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480_000
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000 mel frames per 30 s window
N_FREQS = N_FFT // 2 + 1  # 201


# ---------------------------------------------------------------------------
# Filterbank / basis construction (host-side numpy)
# ---------------------------------------------------------------------------

def hz_to_mel(freq: np.ndarray) -> np.ndarray:
    """Slaney-scale Hz->mel (librosa default, what Whisper's filters use)."""
    freq = np.asarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = freq / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    log_region = freq >= min_log_hz
    safe = np.where(log_region, freq, min_log_hz)
    mels = np.where(log_region, min_log_mel + np.log(safe / min_log_hz) / logstep, mels)
    return mels


def mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = mels * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    freqs = np.where(log_region, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)
    return freqs


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    n_mels: int = 80, n_fft: int = N_FFT, sample_rate: int = SAMPLE_RATE
) -> np.ndarray:
    """Slaney-normalised triangular mel filterbank, shape (n_mels, n_fft//2+1)."""
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sample_rate / 2, n_freqs)
    mel_pts = np.linspace(hz_to_mel(0.0), hz_to_mel(sample_rate / 2.0), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney normalisation: each filter integrates to ~2/bandwidth
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=4)
def dft_bases(n_fft: int = N_FFT) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT cos/sin bases with the periodic hann window folded in.

    Returns (cos_basis, sin_basis), each (n_fft, n_fft//2+1), such that for a
    raw frame x, (x @ cos)**2 + (x @ sin)**2 equals |rfft(hann * x)|**2.
    """
    n_freqs = n_fft // 2 + 1
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
    t = np.arange(n_fft)[:, None] * np.arange(n_freqs)[None, :]
    ang = 2.0 * np.pi * t / n_fft
    cos_b = (np.cos(ang) * window[:, None]).astype(np.float32)
    sin_b = (-np.sin(ang) * window[:, None]).astype(np.float32)
    return cos_b, sin_b


# ---------------------------------------------------------------------------
# Log-mel spectrogram (plain PyTorch; float64 DFT products)
# ---------------------------------------------------------------------------

def log_mel_spectrogram(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """Whisper-contract log-mel: audio (..., n_samples) float32 at 16 kHz
    -> (..., n_mels, n_samples // HOP_LENGTH) float32.

    Reflect-pad by n_fft//2, frame at hop 160, two matmuls against the
    hann-folded bases (in float64), power, mel, log10, per-window peak-8
    clamp, (x+4)/4 — the same steps as the JAX frontend
    (``frontend.py:139-180``); all but the two DFT products in float32.
    """
    lead = audio.shape[:-1]
    x = audio.reshape(-1, audio.shape[-1]).to(torch.float32)
    n_frames = x.shape[-1] // HOP_LENGTH
    padded = F.pad(x[:, None, :], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
    frames = padded.unfold(-1, N_FFT, HOP_LENGTH)[:, :n_frames]  # (B, nf, 400)

    # the two DFT products in float64: in float32 their 400-term sums
    # cancel at the lowest mel bins of a low tone (config 2's 160 Hz) and
    # land 1e-4 from the same steps in float64, where JAX's land 1e-5
    cos_np, sin_np = dft_bases(N_FFT)
    frames = frames.to(torch.float64)
    re = frames @ torch.from_numpy(cos_np).to(x.device, torch.float64)
    im = frames @ torch.from_numpy(sin_np).to(x.device, torch.float64)
    power = (re * re + im * im).to(torch.float32)  # (B, nf, 201)
    filters = torch.from_numpy(mel_filterbank(n_mels)).to(x.device)
    mel = power @ filters.T  # (B, nf, n_mels)

    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    peak = log_spec.amax(dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, peak - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    return log_spec.transpose(-1, -2).reshape(*lead, n_mels, n_frames)


def frame_signal(audio: torch.Tensor, n_frames: int) -> torch.Tensor:
    """Overlapping 400-sample frames at hop 160: audio (..., n_samples) ->
    (..., n_frames, N_FFT), zero-padded at the end where the signal is
    short.  Frame f is the 80-sample blocks [2f, 2f+5), taken as five
    stride-2 slices, as the JAX frontend does (``frontend.py:115``)."""
    block = HOP_LENGTH // 2  # 80
    needed = (2 * n_frames + 3) * block  # last frame spans blocks [2f, 2f+5)
    pad = (-audio.shape[-1]) % block
    if pad or audio.shape[-1] < needed:
        audio = F.pad(audio, (0, max(pad, needed - audio.shape[-1])))
    blocks = audio[..., : (audio.shape[-1] // block) * block]
    blocks = blocks.reshape(*audio.shape[:-1], -1, block)
    parts = [blocks[..., k : k + 2 * n_frames : 2, :] for k in range(5)]
    return torch.cat(parts, dim=-1)


# ---------------------------------------------------------------------------
# Resampling (polyphase conv1d)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _resample_kernel(up: int, down: int, num_taps_per_phase: int = 16) -> np.ndarray:
    """Kaiser-windowed sinc anti-aliasing lowpass for rational resampling
    (the JAX frontend's filter, ``frontend.py:193``)."""
    cutoff = 0.5 / max(up, down)
    half = num_taps_per_phase * max(up, down) // 2
    n = np.arange(-half, half + 1, dtype=np.float64)
    sinc = 2 * cutoff * np.sinc(2 * cutoff * n)
    window = np.kaiser(len(n), beta=8.555)
    return (sinc * window * up).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _polyphase_bank(up: int, down: int) -> tuple[np.ndarray, int]:
    """The JAX resampler's taps regrouped by output phase.

    JAX computes y[i] = sum_j P[i*down + j] * rhs[j], with P the input
    zero-stuffed by ``up`` and left-padded by ``half``, and rhs the
    reversed filter (``frontend.py:203-235``).  Only the taps that meet
    a real sample add anything: for output i = up*a + r they are
    rhs[up*k + half - r*down] against x[a*down + k].  Row r of the bank
    holds them for k = kmin .. kmin + L - 1 (zero where out of range),
    so y[up*a + r] is a strided correlation of x, left-padded by -kmin,
    with row r.  Returns (bank (up, L) float32, kmin)."""
    rhs = _resample_kernel(up, down)[::-1]
    half = len(rhs) // 2
    kmin = -(half // up)  # ceil(-half / up)
    kmax = (len(rhs) - 1 + (up - 1) * down - half) // up
    bank = np.zeros((up, kmax - kmin + 1), np.float32)
    for r in range(up):
        k = np.arange(kmin, kmax + 1)
        j = up * k + half - r * down
        ok = (j >= 0) & (j < len(rhs))
        bank[r, ok] = rhs[j[ok]]
    return bank, kmin


def resample(audio: torch.Tensor, orig_sr: int, target_sr: int = SAMPLE_RATE) -> torch.Tensor:
    """Rational-rate resample: audio (n,) float32 -> (ceil(n * target /
    orig),) float32, on audio's device.

    The JAX frontend (``frontend.py:203``) zero-stuffs by ``up`` and runs
    one strided FIR conv; here the stuffed zeros are never built (they
    would take n * up floats: 160 a sample from 44.1 kHz).  The filter is
    split into ``up`` phases (``_polyphase_bank``) and one conv1d with
    stride ``down`` and one output channel a phase reads the original
    samples: each output is the JAX sum without its zero terms.  The
    output length is JAX's ceil, which its ``pad_r`` rule guarantees
    there (``frontend.py:227-229``); samples past the end read zeros in
    both."""
    if orig_sr == target_sr:
        return audio
    g = math.gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    n = audio.shape[-1]
    n_out = -(-n * up // down)  # ceil
    bank_np, kmin = _polyphase_bank(up, down)
    bank = torch.from_numpy(bank_np).to(audio.device)[:, None, :]  # (up, 1, L)
    n_groups = -(-n_out // up)  # outputs a phase
    width = (n_groups - 1) * down + bank.shape[-1]
    x = audio.to(torch.float32).reshape(1, 1, n)
    x = F.pad(x, (-kmin, max(0, width + kmin - n)))[..., :width]
    y = F.conv1d(x, bank, stride=down)  # (1, up, n_groups): y[0, r, a] = out[up*a + r]
    return y[0].transpose(0, 1).reshape(-1)[:n_out]


def resample_host(audio: np.ndarray, orig_sr: int, target_sr: int = SAMPLE_RATE,
                  device: "torch.device | str" = "cpu") -> np.ndarray:
    """``resample`` of a host array, computed on ``device``; float32 back on
    the host (where the pipelines trim, window and slab it)."""
    if orig_sr == target_sr:
        return np.asarray(audio, np.float32)
    x = torch.from_numpy(np.asarray(audio, np.float32)).to(device)
    return resample(x, orig_sr, target_sr).cpu().numpy()


def pad_or_trim(audio: torch.Tensor, length: int = N_SAMPLES) -> torch.Tensor:
    """Pad with zeros / trim the last axis to a fixed window length."""
    n = audio.shape[-1]
    if n == length:
        return audio
    if n > length:
        return audio[..., :length]
    return F.pad(audio, (0, length - n))


# ---------------------------------------------------------------------------
# Silence removal: the device trim (plain PyTorch, where the audio lives) and
# the host trim (numpy; copies of the JAX frontend's host helpers)
# ---------------------------------------------------------------------------

def silence_mask(
    audio: torch.Tensor,
    frame_length: int = 400,
    hop: int = 160,
    threshold_db: float = -40.0,
    pad_frames: int = 25,
) -> torch.Tensor:
    """Per-hop boolean keep mask: frame RMS above (row peak dB +
    threshold_db), dilated by pad_frames (0.25 s at the default hop) so
    word onsets and offsets survive.  audio (..., n) float32 -> (...,
    max(n // hop, 1)) bool on audio's device; the JAX frontend's
    ``silence_mask`` (``frontend.py:243``).

    frame_length/hop are fixed at the Whisper STFT geometry (400/160),
    which ``frame_signal``'s block slicing is built on; other values are
    refused.  The peak and the dilation are taken per leading-dim row, so
    a batch does not bleed across rows.
    """
    if (frame_length, hop) != (N_FFT, HOP_LENGTH):
        raise ValueError(
            f"silence_mask supports only the Whisper frame geometry "
            f"({N_FFT}/{HOP_LENGTH}); got {frame_length}/{hop}"
        )
    n_frames = max(audio.shape[-1] // hop, 1)
    half = frame_length // 2
    frames = frame_signal(F.pad(audio, (half, half)), n_frames)
    rms = torch.sqrt(torch.mean(frames * frames, dim=-1) + 1e-12)
    db = 20.0 * torch.log10(rms + 1e-12)
    keep = db > (db.amax(dim=-1, keepdim=True) + threshold_db)
    if pad_frames > 0:
        kernel = torch.ones((1, 1, 2 * pad_frames + 1), dtype=torch.float32, device=keep.device)
        x = keep.to(torch.float32).reshape(-1, 1, keep.shape[-1])  # a conv row per lead row
        keep = F.conv1d(x, kernel, padding=pad_frames).reshape(keep.shape) > 0.5
    return keep


def gather_kept_intervals(
    audio: torch.Tensor,
    starts: torch.Tensor,
    cum_ends: torch.Tensor,
    n_out: int,
) -> torch.Tensor:
    """Concatenate kept intervals where ``audio`` lives into a zero-padded
    (..., n_out) buffer: the device half of the silence trim, so the big
    waveform never goes to the host, only the small per-hop mask does
    (the JAX frontend's ``gather_kept_intervals``, ``frontend.py:346``).

    starts (K,) is each interval's first sample in ``audio``; cum_ends
    (K,) the cumulative kept samples, cum_ends[-1] the total.  The tables
    are int32 as the callers build them, padded to a static K by repeating
    the last start with a plateau in cum_ends, which is an empty interval
    here.  Indexing is int64.
    """
    starts = starts.to(device=audio.device, dtype=torch.int64)
    cum = cum_ends.to(device=audio.device, dtype=torch.int64)
    j = torch.arange(n_out, dtype=torch.int64, device=audio.device)
    i = torch.searchsorted(cum, j, right=True).clamp(0, starts.shape[0] - 1)
    prev = torch.where(i > 0, cum[(i - 1).clamp(min=0)], 0)
    idx = (starts[i] + (j - prev)).clamp(0, audio.shape[-1] - 1)
    return audio[..., idx].masked_fill(j >= cum[-1], 0)


def trim_silence_host(
    audio: np.ndarray,
    sample_rate: int = SAMPLE_RATE,
    threshold_db: float = -40.0,
    min_gap_s: float = 1.0,
    keep_pad_s: float = 0.25,
) -> tuple[np.ndarray, list[tuple[float, float]]]:
    """Host-side silence removal that preserves a time map.

    Cuts only gaps LONGER than min_gap_s so natural pauses stay intact, and
    returns (trimmed_audio, kept_intervals) where kept_intervals is a list of
    (orig_start_s, orig_end_s) in the original timeline, in order.  Use
    utils.timestamps.TimeMap to map trimmed-time segment boundaries back.
    """
    hop = 160
    mask = _silence_keep_mask_np(
        np.asarray(audio, np.float32),
        frame_length=400,
        hop=hop,
        threshold_db=threshold_db,
        pad_frames=int(keep_pad_s * sample_rate / hop),
    )
    # collapse to kept intervals, merging gaps shorter than min_gap_s
    min_gap = int(min_gap_s * sample_rate / hop)
    bounds = mask_to_intervals(mask, len(audio), hop=hop, min_gap_frames=min_gap)
    if bounds is None:
        return audio, [(0.0, len(audio) / sample_rate)]
    pieces, intervals = [], []
    for s_smp, e_smp in bounds:
        pieces.append(audio[s_smp:e_smp])
        intervals.append((s_smp / sample_rate, e_smp / sample_rate))
    return np.concatenate(pieces) if pieces else audio, intervals


def mask_to_intervals(
    mask: np.ndarray,
    n_samples: int,
    hop: int = HOP_LENGTH,
    min_gap_frames: int = 100,
) -> list[tuple[int, int]] | None:
    """Per-hop keep mask -> kept (start, end) SAMPLE intervals, merging
    gaps shorter than min_gap_frames.  None when nothing is kept (caller
    keeps everything — an all-silent file stays intact)."""
    idx = np.flatnonzero(np.asarray(mask))
    if idx.size == 0:
        return None
    splits = np.flatnonzero(np.diff(idx) > min_gap_frames)
    starts = np.concatenate([[idx[0]], idx[splits + 1]])
    ends = np.concatenate([idx[splits], [idx[-1]]]) + 1
    return [
        (int(s) * hop, min(int(e) * hop, n_samples))
        for s, e in zip(starts, ends)
    ]


def _silence_keep_mask_np(
    audio: np.ndarray,
    frame_length: int = 400,
    hop: int = 160,
    threshold_db: float = -40.0,
    pad_frames: int = 25,
) -> np.ndarray:
    """Per-hop keep flags: frame RMS above (peak_db + threshold_db), dilated
    by pad_frames, via block-sum RMS (pure vectorised reductions).

    The 5-blocks-of-hop//2 framing assumes frame_length == 2.5 * hop (the
    400/160 Whisper STFT); other geometries are refused.
    """
    if (frame_length, hop) != (N_FFT, HOP_LENGTH):
        raise ValueError(
            f"_silence_keep_mask_np supports only the Whisper frame "
            f"geometry ({N_FFT}/{HOP_LENGTH}); got {frame_length}/{hop}"
        )
    n_frames = max(len(audio) // hop, 1)
    half = frame_length // 2
    block = hop // 2  # 80; frame f = blocks [2f, 2f+5) of the padded signal
    padded = np.pad(audio.astype(np.float32), (half, half))
    need = (2 * n_frames + 3) * block
    if len(padded) < need:
        padded = np.pad(padded, (0, need - len(padded)))
    x2 = padded[: (len(padded) // block) * block]
    x2 = x2 * x2  # stay f32: halves memory traffic; f64 accumulation below
    bsum = x2.reshape(-1, block).sum(axis=1, dtype=np.float64)
    energy = sum(bsum[k : k + 2 * n_frames : 2] for k in range(5))
    rms = np.sqrt(energy / frame_length + 1e-12)
    db = 20.0 * np.log10(rms + 1e-12)
    keep = db > (db.max() + threshold_db)
    if pad_frames > 0:
        kernel = np.ones(2 * pad_frames + 1)
        keep = np.convolve(keep.astype(np.float32), kernel, mode="same") > 0.5
    return keep
