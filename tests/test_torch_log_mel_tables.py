"""Kernel A's host tables (``ops/kernels/log_mel.four_step_tables``).

The CUDA kernel runs only on the card; what it reads is built here on the
CPU.  A plain float32 four-step FFT built from exactly those tables, in
the kernel's order (stage 1 over n1 with hann and twiddle folded in,
stage 2 over n2, the bins folded at 200, the sparse mel from the band
table), must reproduce the plain log-mel (``frontend.log_mel_spectrogram``)
at the 1e-4 the kernel is held to; and the band table scattered back to
dense must be the filterbank exactly.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from audio_processor_tpu_torch.ops import frontend
from audio_processor_tpu_torch.ops.kernels import log_mel as lm
from audio_processor_tpu_torch.runtime.device import set_full_fp32

set_full_fp32()


def _kept_bins() -> np.ndarray:
    """(11, 20): the rfft bin of stage-2 output (k1, k2), m = k1 + 20*k2
    folded to 400 - m past 200; -1 where the kernel keeps no output
    (columns 0 and 10 past bin 200, which repeat kept bins)."""
    m = np.arange(lm.STAGE1_COLS)[:, None] + lm.RADIX * np.arange(lm.RADIX)[None, :]
    bins = np.where(m <= 200, m, 400 - m)
    for k1 in (0, lm.STAGE1_COLS - 1):
        bins[k1] = np.where(m[k1] <= 200, bins[k1], -1)
    return bins


def four_step_log_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    tab = {k: torch.from_numpy(v) for k, v in lm.four_step_tables(n_mels).items()}
    n_frames = audio.shape[-1] // frontend.HOP_LENGTH
    padded = F.pad(audio[:, None], (200, 200), mode="reflect")[:, 0]
    frames = padded.unfold(-1, 400, 160)[:, :n_frames]  # (B, nf, 400)
    poly = frames.reshape(*frames.shape[:2], lm.RADIX, lm.RADIX)  # [.., n1, n2]
    s1 = tab["stage1"][..., : lm.STAGE1_COLS]  # (n2, n1, 2, 11)
    zr = torch.einsum("zfab,bak->zfbk", poly, s1[:, :, 0])
    zi = torch.einsum("zfab,bak->zfbk", poly, s1[:, :, 1])  # (B, nf, n2, k1)
    wr, wi = tab["w20"][:, 0], tab["w20"][:, 1]  # (n2, k2)
    xr = torch.einsum("zfnk,nj->zfkj", zr, wr) - torch.einsum("zfnk,nj->zfkj", zi, wi)
    xi = torch.einsum("zfnk,nj->zfkj", zr, wi) + torch.einsum("zfnk,nj->zfkj", zi, wr)
    bins = _kept_bins()
    keep = bins >= 0
    power = torch.zeros(*frames.shape[:2], 201)
    power[..., bins[keep]] = (xr * xr + xi * xi)[..., torch.from_numpy(keep)]
    mel = torch.zeros(*frames.shape[:2], n_mels)
    for m, (start, count, off) in enumerate(tab["bands"].tolist()):
        mel[..., m] = power[..., start:start + count] @ tab["weights"][off:off + count]
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(-2, -1), keepdim=True) - 8.0)
    return ((log_spec + 4.0) / 4.0).transpose(-1, -2)


def test_kept_bins_cover_every_rfft_bin_once():
    bins = _kept_bins()
    assert sorted(bins[bins >= 0].tolist()) == list(range(201))


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("n_samples", [480_000, 16_000 * 7 + 123])
def test_four_step_from_tables_matches_plain_log_mel(n_mels, n_samples):
    audio = np.random.default_rng(n_mels + n_samples).normal(0, 0.2, (2, n_samples))
    audio = torch.from_numpy(audio.astype(np.float32))
    audio[1] *= 1e-3  # a quiet window: the clamp and log must still agree
    got = four_step_log_mel(audio, n_mels)
    want = frontend.log_mel_spectrogram(audio, n_mels)
    assert got.shape == want.shape == (2, n_mels, n_samples // 160)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("n_mels", [80, 128])
def test_band_table_scatters_back_to_the_filterbank(n_mels):
    tab = lm.four_step_tables(n_mels)
    dense = np.zeros((n_mels, 201), np.float32)
    for m, (start, count, off) in enumerate(tab["bands"]):
        dense[m, start:start + count] = tab["weights"][off:off + count]
    np.testing.assert_array_equal(dense, frontend.mel_filterbank(n_mels))
    assert tab["bands"][:, 1].max() <= 14 and tab["weights"].dtype == np.float32


def test_stage1_and_w20_tables_are_the_four_step_dft():
    """Stage 1 then stage 2 on a float64 frame gives |rfft(hann * x)|^2."""
    tab = lm.four_step_tables(80)
    x = np.random.default_rng(0).normal(size=400)
    poly = x.reshape(lm.RADIX, lm.RADIX)  # [n1, n2]
    s1 = tab["stage1"][..., : lm.STAGE1_COLS].astype(np.float64)
    z = np.einsum("ab,bak->bk", poly, s1[:, :, 0]) + 1j * np.einsum("ab,bak->bk", poly, s1[:, :, 1])
    w = tab["w20"][:, 0].astype(np.float64) + 1j * tab["w20"][:, 1]
    big = z.T @ w  # (k1, k2)
    bins = _kept_bins()
    window = 0.5 * (1 - np.cos(2 * np.pi * np.arange(400) / 400))
    want = np.abs(np.fft.rfft(window * x)) ** 2
    np.testing.assert_allclose(np.abs(big[bins >= 0]) ** 2, want[bins[bins >= 0]],
                               rtol=1e-5, atol=1e-5 * want.max())
    assert not tab["stage1"][..., lm.STAGE1_COLS:].any()
