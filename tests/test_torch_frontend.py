"""The port's log-mel frontend against the JAX package's.

The plain PyTorch log-mel (the CPU side of kernel A's wrapper) must match
both the JAX frontend and its Pallas kernel (interpret mode) at the JAX
suite's 1e-4 tolerance, and the host silence trim must cut the same
intervals.  TF32 is off (runtime.device.set_full_fp32) for every run.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_processor_tpu.ops import frontend as jfrontend
from audio_processor_tpu.ops.pallas.mel_kernel import log_mel_pallas
from audio_processor_tpu_torch.ops import frontend
from audio_processor_tpu_torch.ops.kernels.log_mel import log_mel
from audio_processor_tpu_torch.runtime.device import set_full_fp32

set_full_fp32()


@pytest.mark.parametrize("n_mels", [80, 128])
def test_plain_log_mel_matches_jax_and_pallas(rng, n_mels):
    audio = rng.normal(0, 0.2, (1, frontend.N_SAMPLES)).astype(np.float32)
    ours = frontend.log_mel_spectrogram(torch.from_numpy(audio), n_mels).numpy()
    ref = np.asarray(jfrontend.log_mel_spectrogram(jnp.asarray(audio), n_mels=n_mels))
    pallas = np.asarray(log_mel_pallas(jnp.asarray(audio), n_mels=n_mels, interpret=True))
    assert ours.shape == ref.shape == (1, n_mels, frontend.N_FRAMES)
    np.testing.assert_allclose(ours, ref, atol=1e-4)
    np.testing.assert_allclose(ours, pallas, atol=1e-4)


def _config2_window(seed):
    """Config 2's signal (``benchmarks/run_configs.py:100-105``) made at
    16 kHz: one 30 s window of a gated 160 Hz tone over noise ``seed``."""
    tt = np.arange(frontend.N_SAMPLES) / frontend.SAMPLE_RATE
    noise = np.random.default_rng(seed).normal(0, 0.01, len(tt))
    return (np.sin(2 * np.pi * 160 * tt) * (np.sin(2 * np.pi * 0.9 * tt) > -0.4) * 0.3
            + noise).astype(np.float32)[None]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_log_mel_matches_jax_on_config2_signal(seed):
    """A low tone's lowest mel bins: float32 DFT sums there cancel and
    missed JAX by up to 1.3e-4 before the products went to float64."""
    audio = _config2_window(seed)
    ours = frontend.log_mel_spectrogram(torch.from_numpy(audio)).numpy()
    ref = np.asarray(jfrontend.log_mel_spectrogram(jnp.asarray(audio)))
    assert ours.shape == ref.shape == (1, 80, frontend.N_FRAMES)
    np.testing.assert_allclose(ours, ref, atol=1e-4)


def test_plain_log_mel_any_length_and_batch_dims(rng):
    """Any static length, any leading dims (the JAX frontend's contract)."""
    audio = rng.normal(0, 0.2, (2, 3, 16_000 * 3 + 77)).astype(np.float32)
    ours = frontend.log_mel_spectrogram(torch.from_numpy(audio)).numpy()
    ref = np.asarray(jfrontend.log_mel_spectrogram(jnp.asarray(audio)))
    assert ours.shape == ref.shape == (2, 3, 80, (16_000 * 3 + 77) // 160)
    np.testing.assert_allclose(ours, ref, atol=1e-4)


def test_kernel_wrapper_runs_plain_version_on_cpu(rng):
    audio = rng.normal(0, 0.1, (2, 16_000 * 2)).astype(np.float32)
    before = log_mel.launches
    out = log_mel(torch.from_numpy(audio))
    want = frontend.log_mel_spectrogram(torch.from_numpy(audio))
    assert torch.equal(out, want)
    assert log_mel.launches == before  # the kernel never launched


def test_bases_and_filterbank_equal_jax():
    for a, b in zip(frontend.dft_bases(), jfrontend.dft_bases()):
        np.testing.assert_array_equal(a, b)
    for n_mels in (80, 128):
        np.testing.assert_array_equal(
            frontend.mel_filterbank(n_mels), jfrontend.mel_filterbank(n_mels)
        )


def _gappy_audio(rng):
    sr = 16_000
    x = rng.normal(0, 0.2, 12 * sr).astype(np.float32)
    x[2 * sr: 5 * sr] = 0.0  # 3 s gap: cut
    x[7 * sr: int(7.5 * sr)] = 0.0  # 0.5 s pause: kept
    x[10 * sr:] *= 1e-4  # quiet tail
    return x


@pytest.mark.parametrize("which", ["speech_like", "gappy"])
def test_trim_silence_host_matches_jax(rng, speech_like_audio, which):
    audio = speech_like_audio if which == "speech_like" else _gappy_audio(rng)
    ours, ours_iv = frontend.trim_silence_host(audio)
    ref, ref_iv = jfrontend.trim_silence_host(audio)
    assert ours_iv == ref_iv
    np.testing.assert_array_equal(ours, ref)


def test_pad_or_trim():
    x = torch.arange(10.0)
    assert torch.equal(frontend.pad_or_trim(x, 4), x[:4])
    assert torch.equal(frontend.pad_or_trim(x, 12)[10:], torch.zeros(2))
    assert frontend.pad_or_trim(x, 10) is x
