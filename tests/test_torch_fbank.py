"""The port's kaldi fbank, framing and resampler against the JAX package's.

Inputs are made with numpy from a seed and handed to both.  ``fbank`` is
compared in float64 (``jax.enable_x64`` around the JAX call): in float32
both implementations round the 400-term DFT sums in their own order, and
at the deep spectral nulls of the lowest mel bins (DC removal and
pre-emphasis cancel there) each lands up to 8e-4 from the float64 value in
log space, so a float32 comparison would measure the two BLAS libraries,
not the algorithm.  The float32 path is held end to end through the
embedding net in ``test_torch_diarization_models.py``.
"""
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from audio_processor_tpu.ops import fbank as jfbank
from audio_processor_tpu.ops import frontend as jfrontend
from audio_processor_tpu.training.diarization_trainer import synth_voice
from audio_processor_tpu.utils import wavio as jwavio
from audio_processor_tpu_torch.ops import fbank, frontend
from audio_processor_tpu_torch.pipeline import ingest
from audio_processor_tpu_torch.runtime.device import set_full_fp32
from audio_processor_tpu_torch.utils import wavio

set_full_fp32()

# sub-frame, one frame exactly, an exact multiple of the hop past a frame,
# a 3 s embedding crop, and a ragged length
LENGTHS = [399, 400, 400 + 160 * 7, 48_000, 16_000 + 123]


def _signal(kind: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.normal(0, 0.1, (2, n))
    return np.stack([synth_voice(rng, f0, n, 16_000) for f0 in (110.0, 240.0)]).astype(
        np.float64) + rng.normal(0, 0.003, (2, n))


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("kind", ["noise", "voice"])
def test_fbank_equals_jax(kind, n):
    x = _signal(kind, n, n)
    with jax.enable_x64():
        want = np.asarray(jfbank.fbank(jnp.asarray(x, jnp.float64)))
    got = fbank.fbank(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, fbank.num_frames(n), 80)
    if want.size:
        assert np.abs(got - want).max() <= 1e-4


def test_fbank_options_equal_jax():
    x = _signal("voice", 4_000, 1)
    kw = dict(preemphasis=0.0, remove_dc=False, mean_norm=False)
    with jax.enable_x64():
        want = np.asarray(jfbank.fbank(jnp.asarray(x, jnp.float64), n_mels=64, **kw))
    got = fbank.fbank(torch.from_numpy(x), n_mels=64, **kw).numpy()
    assert np.abs(got - want).max() <= 1e-4
    np.testing.assert_array_equal(fbank.htk_mel_filterbank(64), jfbank.htk_mel_filterbank(64))


@pytest.mark.parametrize("n,n_frames", [(1_000, 4), (1_000, 7), (160 * 9 + 3, 9), (50, 2)])
def test_frame_signal_exact(n, n_frames):
    x = np.random.default_rng(n).normal(0, 1, (3, n)).astype(np.float32)
    want = np.asarray(jfrontend.frame_signal(jnp.asarray(x), n_frames))
    got = frontend.frame_signal(torch.from_numpy(x), n_frames).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("orig", [8_000, 22_050, 44_100, 48_000, 32_000, 11_025, 4_000])
@pytest.mark.parametrize("n", [1, 7, 1_000, 44_100])
def test_resample_equals_jax(orig, n):
    x = np.random.default_rng(orig + n).normal(0, 0.3, n).astype(np.float32)
    want = np.asarray(jfrontend.resample(jnp.asarray(x), orig, 16_000))
    got = frontend.resample(torch.from_numpy(x), orig, 16_000).numpy()
    assert got.shape == want.shape == (-(-n * 16_000 // orig),)
    assert np.abs(got - want).max() <= 1e-5


@pytest.mark.parametrize("orig,n", [(44_100, 160_000), (22_050, 60_000), (8_000, 1_000),
                                    (48_000, 44_100), (44_100, 7)])
def test_resample_equals_float64_upfirdn(orig, n):
    """The same filter through scipy's upfirdn in float64 (upsample by up,
    convolve, keep every down-th sample from JAX's offset).  At 44.1 kHz
    and 160,000 samples, and at 22.05 kHz and 60,000, the JAX reference's
    dilated conv on XLA:CPU returns values near 1e33, so these lengths are
    held against float64 instead."""
    from scipy.signal import upfirdn

    g = math.gcd(orig, 16_000)
    up, down = 16_000 // g, orig // g
    rhs = frontend._resample_kernel(up, down).astype(np.float64)[::-1]
    half = len(rhs) // 2
    shift = (-half) % down  # zeros before the filter put JAX's offset on the grid
    x = np.random.default_rng(n).normal(0, 0.3, n).astype(np.float32)
    y = upfirdn(np.concatenate([np.zeros(shift), rhs]), x.astype(np.float64), up, down)
    n_out = -(-n * up // down)
    want = y[(half + shift) // down:][:n_out]
    got = frontend.resample(torch.from_numpy(x), orig).numpy()
    assert got.shape == want.shape == (n_out,)
    assert np.abs(got - want).max() <= 1e-5


def test_resample_same_rate_is_identity():
    x = torch.arange(5, dtype=torch.float32)
    assert frontend.resample(x, 16_000) is x
    np.testing.assert_array_equal(frontend.resample_host(x.numpy(), 16_000), x.numpy())


def test_wav_at_other_rates_resamples_in_process(tmp_path):
    """A 44.1 kHz WAV decodes in-process to what the JAX frontend's
    resampler gives for the same samples (both packages' ingest take their
    native resampler, a windowed sinc of the same taps)."""
    x = np.random.default_rng(3).normal(0, 0.2, 44_100 + 17).astype(np.float32)
    path = str(tmp_path / "a.wav")
    wavio.write_wav(path, x, 44_100)
    samples, rate = jwavio.read_wav_mono(path)
    want = np.asarray(jfrontend.resample(jnp.asarray(samples), rate, 16_000))
    got = ingest.load_audio(path)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5
    assert len(ingest.load_audio(path, max_s=0.5)) == 8_000
