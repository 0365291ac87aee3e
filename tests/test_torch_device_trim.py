"""The port's device trim (``silence_mask``, ``gather_kept_intervals``) and
``fbank.htk_mel_to_hz`` against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both.  The keep
flags must be equal; where one differs, the assertion reports the float64
margin of each differing frame's level from the cut, since float32 sums
of 400 squares may round apart in the two libraries.  The gather is a pure
index, so it must be bit-equal.  Config 2's device chain (``benchmarks/
run_configs.py``: int16 -> resample -> mask -> intervals -> gather ->
log-mel) runs at 3 s of 44.1 kHz audio: from about 150,000 input samples
the JAX resampler's dilated conv on XLA:CPU returns values near 1e17-1e33
or NaN on some calls (the port's resampler is held to float64 ``upfirdn``
at such lengths in ``test_torch_fbank.py``).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_processor_tpu.ops import fbank as jfbank
from audio_processor_tpu.ops import frontend as jfrontend
from audio_processor_tpu_torch.ops import fbank, frontend
from audio_processor_tpu_torch.ops.kernels.log_mel import log_mel
from audio_processor_tpu_torch.runtime.device import set_full_fp32

set_full_fp32()


def _levels(shape, seed: int, seg: int = 200) -> np.ndarray:
    """Noise whose level jumps every ``seg`` samples (log-uniform over
    80 dB), each row scaled 20 dB under the one before: the cuts at -20
    and -40 dB keep different frames, and a row's peak is its own."""
    rng = np.random.default_rng(seed)
    n = shape[-1]
    gains = 10.0 ** rng.uniform(-4, 0, (*shape[:-1], -(-n // seg)))
    x = rng.normal(0, 0.3, shape) * np.repeat(gains, seg, axis=-1)[..., :n]
    if len(shape) > 1:
        x *= (10.0 ** -np.arange(shape[0]))[:, None]
    return x.astype(np.float32)


def _db64(x: np.ndarray) -> np.ndarray:
    """Each frame's level in float64, framed as ``silence_mask`` frames."""
    frames = np.asarray(jfrontend.frame_signal(
        jnp.asarray(np.pad(x, [(0, 0)] * (x.ndim - 1) + [(200, 200)])),
        max(x.shape[-1] // 160, 1))).astype(np.float64)
    return 20.0 * np.log10(np.sqrt((frames * frames).mean(-1) + 1e-12) + 1e-12)


def _assert_flags_equal(x: np.ndarray, threshold_db: float, pad_frames: int) -> np.ndarray:
    want = np.asarray(jfrontend.silence_mask(
        jnp.asarray(x), threshold_db=threshold_db, pad_frames=pad_frames))
    got = frontend.silence_mask(torch.from_numpy(x), threshold_db=threshold_db,
                                pad_frames=pad_frames)
    assert got.dtype == torch.bool and got.device.type == "cpu"
    got = got.numpy()
    assert got.shape == want.shape
    if not np.array_equal(got, want):
        raw_j = np.asarray(jfrontend.silence_mask(jnp.asarray(x), threshold_db=threshold_db,
                                                  pad_frames=0))
        raw_t = frontend.silence_mask(torch.from_numpy(x), threshold_db=threshold_db,
                                      pad_frames=0).numpy()
        db = _db64(x)
        margin = db - (db.max(-1, keepdims=True) + threshold_db)
        pytest.fail(f"{int((got != want).sum())} flags differ; float64 margins (dB) of the "
                    f"raw frames that differ: {margin[raw_j != raw_t].tolist()}")
    return got


@pytest.mark.parametrize("threshold_db", [-40.0, -20.0])
@pytest.mark.parametrize("pad_frames", [0, 25])
@pytest.mark.parametrize("n", [50, 160 * 9 + 3, 16_000, 8 * 16_000])
@pytest.mark.parametrize("batched", [False, True], ids=["1d", "3rows"])
def test_silence_mask_flags_equal_jax(batched, n, pad_frames, threshold_db):
    x = _levels((3, n) if batched else (n,), n + 7 * pad_frames)
    got = _assert_flags_equal(x, threshold_db, pad_frames)
    assert got.shape == ((3,) if batched else ()) + (max(n // 160, 1),)


@pytest.mark.parametrize("shape", [(50,), (16_000,), (2, 4_000)])
def test_silence_mask_all_zero_keeps_everything(shape):
    """Every frame's level is equal, so none lies under the cut."""
    got = _assert_flags_equal(np.zeros(shape, np.float32), -40.0, 25)
    assert got.all()


def test_silence_mask_levels_cut_where_jax_cuts():
    """The -20 dB cut drops frames the -40 dB cut keeps, and the test
    signal reaches both (so the cases above are not all-keep)."""
    x = _levels((8 * 16_000,), 3)
    loose = _assert_flags_equal(x, -40.0, 0)
    tight = _assert_flags_equal(x, -20.0, 0)
    assert 0.05 < tight.mean() < loose.mean() < 0.95


@pytest.mark.parametrize("geometry", [(512, 160), (400, 128), (320, 160)])
def test_silence_mask_refuses_other_geometry(geometry):
    x = np.zeros(4_000, np.float32)
    with pytest.raises(ValueError) as want:
        jfrontend.silence_mask(jnp.asarray(x), *geometry)
    with pytest.raises(ValueError) as got:
        frontend.silence_mask(torch.from_numpy(x), *geometry)
    assert str(got.value) == str(want.value)


def test_silence_mask_rows_do_not_bleed():
    """Row 0 is loud only at its very end and row 1 only in its middle: a
    dilation over the flattened batch would carry row 0's end into row 1's
    start.  Row 2 is 50 dB under row 0, with a floor 20 dB under its own
    burst: its own peak keeps all of it, one peak over the batch would
    drop its floor."""
    n = 4 * 16_000
    rng = np.random.default_rng(11)
    x = rng.normal(0, 1e-4, (3, n)).astype(np.float32)
    x[0, -1_600:] += rng.normal(0, 0.3, 1_600).astype(np.float32)
    x[1, n // 2: n // 2 + 1_600] += rng.normal(0, 0.3, 1_600).astype(np.float32)
    x[2] *= 10.0
    x[2, n // 2: n // 2 + 800] += rng.normal(0, 0.01, 800).astype(np.float32)
    batch = _assert_flags_equal(x, -40.0, 25)
    for r in range(3):
        alone = frontend.silence_mask(torch.from_numpy(x[r])).numpy()
        np.testing.assert_array_equal(batch[r], alone)
    assert not batch[0, :100].any() and batch[0, -10:].all()
    assert not batch[1, :100].any() and not batch[1, -100:].any()
    assert batch[2].all()


def _table(bounds, k_pad: int) -> tuple[np.ndarray, np.ndarray]:
    """Config 2's int32 interval table: starts and cumulative ends, padded
    to ``k_pad`` by repeating the last start over a plateau."""
    lens = np.array([e - s for s, e in bounds], np.int64)
    starts = np.full(k_pad, bounds[-1][0], np.int32)
    cum = np.full(k_pad, int(lens.sum()), np.int32)
    starts[: len(bounds)] = [s for s, _ in bounds]
    cum[: len(bounds)] = np.cumsum(lens)
    return starts, cum


def _gather_both(audio, starts, cum, n_out):
    want = np.asarray(jfrontend.gather_kept_intervals(
        jnp.asarray(audio), jnp.asarray(starts), jnp.asarray(cum), n_out))
    got = frontend.gather_kept_intervals(torch.from_numpy(audio), torch.from_numpy(starts),
                                         torch.from_numpy(cum), n_out).numpy()
    return got, want


@pytest.mark.parametrize("case", [
    dict(k=1, k_pad=1, n_out=512),
    dict(k=1, k_pad=4, n_out=100),
    dict(k=5, k_pad=8, n_out=4_096),
    dict(k=5, k_pad=8, n_out=300),
    dict(k=7, k_pad=7, n_out=2_000, rows=2),
    dict(k=3, k_pad=16, n_out=8_192, rows=3),
], ids=["k1", "k1_padded_short", "k5_long", "k5_short", "k7_2rows", "k3_padded_3rows"])
def test_gather_kept_intervals_bit_equal_jax(case):
    rng = np.random.default_rng(case["k"] * 100 + case["n_out"])
    n = 3_000
    shape = (case["rows"], n) if "rows" in case else (n,)
    audio = rng.normal(0, 0.3, shape).astype(np.float32)
    cuts = np.sort(rng.choice(np.arange(1, n), 2 * case["k"], replace=False))
    bounds = [(int(cuts[2 * i]), int(cuts[2 * i + 1])) for i in range(case["k"])]
    starts, cum = _table(bounds, case["k_pad"])
    got, want = _gather_both(audio, starts, cum, case["n_out"])
    assert got.shape == want.shape == (*shape[:-1], case["n_out"])
    np.testing.assert_array_equal(got, want)
    # the numpy concatenation of the same bounds, zero past the kept length
    kept = np.concatenate([audio[..., s:e] for s, e in bounds], axis=-1)
    m = min(kept.shape[-1], case["n_out"])
    np.testing.assert_array_equal(got[..., :m], kept[..., :m])
    assert not got[..., kept.shape[-1]:].any()


def test_gather_kept_intervals_stays_on_the_input_device():
    audio = torch.arange(10, dtype=torch.float32)
    out = frontend.gather_kept_intervals(audio, torch.tensor([2, 7], dtype=torch.int32),
                                         torch.tensor([3, 5], dtype=torch.int32), 8)
    assert out.dtype == audio.dtype and out.device == audio.device
    assert out.tolist() == [2, 3, 4, 7, 8, 0, 0, 0]


def _tone_bursts(spans, seconds: float, sr: int, seed: int, hz: float = 280.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    audio = np.zeros(int(seconds * sr), np.float32)
    for a, b in spans:
        seg = np.arange(int((b - a) * sr)) / sr
        audio[int(a * sr): int(a * sr) + len(seg)] = 0.5 * np.sin(2 * np.pi * hz * seg)
    return audio + rng.normal(0, 1e-4, len(audio)).astype(np.float32)


def test_device_gather_matches_host_trim():
    """JAX's test of the same name on the port: the device trim
    concatenates exactly the samples ``trim_silence_host`` keeps, and
    equals JAX's device trim on the same audio."""
    sr = 16_000
    audio = _tone_bursts(((1.0, 2.2), (4.5, 5.1), (6.8, 7.4)), 8, sr, 7)
    trimmed, _ = frontend.trim_silence_host(audio, sr)

    mask = frontend.silence_mask(torch.from_numpy(audio)).numpy()
    np.testing.assert_array_equal(mask, np.asarray(jfrontend.silence_mask(jnp.asarray(audio))))
    bounds = frontend.mask_to_intervals(mask, len(audio), min_gap_frames=100)
    assert bounds is not None and len(bounds) == 3
    n_kept = sum(e - s for s, e in bounds)
    assert n_kept == len(trimmed)
    starts, cum = _table(bounds, 4)
    n_out = 1 << int(np.ceil(np.log2(n_kept + 1)))
    got, want = _gather_both(audio, starts, cum, n_out)
    np.testing.assert_array_equal(got[:n_kept], trimmed)
    assert not got[n_kept:].any()
    np.testing.assert_array_equal(got, want)


def _config2_device_chain(ops, x16: np.ndarray, to, f32, mel) -> tuple:
    """Config 2's ``preprocess_device`` (``run_configs.py:154-172``) through
    one package's functions: dequantise, resample, mask, intervals on the
    host, the padded table, gather, windows, log-mel."""
    a = ops.resample(f32(to(x16)) / 32768.0, 44_100, 16_000)
    mask = np.asarray(ops.silence_mask(a))
    n16 = int(a.shape[-1])
    bounds = ops.mask_to_intervals(mask, n16, min_gap_frames=100) or [(0, n16)]
    n_kept = sum(e - s for s, e in bounds)
    b = 1 << max(0, -(-n_kept // ops.N_SAMPLES) - 1).bit_length()
    starts, cum = _table(bounds, 1 << max(0, len(bounds) - 1).bit_length())
    kept = ops.gather_kept_intervals(a, to(starts), to(cum), b * ops.N_SAMPLES)
    return mask, bounds, np.asarray(mel(kept.reshape(-1, ops.N_SAMPLES)))


def test_config2_device_chain_small_equals_jax():
    """Config 2's device chain on 3 s of 44.1 kHz int16 (two bursts about
    a 1.6 s pause, which the trim cuts): the same mask, intervals and
    windows as JAX's chain, and the port's log-mel (kernel A's wrapper,
    its plain version on the CPU) within 1e-4 of JAX's
    ``log_mel_spectrogram``."""
    sr = 44_100
    x = _tone_bursts(((0.05, 0.7), (2.3, 2.95)), 3, sr, 21, hz=160.0)
    x16 = np.clip(x * 32767.0, -32768, 32767).astype(np.int16)
    assert len(x16) == 132_300
    jmask, jbounds, want = _config2_device_chain(
        jfrontend, x16, jnp.asarray, lambda v: v.astype(jnp.float32),
        jfrontend.log_mel_spectrogram)
    assert np.isfinite(want).all()
    mask, bounds, got = _config2_device_chain(
        frontend, x16, torch.from_numpy, lambda v: v.to(torch.float32),
        lambda w: log_mel(w.contiguous()).numpy())
    np.testing.assert_array_equal(mask, jmask)
    assert bounds == jbounds and len(bounds) == 2
    assert sum(e - s for s, e in bounds) < 0.7 * 48_000  # the pause was cut
    assert got.shape == want.shape == (1, 80, frontend.N_FRAMES)
    assert np.abs(got - want).max() <= 1e-4


def test_htk_mel_to_hz_equals_jax_and_inverts():
    hz = np.array([0.0, 20.0, 440.0, 1_000.0, 7_999.5, 8_000.0])
    mel = fbank.hz_to_htk_mel(hz)
    np.testing.assert_array_equal(fbank.htk_mel_to_hz(mel), jfbank.htk_mel_to_hz(mel))
    np.testing.assert_allclose(fbank.htk_mel_to_hz(mel), hz, rtol=1e-12, atol=1e-9)
    assert fbank.htk_mel_to_hz(mel).dtype == np.float64


def probe_jax_resample(lengths, tries: int) -> dict:
    """How often JAX's ``resample`` from 44.1 kHz returns a non-finite or
    absurd value (|y| >= 10 from |x| ~ 1) on this host's XLA:CPU: one call
    a seed, ``tries`` seeds a length."""
    bad = {}
    for n in lengths:
        bad[n] = 0
        for seed in range(tries):
            x = np.random.default_rng(seed).normal(0, 0.3, n).astype(np.float32)
            y = np.asarray(jfrontend.resample(jnp.asarray(x), 44_100, 16_000))
            bad[n] += not (np.isfinite(y).all() and np.abs(y).max() < 10)
    return bad


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_device_trim.py: the lengths
    # ROADMAP.md §3 records
    import json

    import conftest  # noqa: F401  (JAX on the CPU, as the suite runs it)

    lengths = [44_100, 88_200, 132_300, 150_000, 160_000, 176_400, 220_500, 264_600,
               352_800, 441_000]
    print(json.dumps({"tries": 5, "bad_calls": probe_jax_resample(lengths, 5)}))
