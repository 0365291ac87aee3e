"""The port's native WAV decoder and resampler against the JAX package's.

The cases of ``tests/test_native_audio.py`` run against the port's
``native.audio_io`` and ``pipeline.ingest``; then, on the same seeded
files, the port's decode, resample and DTW must equal the JAX package's
``native/audio_io`` bit for bit, and the port's ``ingest.load_audio``
must equal JAX's exactly, bounded and unbounded.  The port builds its own
copy of ``audio_io.cc`` with g++ at first use, under a name of its own.
"""
import os
import struct
import subprocess
import sys
import threading

import numpy as np
import pytest
from scipy.signal import resample_poly

from audio_processor_tpu.native import audio_io as jaudio_io
from audio_processor_tpu.pipeline import ingest as jingest
from audio_processor_tpu_torch.native import audio_io, build
from audio_processor_tpu_torch.ops import frontend
from audio_processor_tpu_torch.ops.kernels import dtw as dtw_mod
from audio_processor_tpu_torch.pipeline import ingest
from audio_processor_tpu_torch.utils import wavio

pytestmark = pytest.mark.skipif(build.cxx() is None, reason="no C++ compiler (g++)")

RATES = (8_000, 22_050, 44_100, 48_000)


@pytest.fixture(scope="module", autouse=True)
def built():
    """Both packages' libraries, built before any case runs."""
    status = audio_io.build_status()
    assert status["built"], status
    assert jaudio_io.available()
    return status


# ---------------------------------------------------------------------------
# the JAX suite's cases, on the port
# ---------------------------------------------------------------------------

def test_native_decode_resamples_to_16k(tmp_path):
    sr = 44100
    t = np.arange(sr) / sr
    x = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    p = str(tmp_path / "a.wav")
    wavio.write_wav(p, x, sr)
    y, rate = audio_io.decode(p, 16000)
    assert rate == 16000
    assert abs(len(y) - 16000) <= 1
    spec = np.abs(np.fft.rfft(y[1000:13000] * np.hanning(12000)))
    assert abs(np.argmax(spec) * 16000 / 12000 - 440) < 3


def test_native_matches_scipy_resampler():
    """Compare on band-limited content (filters legitimately differ near
    Nyquist: different kaiser beta / tap count than scipy's default)."""
    t = np.arange(48000) / 48000
    x = sum(
        np.sin(2 * np.pi * f * t + i) for i, f in enumerate((220, 880, 2500, 5000))
    ).astype(np.float32)
    y = audio_io.resample(x, 48000, 16000)
    ref = resample_poly(x.astype(np.float64), 1, 3)
    m = min(len(y), len(ref))
    assert np.abs(y[500 : m - 500] - ref[500 : m - 500]).max() < 5e-3


def test_native_stereo_downmix_and_info(tmp_path):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 0.1, (16000, 2)).astype(np.float32)
    p = str(tmp_path / "s.wav")
    wavio.write_wav(p, x, 16000)
    info = audio_io.wav_info(p)
    assert info == {"sample_rate": 16000, "channels": 2, "bits": 16}
    y, _ = audio_io.decode(p, 16000)
    ref = x.mean(axis=1)
    assert np.abs(y - ref).max() < 1e-3


def test_native_rejects_garbage(tmp_path):
    p = str(tmp_path / "bad.wav")
    with open(p, "wb") as f:
        f.write(b"this is not a wav file at all, sorry")
    with pytest.raises(ValueError):
        audio_io.decode(p)


def test_ingest_uses_native_path(tmp_path, monkeypatch):
    x = np.sin(2 * np.pi * 300 * np.arange(22050) / 22050).astype(np.float32) * 0.4
    p = str(tmp_path / "i.wav")
    wavio.write_wav(p, x, 22050)
    calls = []
    decode = audio_io.decode
    monkeypatch.setattr(audio_io, "decode", lambda *a: calls.append(a) or decode(*a))
    y = ingest.load_audio(p)
    assert calls == [(p, 16_000)]
    assert abs(len(y) - 16000) <= 2
    assert y.dtype == np.float32


def _raw_wav(sample_rate: int, n_samples: int = 64) -> bytes:
    """Hand-build a PCM16 mono WAV with an arbitrary (possibly hostile)
    header-declared sample rate."""
    data = (np.zeros(n_samples, np.int16)).tobytes()
    fmt = struct.pack("<HHIIHH", 1, 1, sample_rate & 0xFFFFFFFF,
                      (sample_rate * 2) & 0xFFFFFFFF, 2, 16)
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
    body += b"data" + struct.pack("<I", len(data)) + data
    return b"RIFF" + struct.pack("<I", len(body)) + body


@pytest.mark.parametrize("rate", [0, 0xFFFFFFFF, 10_000_000])
def test_native_rejects_hostile_sample_rates(tmp_path, rate):
    """sample_rate=0 must not reach an integer division in the resampler,
    and an absurd rate must not allocate a multi-GB polyphase kernel: both
    fail cleanly."""
    p = str(tmp_path / f"evil_{rate}.wav")
    with open(p, "wb") as f:
        f.write(_raw_wav(rate))
    with pytest.raises(ValueError):
        audio_io.decode(p)


def test_native_accepts_boundary_sample_rate(tmp_path):
    p = str(tmp_path / "hi.wav")
    with open(p, "wb") as f:
        f.write(_raw_wav(768_000, n_samples=768))
    y, rate = audio_io.decode(p, 16000)
    assert rate == 16000 and len(y) >= 1


def test_wavio_truncated_fmt_raises_valueerror(tmp_path):
    """A fmt chunk whose declared body runs past EOF must raise ValueError
    (not struct.error): ingest's decoder chain catches ValueError only."""
    body = b"WAVE" + b"junk" + struct.pack("<I", 4) + b"\0\0\0\0"
    body += b"fmt " + struct.pack("<I", 16)  # declared 16-byte body, absent
    blob = b"RIFF" + struct.pack("<I", len(body)) + body
    p = str(tmp_path / "trunc.wav")
    with open(p, "wb") as f:
        f.write(blob)
    with pytest.raises(ValueError):
        wavio.read_wav(p)


def test_wav_out_size_matches_decode(tmp_path):
    """The header-only size query agrees with the full decode for
    resampled and passthrough rates."""
    lib = audio_io._load()
    for sr, n in [(22050, 22050), (16000, 12345), (8000, 777), (44100, 100)]:
        x = np.sin(2 * np.pi * 220 * np.arange(n) / sr).astype(np.float32)
        p = str(tmp_path / f"s{sr}_{n}.wav")
        wavio.write_wav(p, x, sr)
        y, _ = audio_io.decode(p, 16000)
        with open(p, "rb") as f:
            data = f.read()
        assert lib.aptpu_wav_out_size(data, len(data), 16000) == len(y)


# ---------------------------------------------------------------------------
# the port against the JAX package, bit for bit
# ---------------------------------------------------------------------------

def _seeded_wav(tmp_path, sr: int, channels: int, seconds: float = 2.5, seed: int = 0) -> str:
    rng = np.random.default_rng(seed + sr + channels)
    n = int(seconds * sr)
    shape = (n, channels) if channels > 1 else (n,)
    t = np.arange(n) / sr
    tone = 0.3 * np.sin(2 * np.pi * 330 * t)
    x = rng.normal(0, 0.1, shape) + (tone[:, None] if channels > 1 else tone)
    p = str(tmp_path / f"seeded_{sr}_{channels}.wav")
    wavio.write_wav(p, x.astype(np.float32), sr)
    return p


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("sr", RATES)
def test_decode_and_resample_equal_jax(tmp_path, sr, channels):
    p = _seeded_wav(tmp_path, sr, channels)
    got, rate = audio_io.decode(p, 16_000)
    want, jrate = jaudio_io.decode(p, 16_000)
    assert rate == jrate == 16_000
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert audio_io.wav_info(p) == jaudio_io.wav_info(p) == {
        "sample_rate": sr, "channels": channels, "bits": 16}
    samples, _ = wavio.read_wav_mono(p)
    np.testing.assert_array_equal(audio_io.resample(samples, sr, 16_000),
                                  jaudio_io.resample(samples, sr, 16_000))


@pytest.mark.parametrize("max_s", [None, 1.25])
@pytest.mark.parametrize("sr", RATES)
def test_load_audio_equals_jax(tmp_path, sr, max_s):
    """Unbounded loads take the native decoder, bounded ones the Python
    reader and the native resampler, in both packages."""
    p = _seeded_wav(tmp_path, sr, 2 if sr in (22_050, 48_000) else 1)
    got = ingest.load_audio(p, max_s=max_s)
    want = jingest.load_audio(p, max_s=max_s)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if max_s is not None:
        assert len(got) == int(max_s * 16_000)


def test_dtw_equals_jax_and_the_wavefront_twin():
    """The source's ``aptpu_dtw``: equal to the JAX package's library and
    to the port's numpy DTW (ties included: integer costs)."""
    rng = np.random.default_rng(7)
    for t, ta in ((5, 40), (17, 17), (1, 9), (30, 120)):
        cost = rng.integers(0, 4, (t, ta)).astype(np.float32)
        got = audio_io.dtw(cost)
        np.testing.assert_array_equal(got, jaudio_io.dtw(cost))
        np.testing.assert_array_equal(got, dtw_mod.dtw_wavefront(cost[None], t, ta)[0])


# ---------------------------------------------------------------------------
# fallbacks and the build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sr", [22_050, 44_100])
def test_without_the_library_ingest_takes_the_python_reader(tmp_path, monkeypatch, sr):
    """No native library: the pure-Python reader and ``resample_host``,
    within 2e-7 of the native path (the same filter, summed in torch)."""
    p = _seeded_wav(tmp_path, sr, 1)
    native = ingest.load_audio(p)
    monkeypatch.setattr(audio_io, "available", lambda: False)
    plain = ingest.load_audio(p)
    samples, rate = wavio.read_wav_mono(p)
    np.testing.assert_array_equal(plain, frontend.resample_host(samples, rate, 16_000))
    assert plain.shape == native.shape
    assert np.abs(plain - native).max() <= 2e-7
    assert len(ingest.load_audio(p, max_s=0.5)) == 8_000


def test_a_call_during_the_first_build_takes_the_python_reader(tmp_path, monkeypatch):
    """The first build holds the lock; a call that arrives meanwhile does
    not wait for it, and decodes through the pure-Python reader."""
    p = _seeded_wav(tmp_path, 16_000, 1, seconds=0.5)
    monkeypatch.setattr(audio_io, "_lib", None)
    assert audio_io._lock.acquire(blocking=False)
    try:
        assert not audio_io.available()
        got = ingest.load_audio(p)
    finally:
        audio_io._lock.release()
    np.testing.assert_array_equal(got, wavio.read_wav_mono(p)[0])


def test_library_names_and_symbols_stay_apart():
    """The port's libraries are its own files (``libaptpu_torch_*``, in
    ``_build/``, named by a hash of source, flags and compiler), opened
    RTLD_LOCAL: both packages' ``aptpu_*`` symbols live in one process."""
    path = build.library_path("audio_io")
    assert path.parent == build.BUILD_DIR and path.exists()
    assert path.name.startswith("libaptpu_torch_audio_io-")
    assert "audio_processor_tpu_torch" in str(path)
    assert build.library_path("audio_io", build.MEDIA_LIBS) != path
    assert os.path.samefile(audio_io.build_status()["library"], path)
    assert audio_io._load()._name != jaudio_io._load()._name
    # every exported entry point resolves in both libraries
    for sym in ("aptpu_decode_wav", "aptpu_wav_out_size", "aptpu_wav_info",
                "aptpu_resample", "aptpu_dtw"):
        assert getattr(audio_io._load(), sym) and getattr(jaudio_io._load(), sym)


def test_compiler_path_enters_the_name(monkeypatch):
    a = build.library_path("audio_io")
    monkeypatch.setattr(build, "cxx", lambda: "/elsewhere/g++")
    assert build.library_path("audio_io") != a


def test_concurrent_builds_in_processes(tmp_path):
    """Three processes building one fresh library at once each end with a
    whole library (written aside, renamed into place)."""
    script = (
        "import sys; from pathlib import Path\n"
        "from audio_processor_tpu_torch.native import build\n"
        f"build.BUILD_DIR = Path({str(tmp_path)!r})\n"
        "lib = build.load('audio_io')\n"
        "assert lib.aptpu_wav_info\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    procs = [subprocess.Popen([sys.executable, "-c", script], cwd=repo, env=env,
                              stderr=subprocess.PIPE, text=True) for _ in range(3)]
    errs = [p.communicate(timeout=120)[1] for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], errs
    assert [f.name for f in tmp_path.iterdir()] == [build.library_path("audio_io").name]


def test_threads_share_one_library():
    seen = []
    threads = [threading.Thread(target=lambda: seen.append(audio_io._load())) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert len(seen) == 4 and all(lib is audio_io._load() for lib in seen)


def test_convert_to_wav_writes_16k_and_never_overwrites(tmp_path):
    p = _seeded_wav(tmp_path, 44_100, 2)
    out = ingest.convert_to_wav(p, out_dir=str(tmp_path))
    assert out == str(tmp_path / "seeded_44100_2.16k.wav")
    assert wavio.read_wav(p)[1] == 44_100  # the source is untouched
    got, rate = wavio.read_wav_mono(out)
    assert rate == 16_000
    np.testing.assert_allclose(got, ingest.load_audio(p), atol=1 / 32768 + 1e-7)
    (tmp_path / "j").mkdir()
    jout = jingest.convert_to_wav(p, out_dir=str(tmp_path / "j"))
    with open(out, "rb") as a, open(jout, "rb") as b:
        assert a.read() == b.read()
