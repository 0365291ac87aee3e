"""The port's in-process m4a/AAC decode against the JAX package's.

The cases of ``tests/test_native_media.py`` run against the port's
``native.media`` and ``pipeline.ingest``, on real AAC-LC .m4a fixtures
made by the port's own ``encode_m4a``; then the port's decode of an .m4a
must equal the JAX package's ``native/media`` bit for bit (full, prefix,
and through ``ingest.load_audio`` with and without ``max_s=30``), and the
entry points that take a path must take an .m4a as they take a WAV: the
``Transcriber`` (``transcribe``, ``detect_language``), the ``Diarizer``,
the 9-stage meeting job, a ``/v1`` upload and ``cli transcribe``.  The
module skips only where the compiler finds no libav headers.
"""
import io
import json
import os
import struct
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from audio_processor_tpu.native import media as jmedia
from audio_processor_tpu.pipeline import ingest as jingest
from audio_processor_tpu_torch import cli
from audio_processor_tpu_torch.integrations.gemini import GeminiClient
from audio_processor_tpu_torch.integrations.notion import NotionClient
from audio_processor_tpu_torch.models.whisper import model
from audio_processor_tpu_torch.models.whisper.config import WhisperConfig
from audio_processor_tpu_torch.native import audio_io, media
from audio_processor_tpu_torch.pipeline import ingest
from audio_processor_tpu_torch.pipeline.diarize import Diarizer
from audio_processor_tpu_torch.pipeline.meeting import MeetingProcessor
from audio_processor_tpu_torch.pipeline.transcribe import Transcriber
from audio_processor_tpu_torch.runtime import services
from audio_processor_tpu_torch.runtime.device import set_full_fp32
from audio_processor_tpu_torch.runtime.job_engine import JobEngine
from audio_processor_tpu_torch.server import openai_api
from audio_processor_tpu_torch.server.web import App
from audio_processor_tpu_torch.utils import wavio
from test_torch_diarize import make_meeting
from test_torch_meeting import gemini_http, notion_http, run_job
from test_torch_parallel import LetterTokenizer
from test_torch_server import V1, call, multipart

set_full_fp32()

STATUS = media.build_status()
pytestmark = pytest.mark.skipif(not STATUS["headers"], reason=f"media module absent: {STATUS['why']}")

ASR_KW = dict(compute_dtype="float32", max_new_tokens=6, tokenizer=LetterTokenizer(),
              no_speech_threshold=None)


def test_headers_present_means_built():
    """With the codec headers on the compiler's path, the library must
    build and load: a failure there is never an absent module."""
    assert STATUS["built"], STATUS
    assert STATUS["headers"] and "libav headers in" in STATUS["headers_at"]
    assert os.path.basename(STATUS["library"]).startswith("libaptpu_torch_media_decode-")


def _twin(tmp_path, sr=44100, seconds=4):
    """The same signal as a WAV file and an AAC-LC .m4a file."""
    t = np.arange(seconds * sr) / sr
    x = (
        0.35 * np.sin(2 * np.pi * 440 * t)
        + 0.15 * np.sin(2 * np.pi * 1200 * t)
    ).astype(np.float32)
    wav = str(tmp_path / "twin.wav")
    m4a = str(tmp_path / "twin.m4a")
    wavio.write_wav(wav, x, sr)
    media.encode_m4a(x, sr, m4a)
    return wav, m4a


def _spectrum(y, n=32768, skip=4000):
    seg = y[skip : skip + n] * np.hanning(n)
    return np.abs(np.fft.rfft(seg))


def write_float_wav(path: str, samples: np.ndarray, rate: int = 16_000) -> None:
    """A mono IEEE-float WAV: the native decoder reads it back exactly."""
    payload = np.asarray(samples, "<f4").tobytes()
    header = b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
    header += b"fmt " + struct.pack("<IHHIIHH", 16, 3, 1, rate, rate * 4, 4, 32)
    header += b"data" + struct.pack("<I", len(payload))
    with open(path, "wb") as f:
        f.write(header + payload)


# ---------------------------------------------------------------------------
# the JAX suite's cases, on the port
# ---------------------------------------------------------------------------

def test_m4a_decode_matches_wav_twin(tmp_path):
    wav, m4a = _twin(tmp_path)
    ref = ingest.load_audio(wav)      # native WAV path
    got = ingest.load_audio(m4a)      # native media (codec-library) path

    # AAC is lossy + adds ~1 frame of priming delay: compare duration
    # loosely and spectra tightly
    assert abs(len(got) - len(ref)) < 0.06 * 16000  # within 60 ms
    fr, fg = _spectrum(ref), _spectrum(got)
    assert abs(int(np.argmax(fr)) - int(np.argmax(fg))) <= 2  # same tone
    # both injected tones survive the codec
    for freq in (440, 1200):
        bin_ = int(round(freq * 32768 / 16000))
        assert fg[bin_ - 4 : bin_ + 5].max() > 0.1 * fg.max()
    # comparable energy
    assert np.sqrt(np.mean(got**2)) == pytest.approx(
        np.sqrt(np.mean(ref**2)), rel=0.15
    )


def test_media_info(tmp_path):
    _, m4a = _twin(tmp_path, seconds=2)
    info = media.media_info(m4a)
    assert info["codec"] == "aac"
    assert info["sample_rate"] == 44100
    assert info["channels"] == 1
    assert 1800 <= info["duration_ms"] <= 2300


def test_decode_rejects_garbage(tmp_path):
    p = str(tmp_path / "junk.m4a")
    with open(p, "wb") as f:
        f.write(b"\x00\x01not a real mp4 container" * 10)
    with pytest.raises(ValueError):
        media.decode(p)


def test_ingest_raises_cleanly_on_undecodable(tmp_path):
    p = str(tmp_path / "junk.m4a")
    with open(p, "wb") as f:
        f.write(b"RIFFnope")
    with pytest.raises(ValueError):
        ingest.load_audio(p)


def test_transcriber_accepts_m4a(tmp_path):
    """End-to-end: the port's ingest feeds an .m4a into its model stack on
    the CPU, and the path itself goes through ``load_if_path``."""
    _, m4a = _twin(tmp_path, seconds=3)
    audio = ingest.load_audio(m4a)
    tr = Transcriber.random_init("test", device="cpu", **ASR_KW)
    out = tr.transcribe(audio, remove_silence=False)
    assert out["duration"] == pytest.approx(len(audio) / 16000, abs=0.01)
    by_path = tr.transcribe(m4a, remove_silence=False)
    timings = ("rtf_x", "trace")
    assert by_path.pop("rtf_x") > 0 and by_path.pop("trace")["counters"]["transcribe.windows"] == 1
    assert by_path == {k: v for k, v in out.items() if k not in timings}


def test_stereo_mp3_style_downmix(tmp_path):
    """Multi-channel input downmixes through the same path (a stereo WAV
    decoded through the media library)."""
    sr = 22050
    t = np.arange(2 * sr) / sr
    left = 0.4 * np.sin(2 * np.pi * 300 * t)
    right = 0.4 * np.sin(2 * np.pi * 300 * t)
    x = np.stack([left, right], axis=1).astype(np.float32)
    wav = str(tmp_path / "st.wav")
    wavio.write_wav(wav, x, sr)
    y, rate = media.decode(wav, 16000)
    assert rate == 16000
    assert abs(len(y) - 32000) < 200
    spec = _spectrum(y, n=16384, skip=2000)
    assert abs(np.argmax(spec) * 16000 / 16384 - 300) < 4


def test_bounded_decode_max_samples(tmp_path):
    """max_samples stops the demux at the cap and the prefix matches the
    full decode sample-for-sample (detect_language's 30 s probe path)."""
    wav, m4a = _twin(tmp_path, seconds=6)
    full, _ = media.decode(m4a, 16_000)
    cap = 16_000  # 1 s
    part, _ = media.decode(m4a, 16_000, max_samples=cap)
    assert len(part) == cap
    np.testing.assert_array_equal(part, full[:cap])


def test_ingest_max_s_bounds_every_decoder(tmp_path):
    """ingest.load_audio(max_s=...) returns exactly the first max_s
    seconds for WAV (native + pure-Python) and compressed inputs."""
    wav, m4a = _twin(tmp_path, seconds=6)
    for path in (wav, m4a):
        full = ingest.load_audio(path)
        part = ingest.load_audio(path, max_s=2.0)
        assert len(part) == 2 * 16_000
        # the final filter-width of samples may differ slightly: a capped
        # decode resamples WITHOUT future context past the cut
        np.testing.assert_array_equal(part[:-16], full[: 2 * 16_000 - 16])
        np.testing.assert_allclose(
            part[-16:], full[2 * 16_000 - 16 : 2 * 16_000], atol=5e-3
        )
    # pure-Python WAV reader slices the payload pre-conversion
    x, rate = wavio.read_wav_mono(wav, max_s=2.0)
    assert len(x) == 2 * 44_100
    x_full, _ = wavio.read_wav_mono(wav)
    np.testing.assert_array_equal(x, x_full[: 2 * 44_100])


# ---------------------------------------------------------------------------
# the port against the JAX package, bit for bit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def long_m4a(tmp_path_factory):
    """40 s of seeded noise and tones at 48 kHz, encoded by the port."""
    sr = 48_000
    rng = np.random.default_rng(31)
    t = np.arange(40 * sr) / sr
    x = (0.2 * np.sin(2 * np.pi * 210 * t) * (np.sin(2 * np.pi * 0.7 * t) > 0)
         + rng.normal(0, 0.05, len(t))).astype(np.float32)
    path = str(tmp_path_factory.mktemp("m4a") / "REC_20250617_093000.m4a")
    media.encode_m4a(x, sr, path)
    return path


@pytest.mark.parametrize("max_samples", [None, 30 * 16_000, 12_345])
def test_decode_equals_jax(long_m4a, max_samples):
    assert jmedia.available()
    got, rate = media.decode(long_m4a, 16_000, max_samples=max_samples)
    want, jrate = jmedia.decode(long_m4a, 16_000, max_samples=max_samples)
    assert rate == jrate == 16_000 and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if max_samples is not None:
        assert len(got) == max_samples


@pytest.mark.parametrize("max_s", [None, 30.0])
def test_load_audio_equals_jax(long_m4a, max_s):
    got = ingest.load_audio(long_m4a, max_s=max_s)
    np.testing.assert_array_equal(got, jingest.load_audio(long_m4a, max_s=max_s))
    assert len(got) == (30 * 16_000 if max_s else pytest.approx(40 * 16_000, abs=2048))


def test_media_info_equals_jax(long_m4a, tmp_path):
    info = media.media_info(long_m4a)
    assert info == jmedia.media_info(long_m4a)
    assert info["codec"] == "aac" and info["sample_rate"] == 48_000
    # a WAV read through the codec library reports as the JAX package's does
    wav = str(tmp_path / "s.wav")
    wavio.write_wav(wav, np.zeros((8_000, 2), np.float32), 8_000)
    assert media.media_info(wav) == jmedia.media_info(wav)


def test_encode_m4a_writes_what_jax_writes(tmp_path):
    x = np.random.default_rng(2).normal(0, 0.1, 44_100).astype(np.float32)
    ours, theirs = str(tmp_path / "a.m4a"), str(tmp_path / "b.m4a")
    media.encode_m4a(x, 44_100, ours)
    jmedia.encode_m4a(x, 44_100, theirs)
    np.testing.assert_array_equal(media.decode(ours)[0], jmedia.decode(theirs)[0])


def test_convert_to_wav_from_m4a(long_m4a, tmp_path):
    out = ingest.convert_to_wav(long_m4a, out_dir=str(tmp_path))
    assert out == str(tmp_path / "REC_20250617_093000.wav")
    (tmp_path / "j").mkdir()
    with open(out, "rb") as a, open(jingest.convert_to_wav(long_m4a, str(tmp_path / "j")),
                                    "rb") as b:
        assert a.read() == b.read()


# ---------------------------------------------------------------------------
# the entry points take an .m4a as they take a WAV
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def meeting_pair(tmp_path_factory):
    """A 10 s, 2-speaker meeting as a 44.1 kHz .m4a, and the float WAV of
    the samples the port decodes from it."""
    rng = np.random.default_rng(2468)
    audio, _ = make_meeting(rng, (float(rng.uniform(95, 120)), float(rng.uniform(220, 270))),
                            duration_s=10.0)
    d = tmp_path_factory.mktemp("meeting")
    m4a = str(d / "REC_20250618_100000.m4a")
    media.encode_m4a(audio_io.resample(audio, 16_000, 44_100), 44_100, m4a)
    decoded = ingest.load_audio(m4a)
    wav = str(d / "REC_20250618_100000.wav")
    write_float_wav(wav, decoded)
    np.testing.assert_array_equal(ingest.load_audio(wav), decoded)
    return m4a, wav, decoded


@pytest.fixture(scope="module")
def tr():
    return Transcriber.random_init("test", device="cpu", **ASR_KW)


def test_meeting_job_from_m4a_equals_the_wav_job(meeting_pair, tr):
    """The 9-stage job on fake integrations: the .m4a's result equals the
    result of the WAV of its decoded samples, apart from the timings."""
    m4a, wav, _ = meeting_pair
    diarizer = Diarizer.bundled(window_step_s=2.0, device="cpu")
    results = []
    for i, path in enumerate((m4a, wav)):
        prompts, calls = [], []
        proc = MeetingProcessor(
            transcriber=tr, diarizer=diarizer,
            gemini=GeminiClient(api_key="k", http=gemini_http(prompts)),
            notion=NotionClient(token="t", database_id="db", http=notion_http(calls),
                                batch_pause_s=0),
        )
        st, rec, _ = run_job(JobEngine(max_workers=1), proc, path, f"m4a{i}")
        assert st["status"] == "completed", st.get("error")
        assert "job.decode_audio" in rec["stage_timings"]
        res = {k: v for k, v in st["result"].items() if k not in ("processing_s", "rtf_x")}
        results.append((res, prompts, calls))
    (res, prompts, calls), (wres, wprompts, wcalls) = results
    assert res["segments"] and res["diarizer"] == "bundled-synthetic"
    # the Drive rename keeps each file's own extension
    assert res.pop("drive_filename").endswith(".m4a")
    assert wres.pop("drive_filename").endswith(".wav")
    assert res == wres
    assert prompts == wprompts and calls == wcalls


def test_v1_upload_m4a_answers_the_direct_text(meeting_pair, tr):
    m4a, wav, decoded = meeting_pair
    engine = JobEngine(max_workers=1)

    class _Processor:
        transcriber = tr

    app = App(secret_key="k")
    app.register_blueprint(openai_api.make_openai_blueprint(
        services.Services(engine=engine, processor=_Processor())))
    try:
        answers = []
        for name, path in (("a.m4a", m4a), ("a.wav", wav)):
            with open(path, "rb") as f:
                body, ct = multipart({}, (name, f.read()))
            status, data, _ = call(app, "POST", V1, body, ctype=ct)
            assert status == 200, data
            answers.append(data["text"])
    finally:
        engine.shutdown(wait=False)
    direct = tr.transcribe(decoded)["text"].strip()
    assert answers == [direct, direct]


def test_detect_language_takes_an_m4a_path(long_m4a):
    """``detect_language(path)`` decodes only the first 30 s of a 40 s
    recording (the bounded media decode) and answers what the array gives;
    a one-layer multilingual toy model."""
    cfg = WhisperConfig(name="ml", n_mels=80, n_audio_ctx=1500, n_audio_state=64,
                        n_audio_head=2, n_audio_layer=1, n_vocab=51865, n_text_ctx=64,
                        n_text_state=64, n_text_head=2, n_text_layer=1)
    t = Transcriber(params=model.init_params(cfg, torch.Generator().manual_seed(12)), cfg=cfg,
                    compute_dtype="float32", device="cpu")
    first_30s = ingest.load_audio(long_m4a)[: 30 * 16_000]
    np.testing.assert_array_equal(ingest.load_if_path(long_m4a, 8_000, max_s=30.0)[0], first_30s)
    assert t.detect_language(long_m4a) == t.detect_language(first_30s)


def test_diarize_takes_an_m4a_path(meeting_pair):
    m4a, _, decoded = meeting_pair
    d = Diarizer.bundled(window_step_s=2.0, device="cpu")
    turns = d.diarize(m4a)
    assert turns and turns == d.diarize(decoded)


def test_cli_transcribe_m4a_prints_what_the_wav_prints(meeting_pair, monkeypatch, tr):
    m4a, wav, _ = meeting_pair
    monkeypatch.setattr(Transcriber, "random_init", classmethod(lambda k, *a, **kw: tr))
    outs = []
    for path in (m4a, wav):
        buf = io.StringIO()
        with redirect_stdout(buf):
            cli.main(["transcribe", path, "--model", "test", "--device", "cpu", "--json",
                      "--keep-silence"])
        out = json.loads(buf.getvalue())
        out.pop("rtf_x")
        outs.append(out)
    assert outs[0] == outs[1] and outs[0]["duration"] == pytest.approx(10.0, abs=0.1)

