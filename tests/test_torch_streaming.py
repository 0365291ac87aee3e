"""The port's StreamingTranscriber against the JAX package's.

The cases of the JAX package's ``tests/test_streaming.py``: two drive a
real Transcriber (the port's and JAX's on the same weights) and compare
the segments (one of them on a 32 kHz stream, resampled a window at a
time); the rest drive both streamers with the same scripted transcriber
and compare what they emit, with the JAX test's assertions.
"""
import numpy as np
import pytest
import jax

from audio_processor_tpu.pipeline.streaming import StreamingTranscriber as JStreaming
from audio_processor_tpu.pipeline.transcribe import Transcriber as JTranscriber
from audio_processor_tpu_torch.models.whisper import convert
from audio_processor_tpu_torch.models.whisper.config import WhisperConfig
from audio_processor_tpu_torch.pipeline.streaming import StreamingTranscriber
from audio_processor_tpu_torch.pipeline.transcribe import Transcriber


class LetterTokenizer:
    def encode(self, text):
        return list(text.encode("utf-8"))

    def decode(self, ids):
        return "".join(chr(97 + int(i) % 26) for i in ids)


@pytest.fixture(scope="module")
def pair():
    """JAX's streamer fixture (random 'test' weights, float32, 6 tokens),
    with the letter tokenizer and the no-speech gate off so that segments
    exist; the port's Transcriber on the same weights."""
    kw = dict(compute_dtype="float32", max_new_tokens=6, tokenizer=LetterTokenizer(),
              no_speech_threshold=None)
    jt = JTranscriber.random_init("test", **kw)
    cfg = WhisperConfig(**{k: getattr(jt.cfg, k) for k in WhisperConfig.__dataclass_fields__})
    params = convert.params_from_jax(jax.tree.map(np.asarray, jt.params), "cpu")
    pt = Transcriber(params=params, cfg=cfg, device="cpu", enable_fallback=False, **kw)
    return jt, pt


def _texts(segs):
    return [(s["start"], s["end"], s["text"]) for s in segs]


def test_streaming_emits_on_window_boundaries(pair):
    jt, pt = pair
    js, ps = JStreaming(jt), StreamingTranscriber(pt)
    rng = np.random.default_rng(0)
    jsegs, psegs = [], []
    # 70 s fed in ragged 7 s blocks -> two full windows + 10 s flush
    for _ in range(10):
        block = rng.normal(0, 0.1, 7 * 16_000).astype(np.float32)
        jsegs.extend(js.feed(block))
        psegs.extend(ps.feed(block))
    n_after_feed = len(psegs)
    jsegs.extend(js.flush())
    psegs.extend(ps.flush())
    assert _texts(psegs) == _texts(jsegs) and psegs
    starts = [s["start"] for s in psegs]
    assert starts == sorted(starts)
    for s in psegs:
        assert 0 <= s["start"] <= s["end"] <= 70.5
    assert ps._emitted_s == pytest.approx(70.0, abs=0.01)
    assert len(ps._buffer) == 0
    assert n_after_feed <= len(psegs)


def test_streaming_flush_ignores_tiny_tail(pair):
    _, pt = pair
    st = StreamingTranscriber(pt)
    st.feed(np.random.default_rng(1).normal(0, 0.1, 1000).astype(np.float32))
    assert st.flush() == []


class _Scripted:
    """transcribe() returns the next scripted segment list per call."""

    def __init__(self, script):
        self.script = [list(s) for s in script]
        self.calls = []

    def transcribe(self, audio, **kw):
        self.calls.append(len(audio))
        return {"segments": self.script.pop(0)}


def _seg(a, b, text):
    return {"start": a, "end": b, "text": text}


def _both(script, **kw):
    """(port streamer, its transcriber, JAX streamer, its transcriber) on
    the same script."""
    pt, jt = _Scripted(script), _Scripted(script)
    return StreamingTranscriber(pt, **kw), pt, JStreaming(jt, **kw), jt


def _feed(st, seconds, n=1):
    out = []
    for _ in range(n):
        out += list(st.feed(np.zeros(int(seconds * 16_000), np.float32)))
    return out


def test_local_agreement_emits_on_second_sighting():
    script = [
        [_seg(0.0, 1.5, "hello"), _seg(1.5, 4.0, "wor")],
        [_seg(0.0, 1.5, "hello"), _seg(1.5, 6.2, "world of"), _seg(6.2, 8.0, "str")],
    ]
    ps, pt, js, jt = _both(script, partial_step_s=4.0)
    out = _feed(ps, 4, 2)
    assert out == _feed(js, 4, 2) == [{"start": 0.0, "end": 1.5, "text": "hello"}]
    assert len(pt.calls) == len(jt.calls) == 2


def test_local_agreement_never_confirms_trailing_segment():
    script = [[_seg(0.0, 4.0, "same")], [_seg(0.0, 4.0, "same"), _seg(4.0, 8.0, "tail")]]
    ps, _, js, _ = _both(script, partial_step_s=4.0)
    out = _feed(ps, 4, 2)
    assert out == _feed(js, 4, 2) == [{"start": 0.0, "end": 4.0, "text": "same"}]


def test_window_completion_emits_rest_without_duplicates():
    script = [
        [_seg(0.0, 5.0, "early"), _seg(5.0, 15.0, "tail")],
        [_seg(0.0, 5.0, "early"), _seg(5.0, 15.0, "middle"), _seg(15.0, 29.0, "t")],
        [_seg(0.0, 5.0, "early"), _seg(5.0, 15.0, "middle"), _seg(15.0, 29.5, "late")],
        [_seg(0.0, 2.0, "next"), _seg(2.0, 12.0, "t")],
    ]
    ps, pt, js, jt = _both(script, partial_step_s=12.0)
    out, jout = _feed(ps, 12, 3), _feed(js, 12, 3)
    assert out == jout and [s["text"] for s in out] == ["early", "middle", "late"]
    out += _feed(ps, 12)
    jout += _feed(js, 12)
    assert out == jout
    assert pt.calls[-1] == jt.calls[-1] == 18 * 16_000  # 6 s carry + 12 s new


def test_boundary_resegmentation_never_loses_text():
    script = [
        [_seg(0.0, 5.0, "hello world"), _seg(5.0, 9.0, "tail")],
        [_seg(0.0, 5.0, "hello world"), _seg(5.0, 14.0, "how are"), _seg(14.0, 19.0, "t")],
        [_seg(0.0, 12.0, "hello world how are you")],
    ]
    ps, _, js, _ = _both(script, partial_step_s=10.0)
    assert _feed(ps, 10) == _feed(js, 10) == []
    out = _feed(ps, 10)
    assert out == _feed(js, 10) and [s["text"] for s in out] == ["hello world"]
    out = _feed(ps, 10)
    assert out == _feed(js, 10) == [{"start": 0.0, "end": 12.0, "text": "how are you"}]


def test_agreement_survives_timestamp_jitter():
    script = [
        [_seg(0.0, 3.98, "hello"), _seg(3.98, 4.0, "t")],
        [_seg(0.0, 4.0, "hello"), _seg(4.0, 7.9, "more"), _seg(7.9, 8.0, "t")],
    ]
    ps, _, js, _ = _both(script, partial_step_s=4.0)
    out = _feed(ps, 4, 2)
    assert out == _feed(js, 4, 2) and [s["text"] for s in out] == ["hello"]
    assert out[0]["end"] == 4.0


def test_flush_tiny_tail_resets_window_state():
    script = [
        [_seg(0.0, 1.0, "a"), _seg(1.0, 2.0, "t")],
        [_seg(0.0, 1.0, "a"), _seg(1.0, 2.2, "b"), _seg(2.2, 2.4, "t")],
    ]
    ps, _, js, _ = _both(script, partial_step_s=1.0)
    for st in (ps, js):
        _feed(st, 1)
    out = _feed(ps, 1.4)
    assert out == _feed(js, 1.4) and [s["text"] for s in out] == ["a"]
    for st in (ps, js):
        st._buffer = np.zeros(100, np.float32)  # sub-0.5 s tail
        st.flush()
        assert st._emitted_words == [] and st._prev_words == [] and st._partial_mark == 0


def test_single_segment_local_agreement_confirms():
    script = [[_seg(0.0, 4.0, "hello world")], [_seg(0.0, 8.0, "hello world how are")]]
    ps, _, js, _ = _both(script, partial_step_s=4.0)
    assert _feed(ps, 4) == _feed(js, 4) == []
    out = _feed(ps, 4)
    assert out == _feed(js, 4) and [s["text"] for s in out] == ["hello world"]


def test_feed_buffers_eagerly_without_consuming_result():
    ps, _, js, _ = _both([])
    for st in (ps, js):
        st.feed(np.zeros(1000, np.float32))  # result deliberately discarded
        assert len(st._buffer) == 1000


def test_other_sample_rates_raise(pair):
    """Once a refusal of other rates; now the parity case: a 32 kHz stream
    buffers at the source rate and resamples each whole window on the
    device, and its segments equal JAX's streamer's on the same weights
    (a full window, then the flushed tail)."""
    jt, pt = pair
    sr = 32_000
    js, ps = JStreaming(jt, sample_rate=sr), StreamingTranscriber(pt, sample_rate=sr)
    rng = np.random.default_rng(2)
    jsegs, psegs = [], []
    for _ in range(5):  # 35 s in ragged 7 s blocks
        block = rng.normal(0, 0.1, 7 * sr).astype(np.float32)
        jsegs.extend(js.feed(block))
        psegs.extend(ps.feed(block))
    assert len(ps._buffer) == len(js._buffer) == 5 * sr
    jsegs.extend(js.flush())
    psegs.extend(ps.flush())
    assert psegs and _texts(psegs) == _texts(jsegs)
    assert ps._emitted_s == js._emitted_s == pytest.approx(35.0)


def test_flush_discarded_tail_advances_clock():
    script = [[_seg(0.0, 1.0, "later")]]
    ps, _, js, _ = _both(script)
    for st in (ps, js):
        st.feed(np.zeros(int(0.4 * 16_000), np.float32))
        assert st.flush() == []
        assert st._emitted_s == pytest.approx(0.4)
    out = _feed(ps, 30)
    assert out == _feed(js, 30) and out[0]["start"] == pytest.approx(0.4)
