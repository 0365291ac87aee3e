"""The port's Transcriber against the JAX package's, end to end on the CPU.

Both run ``random_init("test", compute_dtype="float32", max_new_tokens=8)``
with the JAX weights carried across; segments (start, end, text), the
language and the duration must be equal.  Random weights with the byte
tokenizer decode to no text at all, so the comparison also runs with a
tokenizer that renders every id as a letter and the no-speech gate off,
where segments exist.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax

from audio_processor_tpu.models.whisper import decode as jdecode
from audio_processor_tpu.models.whisper.config import WhisperConfig as JConfig
from audio_processor_tpu.pipeline.transcribe import Transcriber as JTranscriber
from audio_processor_tpu_torch.models.whisper import convert, model
from audio_processor_tpu_torch.models.whisper.config import WhisperConfig
from audio_processor_tpu_torch.pipeline.transcribe import Transcriber
from audio_processor_tpu_torch.runtime.device import set_full_fp32
from audio_processor_tpu_torch.utils import wavio

set_full_fp32()


class LetterTokenizer:
    """encode: UTF-8 bytes; decode: every id as a letter, so random-weight
    decodes produce visible text."""

    def encode(self, text):
        return list(text.encode("utf-8"))

    def decode(self, ids):
        return "".join(chr(97 + int(i) % 26) for i in ids)


OPTION_SETS = {
    "defaults": {},
    "open": dict(tokenizer=LetterTokenizer(), no_speech_threshold=None),
}


@pytest.fixture(scope="module")
def pairs():
    base = JTranscriber.random_init("test", compute_dtype="float32", max_new_tokens=8)
    params = convert.params_from_jax(jax.tree.map(np.asarray, base.params), "cpu")
    cfg = WhisperConfig(**{k: getattr(base.cfg, k) for k in WhisperConfig.__dataclass_fields__})
    out = {}
    for name, kw in OPTION_SETS.items():
        jt = dataclasses.replace(base, **kw)
        pt = Transcriber(
            params=params, cfg=cfg, compute_dtype="float32", max_new_tokens=8,
            enable_fallback=False, device="cpu", **kw,
        )
        out[name] = (jt, pt)
    return out


def _summary(out):
    return (
        [(s["start"], s["end"], s["text"]) for s in out["segments"]],
        out.get("language"),
        out["duration"],
    )


def _multi_chunk(speech):
    return np.concatenate([speech] * 7)  # 70 s: three 30 s windows


@pytest.mark.parametrize("options", list(OPTION_SETS))
@pytest.mark.parametrize("case", ["speech_trimmed", "multi_chunk"])
def test_transcribe_segments_equal_jax(pairs, speech_like_audio, options, case):
    jt, pt = pairs[options]
    if case == "speech_trimmed":
        audio, kw = speech_like_audio, {}
    else:
        audio, kw = _multi_chunk(speech_like_audio), dict(remove_silence=False)
    ref, ours = jt.transcribe(audio, **kw), pt.transcribe(audio, **kw)
    assert _summary(ours) == _summary(ref)
    if options == "open":
        assert ours["segments"], "the open option set must produce segments"
    assert set(ours["segments"][0] if ours["segments"] else {}) <= set(
        ref["segments"][0] if ref["segments"] else {}
    )
    for so, sr in zip(ours["segments"], ref["segments"]):
        assert so["tokens"] == sr["tokens"] and so["seek"] == sr["seek"]


def test_clip_timestamps_equal_jax(pairs, speech_like_audio):
    jt, pt = pairs["open"]
    audio = _multi_chunk(speech_like_audio)
    clips = [(3.0, 25.0), (40.0, 61.5)]
    ref = jt.transcribe(audio, clip_timestamps=clips)
    ours = pt.transcribe(audio, clip_timestamps=clips)
    assert _summary(ours) == _summary(ref)


def test_live_segments_and_progress(pairs, speech_like_audio):
    _, pt = pairs["open"]
    live, prog = [], []
    out = pt.transcribe(
        _multi_chunk(speech_like_audio), remove_silence=False,
        on_segment=live.append, progress=prog.append,
    )
    assert [s["text"] for s in live] and prog[-1] == 1.0
    final_texts = {s["text"] for s in out["segments"]}
    assert {s["text"] for s in live} & final_texts


def test_fallback_ladder_runs_on_cpu(pairs, speech_like_audio):
    """Every row fails a logprob gate of +1, so the T>0 rungs (sampling,
    best_of) all run; the accepting temperature is the ladder's last."""
    _, base = pairs["open"]
    pt = Transcriber(
        params=base.params, cfg=base.cfg,
        compute_dtype="float32", max_new_tokens=4, device="cpu", best_of=2,
        logprob_threshold=1.0, compression_ratio_threshold=None,
        no_speech_threshold=None, tokenizer=LetterTokenizer(),
        temperature_ladder=(0.5, 1.0),
    )
    out = pt.transcribe(speech_like_audio, remove_silence=False)
    assert out["segments"] and {s["temperature"] for s in out["segments"]} == {1.0}


def test_language_voting_equal_jax(speech_like_audio):
    """Multilingual toy config: the port's voting over the first chunks
    picks what the JAX detect_language + voting rule picks on the same
    encoder states, and transcribe reports that language."""
    dims = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=2,
                n_audio_layer=1, n_vocab=51865, n_text_ctx=64, n_text_state=64,
                n_text_head=2, n_text_layer=1)
    cfg, jcfg = WhisperConfig(name="ml", **dims), JConfig(name="ml", **dims)
    params = model.init_params(cfg, torch.Generator().manual_seed(12))
    pt = Transcriber(params=params, cfg=cfg, compute_dtype="float32",
                     max_new_tokens=2, device="cpu", enable_fallback=False)
    audio = np.concatenate([speech_like_audio * 0.0, speech_like_audio] * 3)
    n = int(np.ceil(len(audio) / 480_000))
    states = pt._frontend_encode(pt._chunk_slab(audio, list(range(n)), n))
    ours = pt._detect_language_voting(audio, states, list(range(n)))
    jtree = convert._unflatten({
        k: (t.numpy().transpose(2, 1, 0) if k in convert._CONV_KEYS else t.numpy())
        for k, t in convert._flatten(params).items()
    })
    k = JTranscriber._voting_k(n)
    _, jprobs = jdecode.detect_language(jtree, jcfg, states[:k].numpy())
    assert ours == JTranscriber._vote_language(audio, list(range(k)), np.asarray(jprobs))
    out = pt.transcribe(audio, remove_silence=False)
    assert out["language"] == pt._language_code() is not None


def test_hallucination_threshold_without_words_raises():
    """Once the refusal of the options a later slice brought; now JAX's
    check: the threshold reads word probabilities, so it needs
    word_timestamps (``tests/test_torch_transcribe_words.py`` holds the
    options themselves to JAX)."""
    with pytest.raises(ValueError, match="word_timestamps"):
        Transcriber.random_init("test", device="cpu", hallucination_silence_threshold=2.0)


# the options this slice ports, each against the JAX Transcriber
PORTED_OPTIONS = {
    "beam5": dict(beam_size=5),
    "condition-group2": dict(condition_on_previous_text=True, condition_group_size=2),
    "initial_prompt": dict(initial_prompt="hello there"),
    "initial_prompt-carry": dict(initial_prompt="hello there", carry_initial_prompt=True),
    "prefix": dict(prefix="so"),
    "cross_kv_bits8": dict(cross_kv_bits=8),
    "fused_encoder": dict(use_pallas_encoder_attn=True),
    "quantize_self_kv": dict(quantize_self_kv=True),
    "quantize_self_kv-condition-beam2": dict(
        quantize_self_kv=True, beam_size=2, condition_on_previous_text=True,
        condition_group_size=2,
    ),
    "beam3-condition-prompt": dict(
        beam_size=3, condition_on_previous_text=True, condition_group_size=2,
        initial_prompt="hello", patience=2.0, length_penalty=1.0,
    ),
    "condition-carry": dict(
        condition_on_previous_text=True, condition_group_size=2,
        initial_prompt="hello", carry_initial_prompt=True, condition_ctx_tokens=6,
    ),
}


@pytest.mark.parametrize("name", list(PORTED_OPTIONS))
def test_ported_options_segments_equal_jax(pairs, speech_like_audio, name):
    """Three windows (70 s), the open option set: segments, tokens, seek
    and per-segment decode stats equal the JAX Transcriber's."""
    jbase, pbase = pairs["open"]
    kw = PORTED_OPTIONS[name]
    jt = dataclasses.replace(jbase, **kw)
    pt = Transcriber(
        params=pbase.params, cfg=pbase.cfg, tokenizer=LetterTokenizer(),
        no_speech_threshold=None, compute_dtype="float32", max_new_tokens=8,
        enable_fallback=False, device="cpu", **kw,
    )
    audio = _multi_chunk(speech_like_audio)
    ref = jt.transcribe(audio, remove_silence=False)
    ours = pt.transcribe(audio, remove_silence=False)
    assert _summary(ours) == _summary(ref)
    assert ours["segments"]
    for so, sr in zip(ours["segments"], ref["segments"]):
        assert so["tokens"] == sr["tokens"] and so["seek"] == sr["seek"]
        for key in ("avg_logprob", "no_speech_prob", "compression_ratio"):
            assert so[key] == pytest.approx(sr[key], abs=1e-4), key


def test_prompt_and_prefix_tokens_equal_jax(pairs):
    jbase, pbase = pairs["open"]
    kw = dict(initial_prompt="  a long prompt " * 8, prefix="the prefix")
    jt = dataclasses.replace(jbase, **kw)
    pt = Transcriber(params=pbase.params, cfg=pbase.cfg, tokenizer=LetterTokenizer(),
                     compute_dtype="float32", max_new_tokens=8, device="cpu", **kw)
    assert pt._initial_prompt_tokens == jt._initial_prompt_tokens
    assert pt._prefix_tokens == jt._prefix_tokens
    assert pt._sot_seq(None) == jt._sot_seq(None)
    assert pt._carry_hists([[1, 2, 3]]) == jt._carry_hists([[1, 2, 3]])


def test_conditioned_fallback_ladder_runs_on_cpu(pairs, speech_like_audio):
    """Conditioned decoding through the retry ladder: every row fails a
    logprob gate of +1, so the T=0.5 rung (prompt kept) and the T=1.0 rung
    (prompt dropped) both run; beam rows retry by sampling."""
    _, base = pairs["open"]
    pt = Transcriber(
        params=base.params, cfg=base.cfg, compute_dtype="float32", max_new_tokens=4,
        device="cpu", best_of=2, beam_size=2, logprob_threshold=1.0,
        compression_ratio_threshold=None, no_speech_threshold=None,
        tokenizer=LetterTokenizer(), temperature_ladder=(0.5, 1.0),
        condition_on_previous_text=True, condition_group_size=2, initial_prompt="hi",
    )
    out = pt.transcribe(_multi_chunk(speech_like_audio), remove_silence=False)
    assert out["segments"] and {s["temperature"] for s in out["segments"]} == {1.0}


@pytest.mark.parametrize("rate,n", [(8_000, 48_000), (44_100, 100_000)])
def test_resample_and_batch_raise(pairs, speech_like_audio, rate, n):
    """Once a refusal of other rates; now the parity case: 8 kHz and
    44.1 kHz input resamples on the device, and transcribe and
    transcribe_batch equal JAX's (which resamples with its frontend).  The
    44.1 kHz lengths are ones where the JAX reference's dilated conv on
    XLA:CPU returns the right samples: at some others (160,000) it returns
    values near 1e33 (``test_torch_fbank.py`` holds those lengths against
    float64)."""
    jt, pt = pairs["open"]
    audio = speech_like_audio[:n]  # read as `rate` samples a second
    got = pt.transcribe(audio, sample_rate=rate)
    assert got["segments"] and _summary(got) == _summary(jt.transcribe(audio, sample_rate=rate))
    batch = [audio, audio[: 60_000]]
    got = pt.transcribe_batch(batch, sample_rate=rate)
    want = jt.transcribe_batch(batch, sample_rate=rate)
    assert [_summary(o) for o in got] == [_summary(o) for o in want]


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Transcriber.random_init("test")
    t = Transcriber.random_init("test", device="cpu", max_new_tokens=2)
    assert t.device.type == "cpu"
    matmul = torch.backends.cuda.matmul
    assert not (matmul.allow_tf32 or torch.backends.cudnn.allow_tf32)
    assert not (matmul.allow_bf16_reduced_precision_reduction
                or matmul.allow_fp16_reduced_precision_reduction)
    out = t.transcribe(np.zeros(16_000, np.float32))
    assert out["duration"] == 1.0


def test_wav_path_input(pairs, speech_like_audio, tmp_path):
    jt, pt = pairs["open"]
    path = str(tmp_path / "a.wav")
    wavio.write_wav(path, speech_like_audio, 16_000)
    assert _summary(pt.transcribe(path)) == _summary(jt.transcribe(path))


def test_cli_transcribe_json_on_cpu(speech_like_audio, tmp_path, capsys):
    import json

    from audio_processor_tpu_torch import cli

    path = str(tmp_path / "a.wav")
    wavio.write_wav(path, speech_like_audio, 16_000)
    cli.main(["transcribe", path, "--model", "test", "--device", "cpu", "--json"])
    out = json.loads(capsys.readouterr().out)
    assert out["duration"] == pytest.approx(10.0) and "segments" in out


def test_from_npz_equals_jax(pairs, speech_like_audio, tmp_path):
    """A checkpoint written by the JAX package's convert tool loads into the
    port and transcribes as the JAX Transcriber does on the same weights."""
    from audio_processor_tpu.models.whisper import convert as jconvert

    jt, _ = pairs["open"]
    path = str(tmp_path / "test.npz")
    jconvert.save_params(path, jt.params, jt.cfg)
    kw = dict(OPTION_SETS["open"], compute_dtype="float32", max_new_tokens=8)
    pt = Transcriber.from_npz(path, device="cpu", enable_fallback=False, **kw)
    assert pt.cfg.n_text_layer == jt.cfg.n_text_layer
    assert _summary(pt.transcribe(speech_like_audio)) == _summary(jt.transcribe(speech_like_audio))


def test_warmup_runs_one_window(pairs):
    _, pt = pairs["defaults"]
    assert pt.warmup(1) > 0.0


def test_cli_decoding_flags_on_cpu(speech_like_audio, tmp_path, capsys, monkeypatch):
    """The JAX CLI's decoding flags reach the port's Transcriber under the
    same option names, and a transcription with all of them runs."""
    import json

    from audio_processor_tpu_torch import cli
    from audio_processor_tpu_torch.pipeline import transcribe

    path = str(tmp_path / "a.wav")
    wavio.write_wav(path, speech_like_audio, 16_000)
    seen = {}
    real = transcribe.Transcriber.random_init.__func__

    def spy(cls, name="tiny", **kw):
        seen.update(kw)
        return real(cls, name, max_new_tokens=4, **kw)

    monkeypatch.setattr(transcribe.Transcriber, "random_init", classmethod(spy))
    cli.main([
        "transcribe", path, "--model", "test", "--device", "cpu", "--json",
        "--beam", "2", "--patience", "2", "--length-penalty", "1.0", "--best-of", "3",
        "--initial-prompt", "hello", "--carry-initial-prompt", "--prefix", "so",
        "--condition",
    ])
    out = json.loads(capsys.readouterr().out)
    assert out["duration"] == pytest.approx(10.0)
    assert seen == dict(
        device="cpu", beam_size=2, patience=2.0, length_penalty=1.0, best_of=3,
        initial_prompt="hello", carry_initial_prompt=True, prefix="so",
        condition_on_previous_text=True,
    )
