"""The port's Transcriber with word timestamps, the hallucination filter,
the int8 options and ``detect_language``, against the JAX package's.

Both run the test config in float32 on the same weights
(``convert.params_from_jax``), with a tokenizer that renders ids as letters
and spaces (so words exist) and the no-speech gate off.  Segments, their
words and the flat ``words`` list must be equal (strings, starts, ends;
probabilities within 1e-5) on the plain slab loop, the conditioned path,
the seek-repair patches and ``transcribe_batch``; ``detect_language``'s
probabilities within 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from audio_processor_tpu.models.whisper import quantize as jquantize
from audio_processor_tpu.models.whisper.config import WhisperConfig as JConfig
from audio_processor_tpu.pipeline.transcribe import Transcriber as JTranscriber
from audio_processor_tpu_torch.models.whisper import convert, decode, model, quantize
from audio_processor_tpu_torch.models.whisper.config import WhisperConfig
from audio_processor_tpu_torch.parallel import mesh as mesh_lib
from audio_processor_tpu_torch.pipeline.transcribe import Transcriber
from audio_processor_tpu_torch.runtime.device import set_full_fp32

set_full_fp32()

MAX_NEW = 16


class SpacedLetters:
    """encode: UTF-8 bytes; decode: every fifth id a space, the others
    letters, so random-weight decodes split into words."""

    def encode(self, text):
        return list(text.encode("utf-8"))

    def decode(self, ids):
        return "".join(" " if int(i) % 5 == 0 else chr(97 + int(i) % 26) for i in ids)


COMMON = dict(tokenizer=SpacedLetters(), no_speech_threshold=None)


@pytest.fixture(scope="module")
def base():
    jt = JTranscriber.random_init("test", compute_dtype="float32", max_new_tokens=MAX_NEW)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jt.params), "cpu")
    cfg = WhisperConfig(**{k: getattr(jt.cfg, k) for k in WhisperConfig.__dataclass_fields__})
    return jt, params, cfg


def _pair(base, params=None, jparams=None, heads=None, **kw):
    jt, p, cfg = base
    kw = dict(COMMON, **kw)
    jcfg = jt.cfg if heads is None else dataclasses.replace(jt.cfg, alignment_heads=heads)
    if heads is not None:
        cfg = dataclasses.replace(cfg, alignment_heads=heads)
    jt = dataclasses.replace(jt, cfg=jcfg, **kw)
    if jparams is not None:
        jt = dataclasses.replace(jt, params=jparams)
    pt = Transcriber(params=p if params is None else params, cfg=cfg, compute_dtype="float32",
                     max_new_tokens=MAX_NEW, enable_fallback=False, device="cpu", **kw)
    return jt, pt


def _words(ws):
    return [(w["word"], w["start"], w["end"]) for w in ws]


def _summary(out):
    return ([(s["start"], s["end"], s["text"], _words(s.get("words", [])))
             for s in out["segments"]], _words(out.get("words", [])), out.get("language"))


def _assert_equal(ours, ref, words=True):
    assert _summary(ours) == _summary(ref)
    if words:
        assert ours["words"], "the case must produce words"
        for o, r in zip(ours["words"], ref["words"]):
            assert o["probability"] == pytest.approx(r["probability"], abs=1e-5)


def _long(speech):
    return np.concatenate([speech] * 7)  # 70 s: three 30 s windows


WORD_OPTIONS = {
    "plain": dict(word_timestamps=True),
    "hand-set-heads": dict(word_timestamps=True, heads=((0, 1), (1, 0))),
    "conditioned": dict(word_timestamps=True, condition_on_previous_text=True,
                        condition_group_size=2),
    "beam-self8": dict(word_timestamps=True, beam_size=2, quantize_self_kv=True),
    "punctuations": dict(word_timestamps=True, prepend_punctuations="a",
                         append_punctuations="bc"),
}


@pytest.mark.parametrize("name", list(WORD_OPTIONS))
@pytest.mark.parametrize("trim", [True, False])
def test_transcribe_words_equal_jax(base, speech_like_audio, name, trim):
    jt, pt = _pair(base, **WORD_OPTIONS[name])
    audio = _long(speech_like_audio)
    ref = jt.transcribe(audio, remove_silence=trim)
    ours = pt.transcribe(audio, remove_silence=trim)
    _assert_equal(ours, ref)


@pytest.mark.parametrize("threshold", [0.5, 2.0])
def test_hallucination_filter_transcribe_equal_jax(base, speech_like_audio, threshold):
    jt, pt = _pair(base, word_timestamps=True, hallucination_silence_threshold=threshold)
    audio = _long(speech_like_audio)
    ref = jt.transcribe(audio, remove_silence=False)
    ours = pt.transcribe(audio, remove_silence=False)
    _assert_equal(ours, ref, words=False)
    plain = _pair(base, word_timestamps=True)[1].transcribe(audio, remove_silence=False)
    # random weights give improbable words: the filter removes segments
    assert len(ours["segments"]) < len(plain["segments"])


def _scripted(tr, st, rows_per_call, to_result):
    """Replace tr._run_decode by one that returns the scripted token rows
    (call by call), so that the seek-repair patch path runs on the real
    encoder states."""
    calls = []

    def run(audio_states, temperature=None, seed=0, first_row_prompt=False):
        toks = rows_per_call[len(calls)]
        calls.append(audio_states.shape[0])
        full = np.full((audio_states.shape[0], toks.shape[1]), st.eot, np.int32)
        full[: len(toks)] = toks
        return to_result(full)

    tr._run_decode = run
    return calls


def test_seek_repair_patch_words_equal_jax(base, speech_like_audio):
    """Window 0 ends with text after its last closed pair: one patch window
    re-decodes from 10 s, and its kept states give the patch's words."""
    jt, pt = _pair(base, word_timestamps=True)
    st = pt.special

    def ts(s):
        return st.timestamp_begin + int(round(s / 0.02))

    def row(*toks):
        out = np.full(MAX_NEW, st.eot, np.int32)
        out[: len(toks)] = toks
        return out

    grid = np.stack([row(ts(0), 7, 31, 12, ts(10), ts(10), 9, 44),
                     row(ts(2.5), 3, 8, 70, 11, ts(5)), row(ts(1), 21, 22, 23, ts(4))])
    patch = row(ts(0), 41, 42, 10, 43, ts(22.5))[None]
    calls_j = _scripted(jt, st, [grid, patch], lambda f: decode.DecodeResult(
        jnp.asarray(f), jnp.asarray((f != st.eot).sum(-1)), jnp.zeros(len(f)),
        jnp.zeros(len(f))))
    calls = _scripted(pt, st, [grid, patch], lambda f: decode.DecodeResult(
        torch.from_numpy(f), torch.from_numpy((f != st.eot).sum(-1)), torch.zeros(len(f)),
        torch.zeros(len(f))))
    audio = _long(speech_like_audio)
    ref = jt.transcribe(audio, remove_silence=False)
    ours = pt.transcribe(audio, remove_silence=False)
    assert len(calls) == len(calls_j) == 2  # the grid, then one patch slab
    _assert_equal(ours, ref)
    patch_words = [w for w in ours["words"] if 10.0 <= w["start"] < 32.5]
    assert patch_words


@pytest.mark.parametrize("trim", [True, False])
def test_transcribe_batch_words_equal_jax(base, speech_like_audio, trim):
    jt, pt = _pair(base, word_timestamps=True)
    files = [_long(speech_like_audio), speech_like_audio, speech_like_audio[: 3 * 16_000]]
    ref = jt.transcribe_batch(files, remove_silence=trim)
    ours = pt.transcribe_batch(files, remove_silence=trim)
    for o, r in zip(ours, ref):
        _assert_equal(o, r, words=False)
    assert ours[0]["words"]


def test_int8_decoder_weights_transcribe_equal_jax(base, speech_like_audio):
    """quantize_decoder params in both packages (the storage cast keeps
    float32 here), with the int8 self cache and words."""
    jt0, params, _ = base
    jq = jquantize.quantize_decoder(jt0.params)
    pq = quantize.quantize_decoder(params)
    jt, pt = _pair(base, params=pq, jparams=jq, word_timestamps=True, quantize_self_kv=True)
    audio = _long(speech_like_audio)
    _assert_equal(pt.transcribe(audio, remove_silence=False),
                  jt.transcribe(audio, remove_silence=False))


def test_int8_weights_storage_cast_equals_jax(base):
    """The bf16 storage cast rounds every float32 leaf, the int8 scales
    included, as the JAX Transcriber's does; w8 stays int8."""
    jt0, params, cfg = base
    jt = dataclasses.replace(jt0, params=jquantize.quantize_decoder(jt0.params),
                             compute_dtype="bfloat16", weights_dtype="auto")
    pt = Transcriber(params=quantize.quantize_decoder(params), cfg=cfg, device="cpu")
    ref = convert._flatten(jax.tree.map(np.asarray, jt.params))
    for key, t in convert._flatten(pt.params).items():
        if key in convert._CONV_KEYS:
            continue
        assert str(t.dtype).split(".")[-1] == str(ref[key].dtype), key
        np.testing.assert_array_equal(t.float().numpy(), ref[key].astype(np.float32))


def test_detect_language_equal_jax(speech_like_audio):
    dims = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=2,
                n_audio_layer=1, n_vocab=51865, n_text_ctx=64, n_text_state=64,
                n_text_head=2, n_text_layer=1)
    cfg, jcfg = WhisperConfig(name="ml", **dims), JConfig(name="ml", **dims)
    params = model.init_params(cfg, torch.Generator().manual_seed(12))
    jparams = convert._unflatten({
        k: (t.numpy().transpose(2, 1, 0) if k in convert._CONV_KEYS else t.numpy())
        for k, t in convert._flatten(params).items()
    })
    pt = Transcriber(params=params, cfg=cfg, compute_dtype="float32", device="cpu")
    jt = JTranscriber(params=jax.tree.map(jnp.asarray, jparams), cfg=jcfg,
                      compute_dtype="float32")
    for audio, rate in ((speech_like_audio, 16_000), (speech_like_audio[:80_000], 8_000)):
        ours, ref = pt.detect_language(audio, rate), jt.detect_language(audio, rate)
        assert ours["language"] == ref["language"]
        assert list(ours["probabilities"]) == list(ref["probabilities"])[: len(ours["probabilities"])]
        np.testing.assert_allclose(list(ours["probabilities"].values()),
                                   list(ref["probabilities"].values()), atol=1e-5)


def test_detect_language_needs_a_multilingual_model(base, speech_like_audio):
    _, pt = _pair(base)
    with pytest.raises(ValueError, match="multilingual"):
        pt.detect_language(speech_like_audio)


def test_use_pallas_frontend_is_accepted(base, speech_like_audio):
    """A JAX-shaped config with use_pallas_frontend constructs, and the CPU
    path transcribes as JAX's does (kernel A's plain version here)."""
    jt, pt = _pair(base, use_pallas_frontend=True)
    assert pt.use_pallas_frontend
    assert _summary(pt.transcribe(speech_like_audio)) == _summary(jt.transcribe(speech_like_audio))


def test_hallucination_threshold_needs_word_timestamps():
    with pytest.raises(ValueError, match="word_timestamps"):
        Transcriber.random_init("test", device="cpu", hallucination_silence_threshold=2.0)


@pytest.mark.parametrize("option", ["word_timestamps", "int8_weights"])
def test_mesh_refuses_words_and_int8_weights(base, option):
    """Word timestamps serve on a mesh, and so do int8 decoder weights on a
    data-only one (tp=1: each rank keeps the whole int8 tree); on a model
    axis int8 weights raise ValueError, as JAX's ``shard_params`` does.
    ("word_timestamps": the tp=1 acceptance case, with words; "int8_weights":
    the tp=2 refusal.)"""
    _, params, cfg = base
    p = quantize.quantize_decoder(params)
    if option == "word_timestamps":
        t = Transcriber(params=p, cfg=cfg, device="cpu", word_timestamps=True,
                        mesh=mesh_lib.Mesh(2, 1, 0, 0, torch.device("cpu")))
        q = t.params["decoder"]["blocks"]["attn"]["q"]
        assert t.word_timestamps and q["w8"].dtype == torch.int8
        assert q["w8"].shape == p["decoder"]["blocks"]["attn"]["q"]["w8"].shape
    else:
        with pytest.raises(ValueError, match="model_parallel=1"):
            Transcriber(params=p, cfg=cfg, device="cpu", word_timestamps=True,
                        mesh=mesh_lib.Mesh(1, 2, 0, 0, torch.device("cpu")))
