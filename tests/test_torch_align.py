"""The port's word timestamps against the JAX package's, on the CPU.

The same seeded weights (``convert.params_from_jax``) and encoder states go
through the JAX ``models/whisper/align.py`` and the port's: the
teacher-forced maps (pooled, per alignment head set by hand, every head)
and the token probabilities within 1e-5, the words of ``word_timestamps``
exactly (strings, starts, ends; probabilities within 1e-5) for a language
with spaces and a spaceless one, a batch with an empty row and content
frames shorter than the window, and the host chain exactly when it is fed
JAX's own maps.  The DTW twin (the numpy wavefront the CPU path runs) is
held to the JAX DTW on tie plateaus, the batched form to the per-row one,
and ``filter_hallucinations`` to JAX's on the cases of
``tests/test_hallucination_filter.py``.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from audio_processor_tpu.models.whisper import align as jalign
from audio_processor_tpu.models.whisper import decode as jdecode
from audio_processor_tpu.models.whisper import model as jmodel
from audio_processor_tpu.models.whisper.config import WhisperConfig as JConfig
from audio_processor_tpu.pipeline import transcribe as jtranscribe
from audio_processor_tpu_torch.models.whisper import align, convert, model
from audio_processor_tpu_torch.models.whisper.config import WhisperConfig
from audio_processor_tpu_torch.models.whisper.decode import SpecialTokens
from audio_processor_tpu_torch.models.whisper.tokenizer import ByteTokenizer
from audio_processor_tpu_torch.ops.kernels import dtw
from audio_processor_tpu_torch.pipeline import transcribe
from audio_processor_tpu_torch.runtime.device import set_full_fp32

set_full_fp32()

DIMS = dict(n_mels=80, n_audio_ctx=48, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
            n_vocab=512, n_text_ctx=32, n_text_state=64, n_text_head=2, n_text_layer=2)
HEADS = ((0, 1), (1, 0), (1, 1))
CFGS = {
    "pooled": (WhisperConfig(name="align", **DIMS), JConfig(name="align", **DIMS)),
    "heads": (WhisperConfig(name="align", alignment_heads=HEADS, **DIMS),
              JConfig(name="align", alignment_heads=HEADS, **DIMS)),
}
ST = SpecialTokens.for_config(CFGS["pooled"][0])
JST = jdecode.SpecialTokens.for_config(CFGS["pooled"][1])
TOK = ByteTokenizer()
TEXTS = {"en": ["hi there, you.", "", "(a) b c!"], "zh": ["你好，世界", "", "是的"]}


@pytest.fixture(scope="module")
def weights():
    jp = jmodel.init_params(CFGS["pooled"][1], jax.random.PRNGKey(0))
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def states():
    return np.random.default_rng(0).normal(0, 1, (3, 48, 64)).astype(np.float32)


def _rows(texts):
    ids = [TOK.encode(t) for t in texts]
    rows = np.full((len(ids), max(len(i) for i in ids) + 2), ST.eot, np.int64)
    for r, i in enumerate(ids):
        rows[r, : len(i)] = i
    return rows


def _tokens():
    return np.random.default_rng(1).integers(0, 200, (3, 7)).astype(np.int32)


def test_pooled_map_and_probs_equal_jax(weights, states):
    jp, pp = weights
    cfg, jcfg = CFGS["pooled"]
    tok = _tokens()
    jm, jpr = jalign.cross_attention_map_and_probs(
        jp, jcfg, jnp.asarray(tok), jnp.asarray(states), vocab_cap=300)
    m, pr = align.cross_attention_map_and_probs(
        pp, cfg, torch.from_numpy(tok).long(), torch.from_numpy(states), vocab_cap=300)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=1e-5)
    np.testing.assert_allclose(pr.numpy(), np.asarray(jpr), atol=1e-5)
    np.testing.assert_allclose(m.sum(-1).numpy(), 1.0, atol=1e-4)
    plain = align.cross_attention_map(pp, cfg, torch.from_numpy(tok).long(), torch.from_numpy(states))
    assert torch.equal(plain, m)


def test_alignment_head_maps_equal_jax(weights, states):
    """Hand-set heads (as ``tests/test_align.py`` sets them): each head's
    map in ``cfg.alignment_heads`` order, the probabilities, and every
    head's map of the calibration pass."""
    jp, pp = weights
    cfg, jcfg = CFGS["heads"]
    tok = _tokens()
    jm, jpr = jalign.alignment_head_maps(
        jp, jcfg, jnp.asarray(tok), jnp.asarray(states), vocab_cap=ST.eot, want_probs=True)
    m, pr = align.alignment_head_maps(
        pp, cfg, torch.from_numpy(tok).long(), torch.from_numpy(states), vocab_cap=ST.eot,
        want_probs=True)
    assert tuple(m.shape) == (len(HEADS), 3, 7, 48)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=1e-5)
    np.testing.assert_allclose(pr.numpy(), np.asarray(jpr), atol=1e-5)
    jall = jalign.all_head_attention_maps(jp, jcfg, jnp.asarray(tok), jnp.asarray(states))
    every = align.all_head_attention_maps(pp, cfg, torch.from_numpy(tok).long(),
                                          torch.from_numpy(states))
    np.testing.assert_allclose(every.numpy(), np.asarray(jall), atol=1e-5)
    for slot, (l, h) in enumerate(HEADS):
        assert torch.equal(m[slot], every[l, :, h])
    with pytest.raises(ValueError):
        align.alignment_head_maps(pp, CFGS["pooled"][0], torch.from_numpy(tok).long(),
                                  torch.from_numpy(states))


def _words(out):
    return [[(w["word"], w["start"], w["end"]) for w in row] for row in out]


def _assert_words_equal(ours, ref):
    assert _words(ours) == _words(ref)
    for orow, rrow in zip(ours, ref):
        for o, r in zip(orow, rrow):
            assert o["probability"] == pytest.approx(r["probability"], abs=1e-5)


WORD_KW = dict(with_probabilities=True, content_frames=np.array([40, 48, 30]))


@pytest.mark.parametrize("heads", ["pooled", "heads"])
@pytest.mark.parametrize("language", ["en", "zh"])
def test_word_timestamps_equal_jax(weights, states, heads, language):
    """A space language and a spaceless one, an empty row in the batch,
    content frames shorter than the window, a sot sequence."""
    jp, pp = weights
    cfg, jcfg = CFGS[heads]
    rows = _rows(TEXTS[language])
    sot = (ST.sot, ST.transcribe)
    kw = dict(WORD_KW, language=language, sot_sequence=sot)
    offsets = np.array([0.0, 30.0, 60.0])
    ref = jalign.word_timestamps(jp, jcfg, jnp.asarray(states), rows, JST, TOK.decode,
                                 offsets, **kw)
    ours = align.word_timestamps(pp, cfg, torch.from_numpy(states), rows, ST, TOK.decode,
                                 offsets, **kw)
    _assert_words_equal(ours, ref)
    assert ours[1] == [] and ours[0] and ours[2]
    assert all(w["end"] <= offsets[i] + 0.02 * WORD_KW["content_frames"][i] + 1e-6
               for i, row in enumerate(ours) for w in row)


def test_word_timestamps_without_probabilities_equal_jax(weights, states):
    jp, pp = weights
    cfg, jcfg = CFGS["pooled"]
    rows = _rows(TEXTS["en"])
    ref = jalign.word_timestamps(jp, jcfg, jnp.asarray(states), rows, JST, TOK.decode,
                                 np.zeros(3))
    ours = align.word_timestamps(pp, cfg, torch.from_numpy(states), rows, ST, TOK.decode,
                                 np.zeros(3))
    assert _words(ours) == _words(ref) and "probability" not in ours[0][0]
    assert align.word_timestamps(pp, cfg, torch.from_numpy(states), rows[:, :0], ST,
                                 TOK.decode, np.zeros(3)) == [[], [], []]


@pytest.mark.parametrize("heads", ["pooled", "heads"])
def test_host_chain_on_jax_maps_is_exact(weights, states, heads, monkeypatch):
    """JAX's own maps and probabilities through the port's crop, z-score,
    median filter, DTW and word assembly: the words equal JAX's exactly."""
    jp, pp = weights
    cfg, jcfg = CFGS[heads]
    rows = _rows(TEXTS["en"])
    _, _, forced = align._teacher_forced_rows(rows, ST, None)
    # the JAX pass's own padding: the width to a power of two (capped at
    # the context), the batch to a power of two with zero states
    width = min(1 << (forced.shape[1] - 1).bit_length(), cfg.n_text_ctx)
    tok = np.full((4, width), ST.eot, np.int32)
    tok[:3, : forced.shape[1]] = forced
    x = jnp.asarray(np.concatenate([states, np.zeros_like(states[:1])]))
    if heads == "heads":
        jm, jpr = jalign.alignment_head_maps(jp, jcfg, jnp.asarray(tok), x, vocab_cap=ST.eot,
                                             want_probs=True)
        jm = np.asarray(jm)[:, :3]
    else:
        jm, jpr = jalign.cross_attention_map_and_probs(jp, jcfg, jnp.asarray(tok), x,
                                                       vocab_cap=ST.eot)
        jm = np.asarray(jm)[:3]
    monkeypatch.setattr(align, "alignment_maps", lambda *a, **k: (jm, np.asarray(jpr)[:3]))
    kw = dict(WORD_KW, language="en")
    ours = align.word_timestamps(pp, cfg, torch.from_numpy(states), rows, ST, TOK.decode,
                                 np.zeros(3), **kw)
    ref = jalign.word_timestamps(jp, jcfg, jnp.asarray(states), rows, JST, TOK.decode,
                                 np.zeros(3), **kw)
    assert ours == ref


def test_calibrate_alignment_heads_equal_jax(weights, states):
    jp, pp = weights
    cfg, jcfg = CFGS["pooled"]
    rows = _rows(["calibrate these heads", "and these"])
    ref = jalign.calibrate_alignment_heads(jp, jcfg, jnp.asarray(states[:2]), rows, JST, top_k=2)
    ours = align.calibrate_alignment_heads(pp, cfg, torch.from_numpy(states[:2]), rows, ST,
                                           top_k=2)
    assert ours == ref and len(ours) == 2


def test_dtw_twin_equals_jax_on_plateaus():
    """Quantised costs force ties (``tests/test_parity_align.py``'s plateau
    case): the twin takes openai's right step on every tie, as JAX's DTW
    does, row by row and batched."""
    rng = np.random.default_rng(3)
    for trial in range(8):
        cost = np.round(rng.uniform(0, 1, (9, 25)) * 4).astype(np.float32) / 4.0
        want = jalign.dtw_path_from_cost(cost)
        np.testing.assert_array_equal(align.dtw_path_from_cost(cost), want, err_msg=str(trial))
        np.testing.assert_array_equal(dtw.dtw_wavefront(cost[None], 9, 25)[0], want)


def test_dtw_batched_equals_per_row():
    rng = np.random.default_rng(11)
    shapes = [(12, 30), (1, 7), (5, 1), (12, 3), (7, 30)]
    costs = [np.round(rng.uniform(0, 1, s) * 3).astype(np.float32) / 3 for s in shapes]
    pad = np.full((len(costs), 12, 30), 0.5, np.float32)
    for k, c in enumerate(costs):
        pad[k, : c.shape[0], : c.shape[1]] = c
    rows, frames = [s[0] for s in shapes] + [0], [s[1] for s in shapes] + [4]
    pad = np.concatenate([pad, np.ones((1, 12, 30), np.float32)])
    got = dtw.dtw_starts(pad, rows, frames, "cpu")
    for k, c in enumerate(costs):
        np.testing.assert_array_equal(got[k, : c.shape[0]], jalign.dtw_path_from_cost(c))
        assert not got[k, c.shape[0]:].any()
    assert not got[-1].any()
    with pytest.raises(ValueError):
        dtw.dtw_starts(pad, 13, 30, "cpu")


def test_dtw_path_on_similarity_equals_jax():
    m = np.random.default_rng(0).uniform(0.01, 1.0, (10, 40))
    np.testing.assert_array_equal(align.dtw_path(m), jalign.dtw_path(m))
    np.testing.assert_array_equal(align.dtw_path(np.eye(6) * 0.9 + 0.01), np.arange(6))


@pytest.mark.parametrize("frames", [3, 4, 7, 50])
def test_median_filter_equals_jax(frames):
    x = np.random.default_rng(frames).normal(size=(2, 5, frames)).astype(np.float32)
    np.testing.assert_array_equal(align._median_filter(x, 7), jalign._median_filter(x, 7))


@pytest.mark.parametrize("language,text", [
    ("en", " hello, world! (it's) “quoted” ok."), ("zh", "你好，世界。"), ("en", "a"),
    ("ja", "こんにちは"), (None, " x � y"),
])
def test_word_split_and_merge_equal_jax(language, text):
    ids = TOK.encode(text)
    assert align._split_words(ids, TOK.decode, language) == jalign._split_words(
        ids, TOK.decode, language)
    words, _ = align._split_words(ids, TOK.decode, language)
    rows = [{"word": w, "start": float(i), "end": float(i + 1)} for i, w in enumerate(words)]
    args = (align.PREPEND_PUNCTUATIONS, align.APPEND_PUNCTUATIONS)
    assert align._merge_punctuations([dict(r) for r in rows], *args) == \
        jalign._merge_punctuations([dict(r) for r in rows], *args)


def test_decode_logits_and_forward_equal_jax(weights, states):
    """The teacher-forced decoder under the causal mask (JAX ``model.py``'s
    ``decode_logits``), and the full forward from a mel."""
    jp, pp = weights
    cfg, jcfg = CFGS["pooled"]
    tok = _tokens()
    ref = jmodel.decode_logits(jp, jcfg, jnp.asarray(tok), jnp.asarray(states))
    ours = model.decode_logits(pp, cfg, torch.from_numpy(tok).long(), torch.from_numpy(states))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=3e-3)
    dims = dict(DIMS, n_audio_ctx=1500)
    fcfg, fjcfg = WhisperConfig(name="f", **dims), JConfig(name="f", **dims)
    fjp = jmodel.init_params(fjcfg, jax.random.PRNGKey(1))
    fpp = convert.params_from_jax(jax.tree.map(np.asarray, fjp), "cpu")
    mel = np.random.default_rng(2).normal(0, 1, (1, 80, 3000)).astype(np.float32)
    ref = jmodel.forward(fjp, fjcfg, jnp.asarray(mel), jnp.asarray(tok[:1]))
    ours = model.forward(fpp, fcfg, torch.from_numpy(mel), torch.from_numpy(tok[:1]).long())
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=3e-3)


# -- the hallucination filter, on the cases of tests/test_hallucination_filter.py

def _w(word, start, end, p):
    return {"word": word, "start": start, "end": end, "probability": p}


def _seg(start, end, text):
    return {"start": start, "end": end, "text": text}


def _good(t0, words, dur=0.3, gap=0.05, p=0.9):
    out, t = [], t0
    for word in words:
        out.append(_w(word, round(t, 3), round(t + dur, 3), p))
        t += dur + gap
    return out


FILTER_CASES = {
    "surrounded_by_silence": (
        [_seg(0.0, 1.0, "hello there"), _seg(20.0, 20.7, "ghost words"),
         _seg(40.0, 41.0, "real speech")],
        _good(0.0, ["hello", "there"]) + _good(20.0, ["ghost", "words"], p=0.01)
        + _good(40.0, ["real", "speech"])),
    "no_silence": (
        [_seg(0.0, 1.1, "hello there"), _seg(1.2, 1.9, "ghost words"),
         _seg(2.2, 3.2, "real speech")],
        _good(0.0, ["hello", "there"]) + _good(1.2, ["ghost", "words"], p=0.01)
        + _good(2.2, ["real", "speech"])),
    "adjacent_anomalies": (
        [_seg(0.0, 0.4, "real"), _seg(10.0, 10.4, "ga"), _seg(10.8, 11.2, "gb"),
         _seg(30.0, 30.4, "more")],
        _good(0.0, ["real"]) + _good(10.0, ["ga"], p=0.01) + _good(10.8, ["gb"], p=0.01)
        + _good(30.0, ["more"])),
    "trailing_near_end": (
        [_seg(0.0, 0.4, "real"), _seg(58.5, 59.0, "tail")],
        _good(0.0, ["real"]) + _good(58.5, ["tail"], p=0.01)),
    "punctuation_only": ([_seg(5.0, 5.1, ".")], [_w(".", 5.0, 5.01, 0.01)]),
    "short_and_long_words": (
        [_seg(0.0, 0.4, "a"), _seg(9.0, 12.0, "b c")],
        [_w("a", 0.0, 0.05, 0.9), _w("b", 9.0, 12.0, 0.9), _w("c", 11.9, 12.0, 0.1)]),
    "empty": ([], []),
}


@pytest.mark.parametrize("case", list(FILTER_CASES))
def test_filter_hallucinations_equal_jax(case):
    segments, words = FILTER_CASES[case]
    ref = jtranscribe.filter_hallucinations(
        [dict(s) for s in segments], [dict(w) for w in words], 2.0, 60.0)
    ours = transcribe.filter_hallucinations(
        [dict(s) for s in segments], [dict(w) for w in words], 2.0, 60.0)
    assert ours == ref
    for w in words:
        assert transcribe._word_anomaly_score(w) == jtranscribe._word_anomaly_score(w)
    assert transcribe._is_segment_anomaly(words) == jtranscribe._is_segment_anomaly(words)
