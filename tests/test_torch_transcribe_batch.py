"""The port's cross-request batching (Transcriber.transcribe_batch) against
the JAX package's, on the cases of its ``tests/test_transcribe_batch.py``
that need no later-slice option (word timestamps are one), and once on a
data-parallel gloo world of 2 ranks.

Every case holds the port's per-file results to JAX's transcribe_batch
(segments, tokens and timestamps exact, decode statistics within 1e-4)
and to the port's own per-file transcribe().

The module imports jax only inside its tests: the spawned ranks import
it to find the function they run.
"""
import numpy as np
import pytest
import torch

from audio_processor_tpu_torch.models.whisper import convert
from audio_processor_tpu_torch.models.whisper.config import WhisperConfig
from audio_processor_tpu_torch.parallel import mesh as mesh_lib
from audio_processor_tpu_torch.pipeline.transcribe import Transcriber
from test_torch_parallel import LetterTokenizer, World

BASE_KW = dict(compute_dtype="float32", max_new_tokens=8)
OPEN_KW = dict(tokenizer=LetterTokenizer(), no_speech_threshold=None)


def _pair(name="test", **kw):
    """JAX's Transcriber.random_init(name, **kw) and the port's Transcriber
    on its weights; plus the weights as numpy and the config's fields."""
    import jax

    from audio_processor_tpu.pipeline.transcribe import Transcriber as JTranscriber

    jt = JTranscriber.random_init(name, **kw)
    dims = {k: getattr(jt.cfg, k) for k in WhisperConfig.__dataclass_fields__}
    tree = jax.tree.map(np.asarray, jt.params)
    pt = Transcriber(params=convert.params_from_jax(tree, "cpu"), cfg=WhisperConfig(**dims),
                     device="cpu", enable_fallback=False, **kw)
    return jt, pt, tree, dims


@pytest.fixture(scope="module")
def pairs():
    return {"defaults": _pair(**BASE_KW), "open": _pair(**BASE_KW, **OPEN_KW)}


def _comparable(res: dict) -> dict:
    # rtf_x and the trace measure wall time (shared across a batch)
    return {k: v for k, v in res.items() if k not in ("rtf_x", "trace")}


def _assert_same(ours: dict, ref: dict, tol: float = 1e-4):
    """Text, duration, language and segments equal; per-segment decode
    statistics within tol (the two frameworks sum in different orders).
    The port's results carry its stage trace, which JAX's lack."""
    assert set(ours) - {"trace"} == set(ref) - {"trace"}
    for key in ("text", "duration", "language"):
        assert ours.get(key) == ref.get(key), key
    assert len(ours["segments"]) == len(ref["segments"])
    for so, sr in zip(ours["segments"], ref["segments"]):
        assert set(so) == set(sr)
        for k, v in sr.items():
            if isinstance(v, float) and k not in ("start", "end"):
                assert so[k] == pytest.approx(v, abs=tol), k
            else:
                assert so[k] == v, k


def _mixed_files() -> list[np.ndarray]:
    rng = np.random.default_rng(0)
    sr = 16_000
    tone = (0.3 * np.sin(2 * np.pi * 330 * np.arange(5 * sr) / sr)).astype(np.float32)
    return [tone, rng.normal(0, 0.1, 35 * sr).astype(np.float32),
            rng.normal(0, 0.1, 61 * sr).astype(np.float32)]


def test_batch_empty(pairs):
    assert pairs["defaults"][1].transcribe_batch([]) == []


@pytest.mark.parametrize("options", ["defaults", "open"])
def test_batch_matches_sequential(pairs, options):
    """Three files of 1, 2 and 3 windows in one shared slab: each result
    is JAX's transcribe_batch's and the port's own transcribe()'s."""
    jt, pt, _, _ = pairs[options]
    files = _mixed_files()
    batch = pt.transcribe_batch(files, remove_silence=False)
    ref = jt.transcribe_batch(files, remove_silence=False)
    seq = [pt.transcribe(f, remove_silence=False) for f in files]
    assert len(batch) == len(ref) == len(seq) == 3
    for b, r, s in zip(batch, ref, seq):
        _assert_same(b, r)
        _assert_same(b, s, tol=1e-5)
    if options == "open":
        assert all(b["segments"] for b in batch)


def test_batch_single_file(pairs):
    jt, pt, _, _ = pairs["open"]
    audio = np.random.default_rng(1).normal(0, 0.1, 35 * 16_000).astype(np.float32)
    (batch,) = pt.transcribe_batch([audio], remove_silence=False)
    _assert_same(batch, jt.transcribe_batch([audio], remove_silence=False)[0])
    _assert_same(batch, pt.transcribe(audio, remove_silence=False), tol=1e-5)


def test_batch_with_silence_removal(pairs):
    """Per-file silence trim and TimeMap: original-timeline stamps survive
    the shared slab."""
    jt, pt, _, _ = pairs["open"]
    sr = 16_000
    burst = np.random.default_rng(2).normal(0, 0.3, 2 * sr).astype(np.float32)
    a = np.zeros(20 * sr, np.float32)
    a[2 * sr: 4 * sr] = burst
    a[15 * sr: 17 * sr] = burst
    b = np.zeros(12 * sr, np.float32)
    b[6 * sr: 8 * sr] = burst
    batch = pt.transcribe_batch([a, b])
    for got, want, seq in zip(batch, jt.transcribe_batch([a, b]), [pt.transcribe(a), pt.transcribe(b)]):
        _assert_same(got, want)
        _assert_same(got, seq, tol=1e-5)
    assert batch[0]["duration"] == pytest.approx(20.0, abs=0.01)
    assert batch[1]["duration"] == pytest.approx(12.0, abs=0.01)


def test_batch_fallback_conditioned():
    """condition_on_previous_text needs per-file context inside the slab:
    both packages fall back to sequential calls, with equal results."""
    jt, pt, _, _ = _pair(compute_dtype="float32", max_new_tokens=6,
                         condition_on_previous_text=True, **OPEN_KW)
    assert not pt.supports_shared_slabs and not jt.supports_shared_slabs
    audio = np.random.default_rng(3).normal(0, 0.1, 35 * 16_000).astype(np.float32)
    (batch,) = pt.transcribe_batch([audio], remove_silence=False)
    _assert_same(batch, jt.transcribe_batch([audio], remove_silence=False)[0])
    _assert_same(batch, pt.transcribe(audio, remove_silence=False), tol=1e-5)
    assert batch["segments"]


def test_batch_language_detection_groups(speech_like_audio):
    """Multilingual model, no pinned language: each file gets its own voted
    language, as in JAX's batched detection."""
    jt, pt, _, _ = _pair("tiny", compute_dtype="float32", max_new_tokens=4,
                         no_speech_threshold=None)
    a1 = speech_like_audio[: 16_000 * 3]
    a2 = np.random.default_rng(4).normal(0, 0.15, 3 * 16_000).astype(np.float32)
    batch = pt.transcribe_batch([a1, a2], remove_silence=False)
    ref = jt.transcribe_batch([a1, a2], remove_silence=False)
    seq = [pt.transcribe(a1, remove_silence=False), pt.transcribe(a2, remove_silence=False)]
    assert [b.get("language") for b in batch] == [r.get("language") for r in ref] \
        == [s.get("language") for s in seq]
    assert batch[0].get("language") is not None
    for b, r, s in zip(batch, ref, seq):
        _assert_same(b, r)
        _assert_same(b, s, tol=1e-5)


def test_batch_on_segment_streams_per_file(pairs):
    """on_segment(file_idx, seg) fires as each slab lands, with the segments
    the final per-file results carry, as JAX's does."""
    jt, pt, _, _ = pairs["open"]
    rng = np.random.default_rng(5)
    files = [rng.normal(0, 0.1, 10 * 16_000).astype(np.float32),
             rng.normal(0, 0.1, 35 * 16_000).astype(np.float32)]
    live, jlive = {0: [], 1: []}, {0: [], 1: []}
    outs = pt.transcribe_batch(files, remove_silence=False,
                               on_segment=lambda fi, seg: live[fi].append(seg))
    jt.transcribe_batch(files, remove_silence=False,
                        on_segment=lambda fi, seg: jlive[fi].append(seg))
    for fi, out in enumerate(outs):
        want = sorted((s["start"], s["end"], s["text"]) for s in out["segments"])
        got = sorted((s["start"], s["end"], s["text"]) for s in live[fi])
        assert got == want and want
        assert got == sorted((s["start"], s["end"], s["text"]) for s in jlive[fi])


def test_path_inputs(pairs, tmp_path):
    """A WAV path decodes through the ingest stack and matches the array
    call; paths and arrays mix in transcribe_batch."""
    from audio_processor_tpu_torch.pipeline import ingest
    from audio_processor_tpu_torch.utils import wavio

    jt, pt, _, _ = pairs["open"]
    audio = np.random.default_rng(6).normal(0, 0.1, 5 * 16_000).astype(np.float32)
    p = tmp_path / "clip.wav"
    wavio.write_wav(str(p), audio, 16_000)
    decoded = ingest.load_audio(str(p))
    assert _comparable(pt.transcribe(str(p))) == _comparable(pt.transcribe(decoded))
    batch = pt.transcribe_batch([str(p), decoded])
    assert _comparable(batch[0]) == _comparable(batch[1])
    _assert_same(batch[0], jt.transcribe_batch([str(p)])[0])


def case_batch_dp2(tree, dims, files, kw):
    t = Transcriber(params=convert.params_from_jax(tree, "cpu"), cfg=WhisperConfig(**dims),
                    mesh=mesh_lib.make_mesh(1, device="cpu"), enable_fallback=False, **kw)
    assert t.mesh.shape == {"data": 2, "model": 1}
    return [_comparable(r) for r in t.transcribe_batch(files, remove_silence=False)]


# a multilingual toy config: language detection and its banked encoder rows
ML_DIMS = dict(name="ml", n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=2,
               n_audio_layer=1, n_vocab=51865, n_text_ctx=64, n_text_state=64,
               n_text_head=2, n_text_layer=1)


def _multilingual(speech):
    """JAX's Transcriber on ML_DIMS weights, their numpy tree, and three
    files whose voter windows differ (speech, noise, silence + speech)."""
    import jax

    from audio_processor_tpu.models.whisper import model as jmodel
    from audio_processor_tpu.models.whisper.config import WhisperConfig as JConfig
    from audio_processor_tpu.pipeline.transcribe import Transcriber as JTranscriber

    jcfg = JConfig(**ML_DIMS)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(12))
    jt = JTranscriber(params=jp, cfg=jcfg, compute_dtype="float32", max_new_tokens=4,
                      enable_fallback=False, **OPEN_KW)
    noise = np.random.default_rng(8).normal(0, 0.15, 40 * 16_000).astype(np.float32)
    files = [speech, noise, np.concatenate([np.zeros(30 * 16_000, np.float32), speech])]
    return jt, jax.tree.map(np.asarray, jp), files


@pytest.mark.parametrize("model", ["test", "multilingual"])
def test_batch_on_a_data_parallel_world(pairs, speech_like_audio, model):
    """transcribe_batch on a dp2 mesh of two gloo ranks: each rank encodes
    and decodes half of every shared slab (with the multilingual model the
    detection slabs too, whose banked rows the decode gathers across the
    ranks), and both return JAX's results."""
    if model == "test":
        jt, _, tree, dims = pairs["open"]
        files, kw = _mixed_files(), dict(BASE_KW, **OPEN_KW)
    else:
        jt, tree, files = _multilingual(speech_like_audio)
        dims = dict(ML_DIMS)
        kw = dict(compute_dtype="float32", max_new_tokens=4, **OPEN_KW)
    ref = jt.transcribe_batch(files, remove_silence=False)
    world = World(2)
    try:
        out = world.run(case_batch_dp2, tree, dims, files, kw)
    finally:
        world.close()
    for rank_results in out:
        for got, want in zip(rank_results, ref):
            _assert_same(got, _comparable(want))
    if model == "multilingual":
        assert all(r.get("language") for r in ref)
    assert torch.distributed.is_initialized() is False
