"""The port's Diarizer, fusion, metrics and ``cli diarize`` against the
JAX package's, on the CPU.

The meeting is the JAX suite's first held-out 20 s, 3-speaker meeting
(``tests/test_bundled_diarizer.py``: rng 13579, ``window_step_s=2.0``),
built with the port's copy of ``synth_voice``.  With the embedding convs
in float32 on both sides (the ``f32`` fixture patches JAX's
``emb_lib.forward`` default and re-jits its ``embed_crops`` inside the
test; nothing in the JAX package changes) the turns must be equal; at
the bf16 default the two frameworks round the convs at different
points, so the speaker count must be equal and the DER between the two
turn lists at most 0.01.  The contract cases are those of the JAX suite's
``tests/test_diarization.py``.
"""
import functools
import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from audio_processor_tpu import cli as jcli
from audio_processor_tpu.models.diarization import convert as jconvert
from audio_processor_tpu.models.diarization import embedding as jemb
from audio_processor_tpu.models.diarization import segmentation as jseg
from audio_processor_tpu.pipeline import diarize as jdiarize
from audio_processor_tpu.pipeline import fuse as jfuse
from audio_processor_tpu.utils import metrics as jmetrics
from audio_processor_tpu_torch import cli
from audio_processor_tpu_torch.models.diarization import checkpoint as ckpt
from audio_processor_tpu_torch.models.diarization import clustering as cl_mod
from audio_processor_tpu_torch.models.diarization import embedding as emb
from audio_processor_tpu_torch.models.diarization import segmentation as seg
from audio_processor_tpu_torch.pipeline import diarize, fuse
from audio_processor_tpu_torch.pipeline.diarize import Diarizer
from audio_processor_tpu_torch.runtime.device import set_full_fp32
from audio_processor_tpu_torch.utils import metrics, wavio

set_full_fp32()
JDiarizer = jdiarize.Diarizer


def make_meeting(rng, f0s, duration_s=20.0, sr=16_000):
    """The JAX suite's held-out meeting generator."""
    audio = rng.normal(0, 0.003, int(duration_s * sr)).astype(np.float32)
    ref = []
    t, i = 0.3, 0
    while t < duration_s - 2.0:
        spk = i % len(f0s)
        dur = float(rng.uniform(1.2, 2.0))
        a, b = int(t * sr), int(min(t + dur, duration_s) * sr)
        audio[a:b] += ckpt.synth_voice(rng, f0s[spk], b - a, sr)
        ref.append({"start": round(t, 3), "end": round(t + dur, 3), "speaker": f"REF_{spk}"})
        t += dur + float(rng.uniform(0.3, 0.6))
        i += 1
    return audio, ref


@pytest.fixture(scope="module")
def meeting():
    rng = np.random.default_rng(13579)
    f0s = (float(rng.uniform(95, 120)), float(rng.uniform(190, 240)), float(rng.uniform(320, 378)))
    return make_meeting(rng, f0s)


@pytest.fixture(scope="module")
def pair():
    return Diarizer.bundled(window_step_s=2.0, device="cpu"), JDiarizer.bundled(window_step_s=2.0)


@pytest.fixture
def f32(monkeypatch):
    """Embedding convs in float32 on both sides."""
    monkeypatch.setattr(jemb, "forward", functools.partial(jemb.forward, compute_dtype=jnp.float32))
    monkeypatch.setattr(jemb, "embed_crops",
                        jax.jit(jemb.embed_crops.__wrapped__, static_argnames=("cfg",)))
    monkeypatch.setattr(emb, "embed_crops",
                        functools.partial(emb.embed_crops, compute_dtype=torch.float32))


def test_bundled_turns_equal_jax_in_float32(pair, meeting, f32):
    d, jd = pair
    audio, ref = meeting
    turns = d.diarize(audio)
    assert turns and turns == jd.diarize(audio)
    assert metrics.diarization_error_rate(ref, turns) <= 0.30


def test_bundled_bf16_default_agrees_with_jax(pair, meeting):
    d, jd = pair
    audio, ref = meeting
    turns, jturns = d.diarize(audio), jd.diarize(audio)
    assert turns
    assert len({t["speaker"] for t in turns}) == len({t["speaker"] for t in jturns})
    assert metrics.diarization_error_rate(jturns, turns, collar_s=0.0) <= 0.01
    assert metrics.diarization_error_rate(ref, turns) <= 0.30


def test_other_sample_rate_resamples_like_jax(pair, meeting, f32):
    d, jd = pair
    audio = meeting[0][::2]  # 8 kHz
    turns = d.diarize(audio, sample_rate=8_000)
    assert turns and turns == jd.diarize(audio, sample_rate=8_000)


def test_return_embeddings_equal_jax(pair, meeting, f32):
    d, jd = pair
    turns, cents = d.diarize(meeting[0], return_embeddings=True)
    jturns, jcents = jd.diarize(meeting[0], return_embeddings=True)
    assert turns == jturns == d.diarize(meeting[0])
    assert cents.shape == jcents.shape and np.abs(cents - jcents).max() <= 1e-4
    np.testing.assert_allclose(np.linalg.norm(cents, axis=1), 1.0, atol=1e-5)
    assert d.diarize(np.zeros(1000, np.float32), return_embeddings=True) == ([], None)


@pytest.mark.parametrize("kw", [dict(num_speakers=1), dict(num_speakers=2), dict(max_speakers=2),
                                dict(min_speakers=4)])
def test_call_time_speaker_constraints_equal_jax(pair, meeting, f32, kw):
    d, jd = pair
    turns = d.diarize(meeting[0], **kw)
    assert turns == jd.diarize(meeting[0], **kw)
    if "num_speakers" in kw:
        assert len({t["speaker"] for t in turns}) <= kw["num_speakers"]
    assert d.min_speakers == 1 and d.max_speakers is None  # instance defaults untouched


def test_decode_knobs_equal_jax(pair, meeting, f32):
    """Hysteresis, gap fill, min length and the overlap gate, together."""
    d, jd = pair
    knobs = dict(offset=0.3, min_duration_off=0.2, min_duration_on=0.5, overlap_onset=0.6)
    import dataclasses

    turns = dataclasses.replace(d, **knobs).diarize(meeting[0])
    assert turns and turns == dataclasses.replace(jd, **knobs).diarize(meeting[0])


def test_invalid_calls_raise_before_decoding(pair, tmp_path):
    d, _ = pair
    missing = str(tmp_path / "never_written.wav")
    with pytest.raises(ValueError, match="num_speakers"):
        d.diarize(missing, num_speakers=2, min_speakers=1)
    with pytest.raises(ValueError, match="min_speakers"):
        d.diarize(np.zeros(16_000, np.float32), min_speakers=4, max_speakers=2)
    assert d.diarize(np.zeros(1000, np.float32)) == []


def test_path_input_equals_array(pair, meeting, tmp_path):
    d, _ = pair
    path = str(tmp_path / "meeting.wav")
    wavio.write_wav(path, meeting[0][: 12 * 16_000], 16_000)
    decoded = wavio.read_wav_mono(path)[0]
    assert d.diarize(path) == d.diarize(decoded)


def test_helpers_equal_jax():
    m = np.array([0, 1, 1, 0, 1, 0, 0, 1, 1, 1], bool)
    assert list(diarize._runs(m)) == list(jdiarize._runs(m)) == [(1, 3), (4, 5), (7, 10)]
    assert list(diarize._runs(np.zeros(5, bool))) == []
    t = np.array([0.1, 0.6, 0.4, 0.45, 0.7, 0.2, 0.42, 0.44, 0.1])
    t2 = np.array([0.6, 0.6, 0.1, 0.1, 0.6, 0.6])
    t3 = np.array([0.4, 0.45, 0.6, 0.4, 0.1])
    for track, onset, offset, gap in [(t, 0.5, 0.5, 0), (t, 0.5, 0.35, 0), (t2, 0.5, 0.5, 0),
                                      (t2, 0.5, 0.5, 3), (np.zeros(4), 0.5, 0.3, 2),
                                      (t3, 0.5, 0.35, 0)]:
        assert list(diarize._binarize(track, onset, offset, gap)) == \
            list(jdiarize._binarize(track, onset, offset, gap))
    mean = np.array([[0.9, 0.55], [0.9, 0.65], [0.4, 0.45]])
    np.testing.assert_array_equal(diarize._overlap_gate(mean, 0.6), jdiarize._overlap_gate(mean, 0.6))


def test_stitch_unions_same_cluster_slots(monkeypatch):
    """Two slots of one window in one cluster combine by max: averaging a
    strong slot with its weak half-window leak would fall below the onset
    and delete the turn (the JAX suite's case)."""
    gen = torch.Generator().manual_seed(1)
    d = Diarizer.random_init(window_step_s=10.0, device="cpu",
                             emb_cfg=emb.EmbeddingConfig(blocks=(1, 1, 1, 1)))
    d.emb_params = emb.init_params(d.emb_cfg, gen)
    n_frames = d.seg_cfg.num_frames

    def fake_seg(params, cfg, windows):
        probs = torch.zeros((windows.shape[0], n_frames, 3))
        probs[:, :, 0] = 0.9
        probs[:, : n_frames // 2, 1] = 0.6
        return probs

    d.seg_fn = fake_seg
    d.min_speech_s = 0.0
    monkeypatch.setattr(cl_mod, "agglomerative_cluster", lambda e, **kw: np.zeros(len(e), np.int64))
    audio = np.random.default_rng(0).normal(0, 0.2, 10 * 16_000).astype(np.float32)
    turns = d.diarize(audio)
    assert {t["speaker"] for t in turns} == {"SPEAKER_00"}
    assert max(t["end"] for t in turns) > 8.0, turns


def test_from_npz_serves_hard_decode(tmp_path):
    """A converted pack (written by the JAX package's save_diarizer_params
    from random params): the port loads both nets as the JAX loader reads
    them, decodes by argmax and marks the provenance."""
    jseg_params = jseg.init_params(jseg.SegmentationConfig(), jax.random.PRNGKey(0))
    jemb_params = jemb.init_params(jemb.EmbeddingConfig(), jax.random.PRNGKey(1))
    path = str(tmp_path / "pack.npz")
    jconvert.save_diarizer_params(path, jseg_params, jemb_params)
    d = Diarizer.from_npz(path, device="cpu")
    assert d.hard_decode and d.provenance == "converted" and d.untrained_parts == []
    jd = JDiarizer.from_npz(path)
    for f in ("hard_decode", "provenance", "seg_trained", "emb_trained", "onset"):
        assert getattr(d, f) == getattr(jd, f)
    seg_tree, emb_tree = jconvert.load_diarizer_params(path)
    want = seg.params_from_jax(jax.tree.map(np.asarray, seg_tree)).state_dict()
    for k, v in d.seg_params.state_dict().items():
        assert torch.equal(v, want[k]), k
    want = emb.params_from_jax(jax.tree.map(np.asarray, emb_tree)).state_dict()
    for k, v in d.emb_params.state_dict().items():
        assert torch.equal(v, want[k]), k
    windows = np.random.default_rng(2).normal(0, 0.2, (2, d.seg_cfg.window_samples)).astype(np.float32)
    acts = d._segment_all(windows)
    logits = d.seg_params(torch.from_numpy(d._to_i16(windows).astype(np.float32) / 32768.0))
    member = seg.powerset_matrix(d.seg_cfg)
    np.testing.assert_array_equal(acts, member[logits.argmax(-1).numpy()])
    for t in d.diarize(np.random.default_rng(3).normal(0, 0.2, 12 * 16_000).astype(np.float32)):
        assert 0 <= t["start"] <= t["end"] <= 12.0 and t["speaker"].startswith("SPEAKER_")


@pytest.mark.parametrize("segmentation", ["pyannet", "tpu"])
def test_random_init_contract(segmentation):
    d = Diarizer.random_init(segmentation=segmentation, window_step_s=5.0, device="cpu",
                             emb_cfg=emb.EmbeddingConfig(blocks=(1, 1, 1, 1)))
    assert d.untrained_parts == ["segmentation", "embedding"]
    audio = np.random.default_rng(0).normal(0, 0.2, 12 * 16_000).astype(np.float32)
    turns = d.diarize(audio)
    for t in turns:
        assert set(t) == {"start", "end", "speaker"} and 0 <= t["start"] <= t["end"] <= 12.05
    assert [t["start"] for t in turns] == sorted(t["start"] for t in turns)


def test_mesh_and_missing_card_raise(monkeypatch):
    """A device other than the mesh's raises, as the Transcriber's does;
    so does the default device without a card."""
    from audio_processor_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match="is not the mesh's"):
        Diarizer.bundled(device="cpu", mesh=Mesh(1, 1, 0, 0, torch.device("cuda", 0)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Diarizer.bundled()


# --- fusion and metrics ------------------------------------------------------------

ASR = [
    {"start": 0.0, "end": 2.0, "text": "hello"},
    {"start": 2.0, "end": 4.0, "text": "world"},
    {"start": 10.0, "end": 11.0, "text": "late"},
    {"start": 30.0, "end": 31.0, "text": "far"},
]
TURNS = [
    {"start": 0.0, "end": 1.4, "speaker": "SPEAKER_00"},
    {"start": 1.4, "end": 9.5, "speaker": "SPEAKER_01"},
]


def test_fuse_relabel_format_equal_jax(pair, meeting):
    for asr, turns in [(ASR, TURNS), (ASR, []), ([], TURNS), (ASR[:1], TURNS[:1])]:
        assert fuse.fuse_segments(asr, turns) == jfuse.fuse_segments(asr, turns)
    # the meeting's turns against fixed ASR rows
    rows = [{"start": float(s), "end": float(s) + 1.7, "text": f"row {i}"}
            for i, s in enumerate(np.arange(0.0, 20.0, 1.3))]
    turns = pair[0].diarize(meeting[0])
    fused = fuse.fuse_segments(rows, turns, tolerance_s=0.5)
    assert fused == jfuse.fuse_segments(rows, turns, tolerance_s=0.5)
    names = {"SPEAKER_00": "Alice"}
    assert fuse.relabel_speakers(fused, names) == jfuse.relabel_speakers(fused, names)
    for ts in (True, False):
        assert fuse.format_transcript(fused, ts) == jfuse.format_transcript(fused, ts)


def test_metrics_equal_jax(pair, meeting):
    for ref, hyp in [("the cat sat", "the cat sat"), ("The cat, sat!", "the hat sat on"),
                     ("", ""), ("", "x"), ("a b c d", "a c d e f")]:
        assert metrics.word_error_rate(ref, hyp) == jmetrics.word_error_rate(ref, hyp)
    turns = pair[0].diarize(meeting[0])
    for ref, hyp in [(meeting[1], turns), (meeting[1], []), ([], turns), ([], []),
                     (TURNS, turns)]:
        for collar in (0.25, 0.0):
            assert metrics.diarization_error_rate_detailed(ref, hyp, collar_s=collar) == \
                jmetrics.diarization_error_rate_detailed(ref, hyp, collar_s=collar)


def test_cli_diarize_json_equal_jax(meeting, tmp_path, capsys, f32):
    path = str(tmp_path / "meeting.wav")
    wavio.write_wav(path, meeting[0], 16_000)
    cli.main(["diarize", path, "--json", "--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    jcli.main(["diarize", path, "--json"])
    assert got and got == json.loads(capsys.readouterr().out)
    cli.main(["diarize", path, "--device", "cpu", "--num-speakers", "2"])
    lines = capsys.readouterr().out.splitlines()
    assert lines and all("SPEAKER_0" in ln for ln in lines)
