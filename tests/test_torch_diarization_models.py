"""The port's diarization nets, clustering and checkpoint readers against
the JAX package's, on the CPU.

JAX weights (random from a PRNG key, or the bundled checkpoints) are
carried across by each net's ``params_from_jax``; inputs are made with
numpy from a seed.  Tolerances: logits and float32 embeddings 1e-4 (the
JAX suite's log-mel bar); bf16 embeddings by cosine >= 0.999, since the
two frameworks round bf16 convs at different points.
"""
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from audio_processor_tpu.models.diarization import clustering as jcl
from audio_processor_tpu.models.diarization import embedding as jemb
from audio_processor_tpu.models.diarization import segmentation as jseg
from audio_processor_tpu.models.diarization import segmentation_tpu as jst
from audio_processor_tpu.ops import fbank as jfbank
from audio_processor_tpu.pipeline.diarize import Diarizer as JDiarizer
from audio_processor_tpu.training import diarization_trainer as jdt
from audio_processor_tpu.training import embedding_trainer as jet
from audio_processor_tpu_torch.models.diarization import checkpoint as ckpt
from audio_processor_tpu_torch.models.diarization import clustering as cl
from audio_processor_tpu_torch.models.diarization import embedding as emb
from audio_processor_tpu_torch.models.diarization import segmentation as seg
from audio_processor_tpu_torch.models.diarization import segmentation_tpu as st
from audio_processor_tpu_torch.pipeline.diarize import ASSETS_DIR
from audio_processor_tpu_torch.runtime.device import set_full_fp32

set_full_fp32()

SEG_PATH = os.path.join(ASSETS_DIR, "diarizer_seg.npz")
EMB_PATH = os.path.join(ASSETS_DIR, "diarizer_emb.npz")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _audio(shape, seed, scale=0.1):
    return np.random.default_rng(seed).normal(0, scale, shape).astype(np.float32)


def test_powerset_matrix_equal():
    for cfg in (seg.SegmentationConfig(), st.TpuSegmentationConfig(),
                seg.SegmentationConfig(num_speakers=4, max_simultaneous=3)):
        jcfg = jseg.SegmentationConfig(num_speakers=cfg.num_speakers,
                                       max_simultaneous=cfg.max_simultaneous)
        np.testing.assert_array_equal(seg.powerset_matrix(cfg), jseg.powerset_matrix(jcfg))
        assert cfg.num_classes == jcfg.num_classes
    assert seg.SegmentationConfig().num_frames == jseg.SegmentationConfig().num_frames == 589


# --- the TPU-first segmentation net ----------------------------------------

NARROW_TPU = dict(n_layer=1, d_model=64, n_head=2)


@pytest.mark.parametrize("widths", ["narrow", "published"])
def test_tpu_segmentation_logits_equal_jax(widths):
    """A narrow random net on 2 s windows, and the config's published
    widths (d=192, 4 heads, 4 layers, 10 s windows) on one window."""
    kw = dict(NARROW_TPU, window_s=2.0) if widths == "narrow" else {}
    jcfg, cfg = jst.TpuSegmentationConfig(**kw), st.TpuSegmentationConfig(**kw)
    jp = jst.init_params(jcfg, jax.random.PRNGKey(0))
    x = _audio((2 if widths == "narrow" else 1, cfg.window_samples), 0)
    want = np.asarray(jst.forward(jp, jcfg, jnp.asarray(x)))
    net = st.params_from_jax(_np(jp), cfg)
    got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (len(x), cfg.num_frames, cfg.num_classes)
    assert np.abs(got - want).max() <= 1e-4


def test_bundled_tpu_segmentation_equal_jax():
    """The bundled net (its checkpoint's widths: d=128, 4 heads, 3 layers,
    6 s windows) on 2 windows: logits, then the soft and hard decodes of
    int16 windows (one of them silent, as a zero-padded slab row is)."""
    jp, jcfg = jdt.load_params(SEG_PATH)
    tree, cfg = ckpt.load_segmentation_params(SEG_PATH)
    assert (cfg.d_model, cfg.n_head, cfg.n_layer, cfg.n_mels, cfg.window_s) == (128, 4, 3, 80, 6.0)
    net = st.params_from_jax(tree, cfg)
    rng = np.random.default_rng(1)
    x = np.stack([jdt.synth_voice(rng, 150.0, cfg.window_samples, 16_000),
                  np.zeros(cfg.window_samples, np.float32)])
    want = np.asarray(jst.forward(jp, jcfg, jnp.asarray(x)))
    got = net(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-4
    i16 = np.clip(x * 32768.0, -32768, 32767).astype(np.int16)
    for hard in (False, True):
        want = np.asarray(jst.segment_windows(jp, jcfg, jnp.asarray(i16), hard=hard))
        got = st.segment_windows(net, cfg, torch.from_numpy(i16), hard=hard).numpy()
        assert got.shape == want.shape == (2, cfg.num_frames, 3)
        assert np.abs(got - want).max() <= 1e-4


def test_tpu_segmentation_random_init_matches_jax_layout():
    cfg = st.TpuSegmentationConfig(**NARROW_TPU)
    net = st.init_params(cfg, torch.Generator().manual_seed(0))
    ref = st.params_from_jax(_np(jst.init_params(jst.TpuSegmentationConfig(**NARROW_TPU),
                                                 jax.random.PRNGKey(0))), cfg)
    assert {k: v.shape for k, v in net.state_dict().items()} == \
        {k: v.shape for k, v in ref.state_dict().items()}
    probs = st.segment_windows(net, cfg, torch.from_numpy(_audio((1, cfg.window_samples), 2)))
    assert probs.shape == (1, cfg.num_frames, 3) and bool(((probs >= 0) & (probs <= 1 + 1e-5)).all())


# --- the pyannet ------------------------------------------------------------

SMALL_PYANNET = dict(window_s=2.0, lstm_layers=2, lstm_hidden=16, linear_dim=16)


def test_pyannet_logits_equal_jax():
    """Two LSTM layers, both directions: equal logits prove the gate and
    direction mapping of ``params_from_jax`` (JAX's scan cell, torch's
    nn.LSTM)."""
    jcfg, cfg = jseg.SegmentationConfig(**SMALL_PYANNET), seg.SegmentationConfig(**SMALL_PYANNET)
    jp = jseg.init_params(jcfg, jax.random.PRNGKey(0))
    # non-zero biases, so bi and bh are told apart
    jp["lstm"] = [{d: {**c, "bi": c["bi"] + 0.1 * i + 0.01, "bh": c["bh"] - 0.05}
                   for d, c in layer.items()} for i, layer in enumerate(jp["lstm"])]
    x = _audio((2, cfg.window_samples), 3)
    want = np.asarray(jseg.forward(jp, jcfg, jnp.asarray(x)))
    net = seg.params_from_jax(_np(jp), cfg)
    got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, cfg.num_frames, 7)
    assert np.abs(got - want).max() <= 1e-4
    for hard in (False, True):
        want = np.asarray(jseg.segment_windows(jp, jcfg, jnp.asarray(x), hard=hard))
        got = seg.segment_windows(net, cfg, torch.from_numpy(x), hard=hard).numpy()
        assert np.abs(got - want).max() <= 1e-4


def test_sinc_filters_equal_jax():
    jcfg, cfg = jseg.SegmentationConfig(), seg.SegmentationConfig()
    jp = jseg.init_params(jcfg, jax.random.PRNGKey(0))
    want = np.asarray(jseg.materialize_sinc_filters(jp["sinc"], jcfg))  # (k, 1, n)
    net = seg.params_from_jax(_np(jp), cfg)
    got = seg.materialize_sinc_filters(net.sinc, cfg).numpy()  # (n, 1, k)
    # float32 sines of arguments up to ~400 rad: a few 1e-6 apart
    assert np.abs(got.transpose(2, 1, 0) - want).max() <= 1e-5


def test_pyannet_random_init_matches_jax_layout():
    cfg = seg.SegmentationConfig(**SMALL_PYANNET)
    net = seg.init_params(cfg, torch.Generator().manual_seed(0))
    ref = seg.params_from_jax(_np(jseg.init_params(jseg.SegmentationConfig(**SMALL_PYANNET),
                                                   jax.random.PRNGKey(0))), cfg)
    assert {k: v.shape for k, v in net.state_dict().items()} == \
        {k: v.shape for k, v in ref.state_dict().items()}
    np.testing.assert_array_equal(net.sinc["low_hz"].numpy(), ref.sinc["low_hz"].numpy())


def test_hard_decode_is_powerset_argmax(monkeypatch):
    """A frame whose marginal P(spk0) = 0.55 crosses the onset while the
    argmax class is 'no speech': the soft decode says active, the hard
    decode (pyannote's to_multilabel) says silent, as in JAX.  JAX's
    ``segment_windows`` is traced afresh here, so that its trace reads the
    patched ``forward`` and not a cached one: JAX caches a function's trace
    by the function object, so re-jitting ``__wrapped__`` itself would reuse
    the trace another test made of it (``tests/test_diarization.py`` traces
    it at the same shapes with its own fake logits); a new function that
    calls it has no trace yet."""
    cfg = seg.SegmentationConfig()
    member = seg.powerset_matrix(cfg)
    p = np.full(len(member), 1e-6)
    p[0], p[1], p[4] = 0.45, 0.25, 0.30  # [], [0], [0, 1]
    logits = np.broadcast_to(np.log(p / p.sum()), (1, 5, len(member))).astype(np.float32)
    soft = seg.decode_powerset(torch.from_numpy(logits), cfg).numpy()
    hard = seg.decode_powerset(torch.from_numpy(logits), cfg, hard=True).numpy()
    monkeypatch.setattr(jseg, "forward", lambda params, c, audio: jnp.asarray(logits))
    def segment_windows(params, cfg, audio, hard=False):
        return jseg.segment_windows.__wrapped__(params, cfg, audio, hard=hard)

    fresh = jax.jit(segment_windows, static_argnames=("cfg", "hard"))
    jcfg = jseg.SegmentationConfig()
    jsoft = np.asarray(fresh({}, jcfg, jnp.zeros((1, 16_000))))
    jhard = np.asarray(fresh({}, jcfg, jnp.zeros((1, 16_000)), hard=True))
    assert soft[0, 0, 0] > 0.5 and hard[0, 0].sum() == 0
    np.testing.assert_allclose(soft, jsoft, atol=1e-6)
    np.testing.assert_array_equal(hard, jhard)


# --- the embedding net --------------------------------------------------------

SLIM = dict(blocks=(1, 1, 1, 1))


@pytest.mark.parametrize("n_mels", [80, 60])
def test_embeddings_equal_jax_in_float32(n_mels):
    """Slim ResNet, 2 crops: stride-2 convs meet even (298 frames, 80 mels)
    and odd (149 frames, 75 and 15 mels) sides, so XLA's SAME padding is
    held on both."""
    jcfg, cfg = jemb.EmbeddingConfig(n_mels=n_mels, **SLIM), emb.EmbeddingConfig(n_mels=n_mels, **SLIM)
    jp = jemb.init_params(jcfg, jax.random.PRNGKey(0))
    x = _audio((2, cfg.crop_samples), 4, scale=0.2)
    feats = jfbank.fbank(jnp.asarray(x), n_mels=n_mels)
    want = np.asarray(jemb.forward(jp, jcfg, feats, compute_dtype=jnp.float32))
    net = emb.params_from_jax(_np(jp), cfg)
    got = emb.embed_crops(net, cfg, torch.from_numpy(x), compute_dtype=torch.float32).numpy()
    assert got.shape == want.shape == (2, 256)
    assert np.abs(got - want).max() <= 1e-4


def test_bundled_embeddings_equal_jax():
    """The bundled ResNet (its checkpoint's widths: 16/32/64/128 channels,
    blocks 2/2/2/2, 128-d, 2 s crops) on 2 int16 crops: float32 within
    1e-4, the bf16 default by cosine >= 0.999."""
    jp, jcfg = jet.load_params(EMB_PATH)
    tree, cfg = ckpt.load_embedding_params(EMB_PATH)
    assert (cfg.base_channels, cfg.blocks, cfg.embed_dim, cfg.crop_s) == (16, (2, 2, 2, 2), 128, 2.0)
    net = emb.params_from_jax(tree, cfg)
    rng = np.random.default_rng(5)
    x = np.stack([jdt.synth_voice(rng, f0, cfg.crop_samples, 16_000) for f0 in (120.0, 300.0)])
    i16 = np.clip(x * 32768.0, -32768, 32767).astype(np.int16)
    feats = jfbank.fbank(jnp.asarray(i16.astype(np.float32) / 32768.0))
    want32 = np.asarray(jemb.forward(jp, jcfg, feats, compute_dtype=jnp.float32))
    got32 = emb.embed_crops(net, cfg, torch.from_numpy(i16), compute_dtype=torch.float32).numpy()
    assert np.abs(got32 - want32).max() <= 1e-4
    want16 = np.asarray(jemb.embed_crops(jp, jcfg, jnp.asarray(i16)))
    got16 = emb.embed_crops(net, cfg, torch.from_numpy(i16)).numpy()
    assert (got16 * want16).sum(axis=1).min() >= 0.999
    np.testing.assert_allclose(np.linalg.norm(got16, axis=1), 1.0, atol=1e-5)


def test_embedding_random_init_matches_jax_layout():
    cfg = emb.EmbeddingConfig(**SLIM)
    net = emb.init_params(cfg, torch.Generator().manual_seed(0))
    ref = emb.params_from_jax(_np(jemb.init_params(jemb.EmbeddingConfig(**SLIM),
                                                   jax.random.PRNGKey(0))), cfg)
    assert {k: v.shape for k, v in net.state_dict().items()} == \
        {k: v.shape for k, v in ref.state_dict().items()}


# --- clustering (the cases of the JAX suite's test_diarization.py) --------------

def _blobs(seed, sizes, dim, scale, extra=()):
    rng = np.random.default_rng(seed)
    parts = [rng.normal(0, scale, (n, dim)) + np.eye(dim)[i] for i, n in enumerate(sizes)]
    return np.concatenate([*parts, *extra])


CLUSTER_CASES = {
    "two_blobs": (_blobs(0, (20, 10), 16, 0.05), dict(threshold=0.5)),
    "max_constraint": (np.random.default_rng(1).normal(0, 1, (30, 8)),
                       dict(threshold=0.01, max_clusters=3)),
    "empty": (np.zeros((0, 4)), {}),
    "single": (np.ones((1, 4)), {}),
    "stray_plain": (_blobs(0, (6, 5), 16, 0.02, [(np.eye(16)[0] * 0.8 + np.eye(16)[5])[None]]),
                    dict(threshold=0.3)),
    "stray_dissolved": (_blobs(0, (6, 5), 16, 0.02, [(np.eye(16)[0] * 0.8 + np.eye(16)[5])[None]]),
                        dict(threshold=0.3, min_cluster_size=3)),
    "all_small": (_blobs(1, (2, 1), 8, 0.02), dict(threshold=0.3, min_cluster_size=5)),
    "min_clusters_2": (_blobs(0, (10, 8, 2), 16, 0.05),
                       dict(threshold=0.5, min_clusters=2, min_cluster_size=3)),
    "min_clusters_3": (_blobs(0, (10, 8, 2), 16, 0.05),
                       dict(threshold=0.5, min_clusters=3, min_cluster_size=3)),
}


@pytest.mark.parametrize("case", list(CLUSTER_CASES))
def test_ahc_labels_equal_jax(case):
    x, kw = CLUSTER_CASES[case]
    got = cl.agglomerative_cluster(x, **kw)
    np.testing.assert_array_equal(got, jcl.agglomerative_cluster(x, **kw))
    assert got.dtype == np.int64


# --- checkpoints ------------------------------------------------------------------

def _assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bundled_checkpoint_readers_equal_jax():
    tree, cfg = ckpt.load_segmentation_params(SEG_PATH)
    jtree, jcfg = jdt.load_params(SEG_PATH)
    _assert_trees_equal(tree, jtree)
    assert cfg.__dict__ == jcfg.__dict__
    assert ckpt.load_onset(SEG_PATH) == jdt.load_onset(SEG_PATH)
    assert ckpt.load_decode_meta(SEG_PATH) == jdt.load_decode_meta(SEG_PATH)
    tree, cfg = ckpt.load_embedding_params(EMB_PATH)
    jtree, jcfg = jet.load_params(EMB_PATH)
    _assert_trees_equal(tree, jtree)
    assert cfg.__dict__ == jcfg.__dict__
    assert ckpt.load_cluster_threshold(EMB_PATH) == jet.load_cluster_threshold(EMB_PATH)
    assert ckpt.load_cluster_threshold(SEG_PATH) is None


def test_decode_meta_reader_equal_jax(tmp_path):
    jcfg = jst.TpuSegmentationConfig(window_s=2.0, d_model=32, n_head=2, n_layer=1)
    params = jst.init_params(jcfg, jax.random.PRNGKey(0))
    path = str(tmp_path / "seg.npz")
    jdt.save_params(path, params, jcfg, onset=0.55,
                    decode={"offset": 0.3, "min_duration_off": 0.2, "min_cluster_size": 3.0})
    assert ckpt.load_onset(path) == jdt.load_onset(path) == pytest.approx(0.55)
    meta = ckpt.load_decode_meta(path)
    assert meta == jdt.load_decode_meta(path) and isinstance(meta["min_cluster_size"], int)
    tree, cfg = ckpt.load_segmentation_params(path)
    _assert_trees_equal(tree, jdt.load_params(path)[0])


def test_synth_voice_equal_jax():
    got = ckpt.synth_voice(np.random.default_rng(7), 180.0, 12_345, 16_000)
    want = jdt.synth_voice(np.random.default_rng(7), 180.0, 12_345, 16_000)
    np.testing.assert_array_equal(got, want)


def test_bundled_diarizer_metadata_equal_jax():
    from audio_processor_tpu_torch.pipeline.diarize import Diarizer

    d, jd = Diarizer.bundled(device="cpu"), JDiarizer.bundled()
    for f in ("onset", "offset", "min_duration_off", "min_duration_on", "overlap_onset",
              "min_cluster_size", "min_cluster_frac", "cluster_threshold", "provenance",
              "seg_trained", "emb_trained", "window_step_s", "hard_decode"):
        assert getattr(d, f) == getattr(jd, f), f
    assert d.untrained_parts == jd.untrained_parts == []
