"""The port's bundled-diarizer builder against the JAX repository's tool,
on the CPU.

The JAX tool (``tools/make_bundled_diarizer.py``) is imported by path.
Held to it:

- its numpy helpers, gate constants, configs and sweep grids, and the
  meetings and training batches it makes for the same seeds: bit-equal;
- one segmentation and one embedding training step from JAX's initial
  weights (carried across through JAX's ``save_params`` and the port's
  ``load_params``) on the same batch: the loss within 1e-5 relative
  (the trainers' step-0 bar, ``tests/test_torch_training.py``), at
  narrow widths, the embedding convs in float32 on JAX's fbank features;
- on the committed assets, a reduced calibration (one short meeting a
  split, a few grid points): the same picks and equal worst-gate
  medians, the embedding convs in float32 on both sides (the turns are
  then equal, ``tests/test_torch_diarize.py``).

And the port's own contract: a failed gate saves nothing; training and
``--recalibrate`` need ``--out-dir`` and never write the bundled assets.
"""
import functools
import hashlib
import importlib.util
import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from audio_processor_tpu.models.diarization import embedding as jemb
from audio_processor_tpu.models.diarization import segmentation_tpu as jseg_tpu
from audio_processor_tpu.ops import fbank as jfbank
from audio_processor_tpu.training import diarization_trainer as jdt
from audio_processor_tpu.training import embedding_trainer as jet
from audio_processor_tpu_torch.benchmarks import bundled_build
from audio_processor_tpu_torch.models.diarization import embedding as pemb
from audio_processor_tpu_torch.models.diarization import segmentation_tpu as pseg_tpu
from audio_processor_tpu_torch.pipeline.diarize import ASSETS_DIR
from audio_processor_tpu_torch.runtime.device import set_full_fp32
from audio_processor_tpu_torch.tools import make_bundled_diarizer as tool
from audio_processor_tpu_torch.training import diarization_trainer as pdt
from audio_processor_tpu_torch.training import embedding_trainer as pet
from audio_processor_tpu_torch.training import train_step as pts

set_full_fp32()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ASSETS = os.path.join(REPO, "audio_processor_tpu", "assets")
# narrow widths for the step-0 losses (a config of their own, so no other
# test's JAX trace is reused)
SEG_SMALL = dict(window_s=2.0, d_model=32, n_head=2, n_layer=1)
EMB_SMALL = dict(base_channels=8, blocks=(1, 1, 1, 1), embed_dim=24, crop_s=1.0)


@pytest.fixture(scope="module")
def jtool():
    spec = importlib.util.spec_from_file_location(
        "jax_make_bundled_diarizer", os.path.join(REPO, "tools", "make_bundled_diarizer.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same(a, b):
    """Equal nested data, numpy arrays by dtype, shape and bytes."""
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_same, a, b))
    return a == b


# ---------------------------------------------------------------------------
# Data, constants and grids
# ---------------------------------------------------------------------------

def test_constants_configs_and_grids_equal_jax(jtool):
    for name in ("F0_LO", "F0_HI", "CLEAN_GATE", "STRESS_GATE", "MANY_GATE", "LONG_GATE"):
        assert getattr(tool, name) == getattr(jtool, name), name
    for ours, ref in ((tool.SEG_CFG, jtool.SEG_CFG), (tool.EMB_CFG, jtool.EMB_CFG)):
        fields = [f for f in vars(ref)]
        assert fields and all(getattr(ours, f) == getattr(ref, f) for f in fields)
    # the JAX tool's grids, as its sweeps write them inline
    assert tool.THRESHOLD_GRID == [round(float(t), 2) for t in np.arange(0.25, 0.95, 0.05)]
    onset = 0.55
    grid = [{"offset": None if d is None else round(onset - d, 2), "min_duration_off": m,
             "overlap_onset": o}
            for d in tool.OFFSET_DROPS for m in tool.MIN_DURATION_OFFS for o in tool.OVERLAP_ONSETS]
    assert grid == [{"offset": off, "min_duration_off": mdoff, "overlap_onset": ovl}
                    for off in (None, round(onset - 0.15, 2), round(onset - 0.25, 2))
                    for mdoff in (0.0, 0.3) for ovl in (None, 0.6, 0.7)]
    assert tool.MIN_CLUSTER_FRACS == (0.0, 0.01, 0.02, 0.04)


def test_numpy_helpers_equal_jax(jtool):
    a, b = np.random.default_rng(11), np.random.default_rng(11)
    for kw in ({}, {"n": 4, "min_ratio": 1.18}, {"n": 7, "min_ratio": 1.12}):
        assert tool.sample_f0s(a, **kw) == jtool.sample_f0s(b, **kw)
    x = a.normal(0, 0.1, 16_000).astype(np.float32)
    b.normal(0, 0.1, 16_000)
    assert _same(tool._reverb(a, x, 0.05), jtool._reverb(b, x, 0.05))
    for kw in ({}, {"reverb_prob": 0.3, "noise": (0.002, 0.010)}, {"reverb_prob": 1.0}):
        assert _same(tool.augment(a, x, **kw), jtool.augment(b, x, **kw))
    for kw in ({"duration_s": 10.0}, {"duration_s": 8.0, "noise": 0.009, "reverb": True,
                                      "gap": (0.15, 0.4)},
               {"duration_s": 12.0, "noise": 0.005, "gap": (0.2, 0.5)}):
        f0s = tool.sample_f0s(a)
        assert f0s == jtool.sample_f0s(b)
        assert _same(tool.make_meeting(a, f0s, **kw), jtool.make_meeting(b, f0s, **kw))


def test_calibration_meetings_equal_jax(jtool):
    assert _same(tool._cal_meetings(1), jtool._cal_meetings(1))


class _Recorder:
    """Stands in for ``_diarizer``: records every meeting it is given and
    finds no speaker, so every gate fails."""

    def __init__(self):
        self.seen = []

    def __call__(self, *args, **kw):
        return self

    def diarize(self, audio):
        self.seen.append(audio)
        return []


def _short_meetings(monkeypatch, mod, cap_s=30.0):
    """``make_meeting`` at most ``cap_s`` long (the 21 min meetings too);
    the calls are recorded."""
    calls, real = [], mod.make_meeting

    def short(rng, f0s, duration_s=24.0, **kw):
        calls.append((f0s, duration_s, kw))
        return real(rng, f0s, min(duration_s, cap_s), **kw)

    monkeypatch.setattr(mod, "make_meeting", short)
    return calls


def test_validation_and_mcf_meetings_equal_jax(jtool, monkeypatch):
    """The validation splits and the min_cluster_frac meetings are built
    from the same seeds and recipes as JAX's (lengths capped here)."""
    seen = {}
    for name, mod in (("port", tool), ("jax", jtool)):
        calls = _short_meetings(monkeypatch, mod)
        rec = _Recorder()
        monkeypatch.setattr(mod, "_diarizer", rec)
        with pytest.raises(SystemExit, match="not saving"):
            mod.validate(None, 0.5, None, 0.6, trials=2)
        assert mod.calibrate_mcf(None, 0.5, None, 0.6, {}) == {}
        seen[name] = (calls, rec.seen)
    assert len(seen["port"][0]) == 2 * 3 + 2 + 2
    assert _same(seen["port"], seen["jax"])


# ---------------------------------------------------------------------------
# Training: batches and step-0 losses
# ---------------------------------------------------------------------------

def _capture(monkeypatch, module, into):
    """Wrap ``module.train_step``: record its batch (as numpy) and loss."""
    real = module.train_step

    def step(state, cfg, audio, labels, *rest, **kw):
        state, loss = real(state, cfg, audio, labels, *rest, **kw)
        into.append((np.asarray(audio), np.asarray(labels), float(loss)))
        return state, loss

    monkeypatch.setattr(module, "train_step", step)


def test_segmentation_step0_equals_jax(jtool, monkeypatch, tmp_path):
    jcfg, pcfg = jseg_tpu.TpuSegmentationConfig(**SEG_SMALL), pseg_tpu.TpuSegmentationConfig(**SEG_SMALL)
    monkeypatch.setattr(jtool, "SEG_CFG", jcfg)
    monkeypatch.setattr(tool, "SEG_CFG", pcfg)
    jstate = jdt.init_train_state(jcfg, jax.random.PRNGKey(0), lr=1e-3)  # the JAX tool's start
    path = str(tmp_path / "seg0.npz")
    jdt.save_params(path, jstate.params, jcfg)
    net, cfg = pdt.load_params(path)
    assert cfg == pcfg
    monkeypatch.setattr(tool, "_seg_state", lambda device, lr: pdt.SegTrainState(
        net, pdt.make_optimizer(lr).init(pts.tree_leaves(net)), 0))
    ours, ref = [], []
    _capture(monkeypatch, pdt, ours)
    _capture(monkeypatch, jtool.dt, ref)
    _, onset = tool.train_segmentation(np.random.default_rng(20260817), 1, 3, device="cpu")
    jtool.train_segmentation(np.random.default_rng(20260817), 1, 3)
    assert _same(ours[0][:2], ref[0][:2])  # the batch, bit for bit
    assert abs(ours[0][2] - ref[0][2]) <= 1e-5 * abs(ref[0][2])
    assert 0.2 <= onset <= 0.8


def test_embedding_step0_equals_jax(jtool, monkeypatch, tmp_path):
    jcfg, pcfg = jemb.EmbeddingConfig(**EMB_SMALL), pemb.EmbeddingConfig(**EMB_SMALL)
    monkeypatch.setattr(jtool, "EMB_CFG", jcfg)
    monkeypatch.setattr(tool, "EMB_CFG", pcfg)
    n_bank = 8
    jstate = jet.init_train_state(jcfg, n_bank, jax.random.PRNGKey(1), lr=1e-3)
    path = str(tmp_path / "emb0.npz")
    jet.save_params(path, jstate.params, jcfg)
    net, cfg = pet.load_params(path)
    assert cfg == pcfg
    head = torch.from_numpy(np.array(jstate.head_w))
    monkeypatch.setattr(tool, "_emb_state", lambda n, device, lr: pet.EmbTrainState(
        net, head, pet.make_optimizer(lr).init(pts.tree_leaves((net, head))), 0))
    # float32 convs on both sides, on JAX's fbank features (float32 fbanks
    # of the two backends differ at deep spectral nulls)
    monkeypatch.setattr(jemb, "forward", functools.partial(jemb.forward, compute_dtype=jnp.float32))
    f32_forward = pemb.ResNetEmbedding.forward
    monkeypatch.setattr(pemb.ResNetEmbedding, "forward",
                        lambda self, feats: f32_forward(self, feats, torch.float32))
    monkeypatch.setattr(pet.fbank_lib, "fbank", lambda audio, n_mels: torch.from_numpy(
        np.array(jfbank.fbank(jnp.asarray(audio.numpy()), n_mels=n_mels))))
    ours, ref = [], []
    _capture(monkeypatch, pet, ours)
    _capture(monkeypatch, jtool.et, ref)
    tool.train_embedding(np.random.default_rng(20260817), 1, 4, n_bank=n_bank, device="cpu")
    jtool.train_embedding(np.random.default_rng(20260817), 1, 4, n_bank=n_bank)
    assert _same(ours[0][0], ref[0][0])
    assert np.array_equal(ours[0][1], ref[0][1])
    assert abs(ours[0][2] - ref[0][2]) <= 1e-5 * abs(ref[0][2])


# ---------------------------------------------------------------------------
# Calibration on the committed assets
# ---------------------------------------------------------------------------

def _memo(fn):
    """The nets' outputs depend on their input alone: compute each once
    over a sweep (the clustering and binarisation are what it varies)."""
    cache = {}

    @functools.wraps(fn)
    def run(params, cfg, x, *a, **kw):
        arr = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
        key = (id(params), arr.shape, hashlib.sha1(arr.tobytes()).hexdigest(), a, tuple(kw.items()))
        if key not in cache:
            cache[key] = fn(params, cfg, x, *a, **kw)
        return cache[key]

    return run


@pytest.fixture
def calibration_pair(jtool, monkeypatch):
    """The committed pair in both packages, embedding convs in float32,
    the nets memoised, and the same three short calibration meetings."""
    monkeypatch.setattr(jemb, "forward", functools.partial(jemb.forward, compute_dtype=jnp.float32))
    monkeypatch.setattr(jemb, "embed_crops", _memo(
        jax.jit(jemb.embed_crops.__wrapped__, static_argnames=("cfg",))))
    monkeypatch.setattr(pemb, "embed_crops", _memo(
        functools.partial(pemb.embed_crops, compute_dtype=torch.float32)))
    monkeypatch.setattr(jseg_tpu, "segment_windows", _memo(jseg_tpu.segment_windows))
    monkeypatch.setattr(pseg_tpu, "segment_windows", _memo(pseg_tpu.segment_windows))
    rng = np.random.default_rng(424243)
    meetings = (
        [tool.make_meeting(rng, tool.sample_f0s(rng), duration_s=12.0)],
        [tool.make_meeting(rng, tool.sample_f0s(rng, n=4, min_ratio=1.18), duration_s=12.0,
                           noise=0.009, reverb=True, gap=(0.15, 0.4))],
        [tool.make_meeting(rng, tool.sample_f0s(rng, n=5, min_ratio=1.12), duration_s=16.0,
                           noise=0.005, gap=(0.2, 0.5))],
    )
    for mod in (tool, jtool):
        monkeypatch.setattr(mod, "_cal_meetings", lambda m=4: meetings)
    seg_path = os.path.join(ASSETS_DIR, "diarizer_seg.npz")
    emb_path = os.path.join(ASSETS_DIR, "diarizer_emb.npz")
    port = (pdt.load_params(seg_path)[0], pdt.load_onset(seg_path), pet.load_params(emb_path)[0])
    jseg = os.path.join(JAX_ASSETS, "diarizer_seg.npz")
    jemb_path = os.path.join(JAX_ASSETS, "diarizer_emb.npz")
    ref = (jdt.load_params(jseg)[0], jdt.load_onset(jseg), jet.load_params(jemb_path)[0])
    return port, ref, pet.load_cluster_threshold(emb_path), meetings


def _only(monkeypatch, jtool, keep):
    """Shrink the JAX tool's inline grids: a grid point ``keep`` refuses
    gets a diarizer that finds no speaker (DER 1.0), so it never wins and
    never joins the threshold plateau."""
    real = jtool._diarizer

    def pick(seg, onset, emb, thr, decode=None):
        return real(seg, onset, emb, thr, decode) if keep(thr, decode or {}) else _Recorder()

    monkeypatch.setattr(jtool, "_diarizer", pick)


def test_reduced_calibration_picks_equal_jax(jtool, monkeypatch, calibration_pair):
    port, ref, thr, meetings = calibration_pair
    splits = [(meetings[0], tool.CLEAN_GATE), (meetings[1], tool.STRESS_GATE),
              (meetings[2], tool.MANY_GATE)]
    ratio, meds = tool._worst_gate_ratio(tool._diarizer(*port, thr), splits)
    jratio, jmeds = jtool._worst_gate_ratio(jtool._diarizer(*ref, thr), splits)
    assert meds == jmeds and ratio == jratio

    grid = [0.4, 0.55, 0.7, 0.85]
    monkeypatch.setattr(tool, "THRESHOLD_GRID", grid)
    monkeypatch.setattr(tool, "OFFSET_DROPS", (None, 0.15))
    monkeypatch.setattr(tool, "MIN_DURATION_OFFS", (0.0,))
    monkeypatch.setattr(tool, "OVERLAP_ONSETS", (None, 0.6))
    onset = port[1]
    _only(monkeypatch, jtool, lambda t, d: t in grid and d.get("min_duration_off", 0.0) == 0.0
          and d.get("overlap_onset") in (None, 0.6)
          and d.get("offset") in (None, round(onset - 0.15, 2)))
    picked = tool.calibrate_threshold(*port)
    assert picked == jtool.calibrate_threshold(*ref) and picked in grid
    decode = tool.calibrate_binarize(*port, picked)
    assert decode == jtool.calibrate_binarize(*ref, picked)


# ---------------------------------------------------------------------------
# Saving
# ---------------------------------------------------------------------------

def _stub_training(monkeypatch, calls):
    """Training and calibration replaced by the committed pair and its
    saved calibration: what is left is main()'s gates and saving."""
    seg_path = os.path.join(ASSETS_DIR, "diarizer_seg.npz")
    emb_path = os.path.join(ASSETS_DIR, "diarizer_emb.npz")
    monkeypatch.setattr(tool, "train_segmentation", lambda rng, steps, batch, device=None: (
        calls.append("seg") or pdt.load_params(seg_path, device)[0], pdt.load_onset(seg_path)))
    monkeypatch.setattr(tool, "train_embedding", lambda rng, steps, batch, n_bank, device=None: (
        calls.append("emb") or pet.load_params(emb_path, device)[0]))
    monkeypatch.setattr(tool, "calibrate_threshold", lambda *a: pet.load_cluster_threshold(emb_path))
    monkeypatch.setattr(tool, "calibrate_binarize", lambda *a: pdt.load_decode_meta(seg_path))
    monkeypatch.setattr(tool, "calibrate_mcf", lambda *a: a[-1])


def test_a_failed_gate_saves_nothing(monkeypatch, tmp_path):
    calls = []
    _stub_training(monkeypatch, calls)
    _short_meetings(monkeypatch, tool, cap_s=10.0)
    monkeypatch.setattr(tool, "validate", functools.partial(tool.validate, trials=1, gate=-1.0))
    out = tmp_path / "out"
    with pytest.raises(SystemExit, match="held-out DER .* > -1.0"):
        tool.main(["--cpu", "--out-dir", str(out), "--cache-dir", str(tmp_path / "cache")])
    assert calls == ["seg", "emb"]
    assert not out.exists()  # the candidates went to the cache only
    assert sorted(os.listdir(tmp_path / "cache")) == ["cand_emb.npz", "cand_seg.npz"]


def test_recalibrate_saves_into_out_dir(monkeypatch, tmp_path):
    _stub_training(monkeypatch, [])
    monkeypatch.setattr(tool, "validate", lambda *a, **kw: 0.0)
    out = tmp_path / "out"
    tool.main(["--cpu", "--recalibrate", "--out-dir", str(out)])
    for name in ("diarizer_seg.npz", "diarizer_emb.npz"):
        with np.load(out / name) as got, np.load(os.path.join(ASSETS_DIR, name)) as want:
            assert sorted(got.files) == sorted(want.files)
            assert all(np.array_equal(got[k], want[k]) for k in want.files), name


def _asset_bytes():
    out = {}
    for name in sorted(os.listdir(ASSETS_DIR)):
        with open(os.path.join(ASSETS_DIR, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("argv", [["--cpu"], ["--cpu", "--recalibrate"],
                                  ["--cpu", "--from-cache"],
                                  ["--cpu", "--out-dir", ASSETS_DIR],
                                  ["--cpu", "--recalibrate", "--out-dir", ASSETS_DIR]])
def test_saving_needs_an_out_dir_outside_the_assets(monkeypatch, argv, capsys):
    calls = []
    _stub_training(monkeypatch, calls)
    before = _asset_bytes()
    with pytest.raises(SystemExit) as exc:
        tool.main(argv)
    assert exc.value.code == 2 and "--out-dir" in capsys.readouterr().err
    assert calls == [] and _asset_bytes() == before


@pytest.mark.parametrize("where", ["assets", "out_dir"])
def test_validate_only_reads_the_assets_or_the_out_dir(monkeypatch, tmp_path, where):
    """``--validate-only`` validates the pair in ``--out-dir`` when given,
    else the port's bundled assets, at their saved calibration."""
    src = ASSETS_DIR
    if where == "out_dir":
        _stub_training(monkeypatch, [])
        monkeypatch.setattr(tool, "validate", lambda *a, **kw: 0.0)
        src = str(tmp_path / "pair")
        tool.main(["--cpu", "--recalibrate", "--out-dir", src])
    seen, read = [], []
    monkeypatch.setattr(tool, "validate", lambda seg, onset, emb, thr, decode: seen.append(
        (onset, thr, decode)))
    real = pdt.load_onset
    monkeypatch.setattr(pdt, "load_onset", lambda path: read.append(path) or real(path))
    tool.main(["--cpu", "--validate-only"] + (["--out-dir", src] if where == "out_dir" else []))
    seg_path = os.path.join(src, "diarizer_seg.npz")
    assert read == [seg_path]
    assert seen == [(pdt.load_onset(seg_path),
                     pet.load_cluster_threshold(os.path.join(src, "diarizer_emb.npz")),
                     pdt.load_decode_meta(seg_path))]


def test_bundled_build_benchmark_times_each_stage(monkeypatch, tmp_path, capsys):
    """``benchmarks/bundled_build`` runs the tool's main with every stage
    timed, records a failed gate's message, and restores the stages."""
    _stub_training(monkeypatch, [])
    monkeypatch.setattr(tool, "validate", lambda *a, **kw: 0.0)
    argv = ["--cpu", "--out-dir", str(tmp_path / "out"), "--cache-dir", str(tmp_path / "cache")]
    record = bundled_build.timed_build(argv)
    assert record["outcome"] == "saved" and set(record["walls_s"]) == set(bundled_build.STAGES)
    assert sorted(os.listdir(tmp_path / "out")) == ["diarizer_emb.npz", "diarizer_seg.npz"]

    def failing(*a, **kw):
        raise SystemExit("gates FAILED — not saving:\n  stress DER 0.3 > 0.25")

    monkeypatch.setattr(tool, "validate", failing)
    out = tmp_path / "out2"
    assert bundled_build.main(["--json", str(tmp_path / "r.json")] + argv[:2] + [str(out)]
                              + argv[3:]) == 1
    with open(tmp_path / "r.json") as f:
        assert "stress DER 0.3 > 0.25" in json.load(f)["outcome"]
    assert not out.exists() and tool.validate is failing
    with pytest.raises(SystemExit):
        bundled_build.main(["--cpu"])  # the tool's own argument error passes through
    capsys.readouterr()
