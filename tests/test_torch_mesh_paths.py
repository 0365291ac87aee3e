"""The port's mesh paths against the JAX package's, on the CPU: word
timestamps, int8 decoder weights, the Diarizer, and the meeting service
under ``APTPU_DISTRIBUTED=1``.

The distributed cases run in one gloo world of 4 ranks spawned once for
the module (``test_torch_parallel.World``), as dp2 x tp2 and dp4 x tp1
meshes of it; the JAX references run here, in the pytest process, on JAX's
own CPU mesh of the same shape (``make_mesh(n_devices=4, ...)``), at the
test config in float32 on the same weights.  The words gate is
``test_torch_transcribe_words.py``'s: strings, starts and ends equal,
probabilities within 1e-5.  The controller's own cases (a ValueError or a
RuntimeError on every rank, a progress callback that raises on rank 0, the
stop message, a rank that fails alone) run in worlds of 2 ranks on
stand-in models.

The module imports jax only inside its tests: the spawned ranks import
this module to find the functions they run.
"""
import datetime
import functools
import multiprocessing
import os
import queue
import shutil
import sqlite3
import tempfile
import time

import numpy as np
import pytest
import torch

from audio_processor_tpu_torch.models.whisper import align, convert, quantize
from audio_processor_tpu_torch.models.whisper.config import WhisperConfig
from audio_processor_tpu_torch.parallel import mesh as mesh_lib
from audio_processor_tpu_torch.parallel import sharding
from audio_processor_tpu_torch.pipeline.transcribe import Transcriber
from test_torch_parallel import LetterTokenizer, World

MESHES = {"dp2xtp2": 2, "dp4xtp1": 1}
MAX_NEW = 16
ASR = dict(compute_dtype="float32", max_new_tokens=MAX_NEW, no_speech_threshold=None,
           enable_fallback=False)


class SpacedLetters:
    """``test_torch_transcribe_words.SpacedLetters`` (defined here: the ranks
    unpickle it without importing jax): every fifth id a space."""

    def encode(self, text):
        return list(text.encode("utf-8"))

    def decode(self, ids):
        return "".join(" " if int(i) % 5 == 0 else chr(97 + int(i) % 26) for i in ids)


@pytest.fixture(scope="module")
def world():
    w = World(4)
    yield w
    w.close()


def _mesh(tp):
    return mesh_lib.make_mesh(tp, device="cpu")


def _jmesh(tp):
    from audio_processor_tpu.parallel import mesh as jmesh_lib

    return jmesh_lib.make_mesh(n_devices=4, model_parallel=tp)


@pytest.fixture(scope="module")
def base():
    """JAX's test-config Transcriber, its weights as a numpy tree and the dims."""
    import jax

    from audio_processor_tpu.pipeline.transcribe import Transcriber as JTranscriber

    jt = JTranscriber.random_init("test", **ASR)
    dims = {k: getattr(jt.cfg, k) for k in WhisperConfig.__dataclass_fields__}
    return jt, jax.tree.map(np.asarray, jt.params), dims


def _jax(base, tp, params=None, **kw):
    from audio_processor_tpu.pipeline.transcribe import Transcriber as JTranscriber

    jt = base[0]
    return JTranscriber(params=jt.params if params is None else params, cfg=jt.cfg,
                        mesh=_jmesh(tp), tokenizer=SpacedLetters(), **ASR, **kw)


def _port(tree, dims, tp, int8=False, **kw):
    params = convert.params_from_jax(tree, "cpu")
    if int8:
        params = quantize.quantize_decoder(params)
    return Transcriber(params=params, cfg=WhisperConfig(**dims), mesh=_mesh(tp), device="cpu",
                       tokenizer=SpacedLetters(), **ASR, **kw)


def _words(ws):
    return [(w["word"], w["start"], w["end"]) for w in ws]


def _summary(out):
    return ([(s["start"], s["end"], s["text"], tuple(s["tokens"]), _words(s.get("words", [])))
             for s in out["segments"]], _words(out.get("words", [])))


def _assert_equal(ours, ref):
    """``test_torch_transcribe_words.py``'s gate: segments and words equal,
    probabilities within 1e-5."""
    assert _summary(ours) == _summary(ref)
    for o, r in zip(ours.get("words", []), ref.get("words", [])):
        assert o["probability"] == pytest.approx(r["probability"], abs=1e-5)


# ---------------------------------------------------------------------------
# word timestamps on a mesh
# ---------------------------------------------------------------------------

WORD_CASES = [(m, call, f) for m in MESHES for call in ("transcribe", "batch")
              for f in ("words", "filter")]


def _files(speech):
    return [np.concatenate([speech] * 7), speech, speech[: 3 * 16_000]]


def case_words(tree, dims, tp, speech):
    """Every word case of one mesh: transcribe and transcribe_batch, with
    and without the hallucination filter."""
    out = {}
    for f, extra in (("words", {}), ("filter", dict(hallucination_silence_threshold=2.0))):
        t = _port(tree, dims, tp, word_timestamps=True, **extra)
        files = _files(speech)
        out[("transcribe", f)] = t.transcribe(files[0], remove_silence=False)
        out[("batch", f)] = t.transcribe_batch(files, remove_silence=False)
    return out


@pytest.fixture(scope="module")
def word_runs(world, base, speech_like_audio):
    """Each mesh's word runs: every rank's results, run once a mesh."""
    _, tree, dims = base
    return {m: world.run(case_words, tree, dims, tp, speech_like_audio, timeout=300.0)
            for m, tp in MESHES.items()}


@pytest.mark.parametrize("mesh,call,filt", WORD_CASES)
def test_words_on_a_mesh_equal_jax(base, word_runs, speech_like_audio, mesh, call, filt):
    """``transcribe`` (70 s: three windows, so the last dp4 rank aligns no
    row) and ``transcribe_batch`` (70 s, 10 s and 3 s in shared slabs) with
    word timestamps, with and without the hallucination filter: every rank
    returns rank 0's words, equal to JAX's Transcriber on its mesh."""
    extra = {} if filt == "words" else dict(hallucination_silence_threshold=2.0)
    jt = _jax(base, MESHES[mesh], word_timestamps=True, **extra)
    files = _files(speech_like_audio)
    ranks = [r[(call, filt)] for r in word_runs[mesh]]
    if call == "transcribe":
        refs, ranks = [jt.transcribe(files[0], remove_silence=False)], [[r] for r in ranks]
    else:
        refs = jt.transcribe_batch(files, remove_silence=False)
    for per_rank in ranks:
        for ours, ref, rank0 in zip(per_rank, refs, ranks[0]):
            _assert_equal(ours, ref)
            assert _summary(ours) == _summary(rank0)
    if filt == "words":
        assert ranks[0][0]["words"], "the case must produce words"
    else:  # random weights give improbable words: the filter drops segments
        plain = word_runs[mesh][0][(call, "words")]
        plain = plain if call == "batch" else [plain]
        assert sum(len(o["segments"]) for o in ranks[0]) < sum(len(o["segments"]) for o in plain)


THREE_HEADS = dict(name="three-heads", n_mels=80, n_audio_ctx=1500, n_audio_state=96,
                   n_audio_head=3, n_audio_layer=1, n_vocab=1024, n_text_ctx=64,
                   n_text_state=96, n_text_head=3, n_text_layer=2)


def _map_cfg(dims, heads):
    return WhisperConfig(**dims) if heads is None else WhisperConfig(**{**dims,
                                                                      "alignment_heads": heads})


def case_maps(dims, heads, states, forced):
    from audio_processor_tpu_torch.models.whisper import model

    m = _mesh(2)
    cfg = _map_cfg(dims, heads)
    params = model.init_params(cfg, torch.Generator().manual_seed(3))
    local = sharding.shard_params(params, m, cfg)
    rows = m.local_rows(states.shape[0])
    maps, probs = align.alignment_maps(local, cfg, torch.from_numpy(states[rows]), forced[rows],
                                       512, True, mesh=m)
    return maps, probs, (rows.start, rows.stop)


@pytest.mark.parametrize("config,heads", [("test", None), ("test", ((0, 1), (1, 0))),
                                          ("three-heads", None)])
def test_pooled_map_on_tp2_equals_one_process(world, base, config, heads):
    """The teacher-forced pass on dp2 x tp2 (rank heads, row-parallel sums,
    the weighted layers' maps gathered over the model group before
    pooling): the pooled map, or each alignment head's map, within 1e-6 of
    one process's, the token probabilities within 1e-6.  Three heads split
    2 + 1 over the model ranks, so the gather pads and cuts back."""
    from audio_processor_tpu_torch.models.whisper import model

    dims = base[2] if config == "test" else THREE_HEADS
    rng = np.random.default_rng(11)
    states = rng.normal(0, 1, (4, dims["n_audio_ctx"], dims["n_audio_state"])).astype(np.float32)
    forced = rng.integers(0, 500, (4, 12)).astype(np.int64)
    cfg = _map_cfg(dims, heads)
    params = model.init_params(cfg, torch.Generator().manual_seed(3))
    ref_maps, ref_probs = align.alignment_maps(params, cfg, torch.from_numpy(states), forced,
                                               512, True)
    out = world.run(case_maps, dims, heads, states, forced)
    for maps, probs, (lo, hi) in out:
        want = ref_maps[..., lo:hi, :, :] if heads else ref_maps[lo:hi]
        np.testing.assert_allclose(maps, want, atol=1e-6, rtol=0)
        np.testing.assert_allclose(probs, ref_probs[lo:hi], atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# int8 decoder weights on a data-only mesh
# ---------------------------------------------------------------------------

def case_int8(tree, dims, audio):
    t = _port(tree, dims, 1, int8=True)
    out = t.transcribe(audio, remove_silence=False)
    try:
        _port(tree, dims, 2, int8=True)
        refused = None
    except ValueError as exc:
        refused = str(exc)
    return out, refused, str(t.params["decoder"]["blocks"]["fc1"]["w8"].dtype)


def test_int8_weights_on_dp4_equal_jax(world, base, speech_like_audio):
    """quantize_decoder weights on dp4 x tp1 give the tokens and segments of
    JAX's Transcriber on its data-only mesh; on tp=2 both packages raise
    ValueError."""
    from audio_processor_tpu.models.whisper import quantize as jquantize

    _, tree, dims = base
    audio = np.concatenate([speech_like_audio] * 7)
    jq = jquantize.quantize_decoder(base[0].params)
    ref = _jax(base, 1, params=jq).transcribe(audio, remove_silence=False)
    with pytest.raises(ValueError):
        _jax(base, 2, params=jq)
    out = world.run(case_int8, tree, dims, audio)
    for segs, refused, w8 in out:
        assert w8 == "torch.int8"
        assert "model_parallel=1" in refused
        _assert_equal(segs, ref)
    assert out[0][0]["segments"]


# ---------------------------------------------------------------------------
# the Diarizer on a mesh
# ---------------------------------------------------------------------------

def _f32_port_embeddings():
    from audio_processor_tpu_torch.models.diarization import embedding as emb

    emb.embed_crops = functools.partial(emb.embed_crops, compute_dtype=torch.float32)


def case_diarize(audio, tp):
    from audio_processor_tpu_torch.models.diarization import embedding as emb
    from audio_processor_tpu_torch.pipeline.diarize import Diarizer

    real = emb.embed_crops
    _f32_port_embeddings()
    try:
        d = Diarizer.bundled(window_step_s=2.0, device="cpu", mesh=_mesh(tp))
        return d.diarize(audio), d.device.type
    finally:
        emb.embed_crops = real


@pytest.fixture(scope="module")
def meeting_audio():
    from test_torch_diarize import make_meeting

    rng = np.random.default_rng(13579)
    f0s = (float(rng.uniform(95, 120)), float(rng.uniform(190, 240)),
           float(rng.uniform(320, 378)))
    return make_meeting(rng, f0s)[0]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_diarizer_on_a_mesh_equals_jax(world, meeting_audio, mesh, monkeypatch):
    """The bundled Diarizer with ``mesh`` (slabs rounded up to the data
    axis, rows gathered) gives, on every rank, the turns of JAX's
    ``Diarizer(mesh=...)``, with the embedding convs in float32 on both
    sides (``test_torch_diarize.py``'s ``f32``)."""
    import jax
    import jax.numpy as jnp

    from audio_processor_tpu.models.diarization import embedding as jemb
    from audio_processor_tpu.pipeline.diarize import Diarizer as JDiarizer

    monkeypatch.setattr(jemb, "forward", functools.partial(jemb.forward, compute_dtype=jnp.float32))
    monkeypatch.setattr(jemb, "embed_crops",
                        jax.jit(jemb.embed_crops.__wrapped__, static_argnames=("cfg",)))
    ref = JDiarizer.bundled(window_step_s=2.0, mesh=_jmesh(MESHES[mesh])).diarize(meeting_audio)
    out = world.run(case_diarize, meeting_audio, MESHES[mesh])
    assert ref
    for turns, dev in out:
        assert dev == "cpu" and turns == ref


# ---------------------------------------------------------------------------
# the meeting service under APTPU_DISTRIBUTED=1
# ---------------------------------------------------------------------------

SERVICE_ENV = dict(APTPU_MODEL_PARALLEL="2")


def _small_service_models():
    """The service's models at a test size, in float32 (one definition for
    the mesh ranks and the one-process service): random_init with letters
    and 8 tokens, the embedding convs in float32."""
    real = Transcriber.random_init.__func__

    def random_init(cls, name="tiny", **kw):
        return real(cls, name, compute_dtype="float32", max_new_tokens=8,
                    tokenizer=LetterTokenizer(), no_speech_threshold=None, **kw)

    return {"random_init": classmethod(random_init)}


def _run_job(svc, wav, job_id):
    svc.engine.create_job(job_id, file_id=wav)
    svc.submit_processing_job(job_id, wav, None, None)
    deadline = time.time() + 120.0
    while time.time() < deadline:
        st = svc.engine.get_job_status(job_id)
        if st["status"] in ("completed", "failed", "cancelled"):
            return st
        time.sleep(0.05)
    raise AssertionError(f"job {job_id} did not finish")


def case_service(wav):
    """Every rank builds the service under APTPU_DISTRIBUTED=1; rank 0 makes
    a call that raises ValueError on every rank, runs one local-file job
    through its engine and stops the followers."""
    from audio_processor_tpu_torch.models.diarization import embedding as emb
    from audio_processor_tpu_torch.parallel.controller import MeshProxy
    from audio_processor_tpu_torch.runtime import services

    saved = dict(os.environ)
    real_init, real_emb = Transcriber.__dict__["random_init"], emb.embed_crops
    os.environ.update(SERVICE_ENV, APTPU_DISTRIBUTED="1")
    Transcriber.random_init = _small_service_models()["random_init"]
    _f32_port_embeddings()
    try:
        svc = services.build_services(model="test", max_workers=2, with_drive=False,
                                      with_llm=False, device="cpu")
        ctl = svc.controller
        if not ctl.is_leader:
            assert svc.engine is None
            ctl.follow()
            return {"followed": True, "mesh": ctl.mesh.shape}
        t = svc.processor.transcriber
        assert isinstance(t, MeshProxy) and isinstance(svc.processor.diarizer, MeshProxy)
        try:
            t.transcribe(np.zeros(3 * 16_000, np.float32), clip_timestamps=[(10.0, 20.0)])
            error = None
        except ValueError as exc:
            error = str(exc)
        try:
            st = _run_job(svc, wav, "mesh-job")
        finally:
            ctl.stop()
            svc.engine.shutdown(wait=False)
        return {"error": error, "status": st, "mesh": ctl.mesh.shape}
    finally:
        os.environ.clear()
        os.environ.update(saved)
        Transcriber.random_init = real_init
        emb.embed_crops = real_emb


def test_distributed_service_on_dp2_tp2_equals_one_process(world, meeting_audio, tmp_path,
                                                           monkeypatch):
    """``APTPU_DISTRIBUTED=1`` on a dp2 x tp2 world: rank 0's engine runs a
    local-file job (transcribe and diarize through the proxies, the other
    ranks replaying each call) whose result equals the one-process port
    service's on the same audio; a ValueError raised on every rank leaves
    the world serving, and the followers leave on the stop message."""
    from audio_processor_tpu_torch.models.diarization import embedding as emb
    from audio_processor_tpu_torch.runtime import services
    from audio_processor_tpu_torch.utils import wavio

    wav = str(tmp_path / "REC_20250617_093000.wav")
    wavio.write_wav(wav, meeting_audio, 16_000)
    out = world.run(case_service, wav, timeout=300.0)
    lead, followers = out[0], out[1:]
    assert all(f == {"followed": True, "mesh": {"data": 2, "model": 2}} for f in followers)
    assert lead["mesh"] == {"data": 2, "model": 2} and "selects no audio" in lead["error"]
    assert lead["status"]["status"] == "completed", lead["status"].get("error")

    for k, v in SERVICE_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(Transcriber, "random_init", _small_service_models()["random_init"])
    monkeypatch.setattr(emb, "embed_crops",
                        functools.partial(emb.embed_crops, compute_dtype=torch.float32))
    one = services.build_services(model="test", max_workers=1, with_drive=False,
                                  with_llm=False, device="cpu")
    try:
        assert one.controller is None
        ref = _run_job(one, wav, "one-process-job")
    finally:
        one.engine.shutdown(wait=False)
    timings = ("processing_s", "rtf_x")
    res = {k: v for k, v in lead["status"]["result"].items() if k not in timings}
    want = {k: v for k, v in ref["result"].items() if k not in timings}
    assert res["segments"] and res == want


# ---------------------------------------------------------------------------
# the controller in worlds of 2 ranks, on stand-in models
# ---------------------------------------------------------------------------

class _Summer:
    """A stand-in model: ``transcribe`` sums its audio over every rank (one
    collective, as a mesh call makes), raising ValueError on an empty
    input and, after the sum, RuntimeError on a negative scale (on every
    rank alike, as an out-of-memory error on a long input is); ``fail_on``
    ranks raise a RuntimeError of their own first."""

    def __init__(self, rank, fail_on=()):
        self.rank, self.fail_on = rank, fail_on

    def transcribe(self, audio, scale=1.0, progress=None):
        if len(audio) == 0:
            raise ValueError("empty audio")
        if self.rank in self.fail_on:
            raise RuntimeError(f"rank {self.rank} alone failed")
        x = torch.tensor([float(np.sum(audio)) * scale])
        torch.distributed.all_reduce(x)
        if scale < 0:
            raise RuntimeError("negative scale")
        if progress is not None:
            progress(1.0)
        return float(x)


def _locked_store(frac):
    """A job's progress callback whose store fails (rank 0 only)."""
    raise sqlite3.OperationalError("database is locked")


# rank 0's first call, which fails on every rank alike or in its callback
FIRST_CALLS = {
    "value_error": (np.zeros(0, np.float32), {}),
    "runtime_error": (np.ones(4, np.float32), {"scale": -1.0}),
    "progress_raises": (np.ones(4, np.float32), {"progress": _locked_store}),
}


def _controller_rank(rank, store, results, fail_on, first):
    import torch.distributed as dist

    from audio_processor_tpu_torch.parallel.controller import Controller

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=20))
    ctl = Controller(_mesh(1), {"primary": _Summer(rank, fail_on)})
    if not ctl.is_leader:
        ctl.follow()
        # leave the world before exiting: a gloo group still up at
        # interpreter exit can abort the process (SIGABRT, "terminate called
        # without an active exception"), as it did under load
        dist.destroy_process_group()
        results.put((rank, "followed"))
        return
    t = ctl.proxy("primary")
    seen = []
    audio, kw = FIRST_CALLS[first]
    try:
        t.transcribe(audio, **kw)
    except Exception as exc:  # noqa: BLE001 -- recorded for the test
        seen.append(f"{type(exc).__name__}: {exc}")
    time.sleep(1.0)  # idle: the follower waits on the control group
    seen.append(t.transcribe(np.arange(4, dtype=np.float32), scale=2.0,
                             progress=lambda f: seen.append(("progress", f))))
    ctl.stop()
    dist.destroy_process_group()
    results.put((rank, seen))


def _run_controller_world(fail_on=(), first="value_error"):
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="controller-world-")
    results = ctx.Queue()
    procs = [ctx.Process(target=_controller_rank,
                         args=(r, os.path.join(tmp, "store"), results, fail_on, first))
             for r in range(2)]
    try:
        for p in procs:
            p.start()
        # each rank's one result, read while the ranks run (a rank that ends
        # the world puts none), then the exits
        got = {}
        deadline = time.monotonic() + 120
        while len(got) < len(procs) and time.monotonic() < deadline:
            try:
                rank, value = results.get(timeout=1.0)
                got[rank] = value
            except queue.Empty:
                if not any(p.is_alive() for p in procs) and results.empty():
                    break
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        codes = [p.exitcode for p in procs]
        return codes, got
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)


def test_controller_replays_calls_and_stops():
    """Rank 0's proxied call is replayed by the follower (its all-reduce
    pairs with rank 0's: 2 x (0+1+2+3) x 2 ranks = 24, the callback on rank
    0 only), a ValueError raised on both ranks leaves the world serving,
    an idle rank 0 keeps it, and the stop message ends the follower's loop:
    both exit 0."""
    codes, got = _run_controller_world()
    assert codes == [0, 0]
    assert got == {0: ["ValueError: empty audio", ("progress", 1.0), 24.0], 1: "followed"}


@pytest.mark.parametrize("first", ["runtime_error", "progress_raises"])
def test_controller_failure_alike_on_every_rank_keeps_serving(first):
    """A RuntimeError that every rank raises at the same point, or an
    exception of rank 0's progress callback (held until the call's
    collectives are done), reaches rank 0's caller as in one process; the
    follower goes on, the next call is replayed, and both exit 0."""
    codes, got = _run_controller_world(first=first)
    want = {"runtime_error": "RuntimeError: negative scale",
            "progress_raises": "OperationalError: database is locked"}[first]
    assert codes == [0, 0]
    assert got == {0: [want, ("progress", 1.0), 24.0], 1: "followed"}


def test_controller_rank_local_failure_ends_the_world():
    """A failure on the follower alone, with rank 0 left in its all-reduce
    until the group's timeout: the ranks' outcomes differ, so both exit
    non-zero and no rank hangs."""
    codes, got = _run_controller_world(fail_on=(1,))
    assert codes[1] not in (0, None) and codes[0] not in (0, None)
    assert got == {}


def test_new_collectives_are_the_identity_without_a_world():
    """Without a process group (the 1x1 mesh) the mesh paths' collectives
    hand their input back: the head gather, the word-list gather, and the
    controller's group, broadcasts and outcome gather."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    mesh = _mesh(1)
    assert mesh.shape == {"data": 1, "model": 1}
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert mesh_lib.model_all_gather(x, mesh, dim=1, units=3) is x
    assert mesh_lib.model_all_gather(x, None, dim=1, units=3) is x
    assert mesh_lib.all_gather_object({"words": [1]}, mesh) == [{"words": [1]}]
    group = mesh_lib.control_group(60.0)
    assert group is None
    assert mesh_lib.broadcast(x, group) is x
    assert mesh_lib.broadcast_object({"op": "stop"}, group) == {"op": "stop"}
    assert mesh_lib.world_gather_object("RuntimeError", group) == ["RuntimeError"]
