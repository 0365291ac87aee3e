"""The port's ``build_services``, device probe and serve entry, on the CPU.

The same ``APTPU_*`` environment must give the same Transcriber and
Diarizer fields in both packages (the port's ``build_services`` runs with
``device="cpu"``); configured-but-missing paths raise FileNotFoundError;
``APTPU_DISTRIBUTED=1`` without a process group is the one-process service
(``tests/test_torch_mesh_paths.py`` runs it on a world); the probe raises
without a card and on a timeout.  The JAX suite's cases
(``tests/test_build_services.py``, ``tests/test_device_check.py``,
``tests/test_serve_entry.py``) run against the port.
"""
import base64
import dataclasses
import threading
import time

import pytest
import torch
import jax

from audio_processor_tpu.models.diarization import embedding as jemb
from audio_processor_tpu.models.whisper import convert as jconvert
from audio_processor_tpu.models.whisper import model as jmodel
from audio_processor_tpu.models.whisper.config import get_config as jget_config
from audio_processor_tpu.models.whisper.tokenizer import BPETokenizer as JBPETokenizer
from audio_processor_tpu.runtime import services as jservices
from audio_processor_tpu.training import embedding_trainer as jet
from audio_processor_tpu_torch import serve
from audio_processor_tpu_torch.pipeline.transcribe import Transcriber
from audio_processor_tpu_torch.runtime import device_check, services
from audio_processor_tpu_torch.runtime.device_check import DeviceUnresponsiveError, probe_device
from test_torch_server import call

BUNDLED_SEG = "audio_processor_tpu/assets/diarizer_seg.npz"
# fields that hold weights, devices or callables, not settings
# (the configs are compared as dicts: each package has its own classes)
NOT_SETTINGS = {"params", "tokenizer", "device", "mesh", "cfg", "seg_params", "emb_params",
                "seg_fn", "seg_cfg", "emb_cfg"}


@pytest.fixture(autouse=True)
def hermetic(monkeypatch):
    for var in ("GEMINI_API_KEY", "NOTION_TOKEN", "NOTION_DATABASE_ID", "GOOGLE_SA_JSON_PATH",
                "REDIS_HOST", "APTPU_DIARIZER_PATH", "APTPU_EMBEDDING_PATH", "APTPU_MODEL_PATH",
                "APTPU_DISTRIBUTED", "APTPU_WARMUP", "APTPU_FALLBACK_MODEL",
                "APTPU_FALLBACK_MODEL_PATH", "APTPU_TOKENIZER_PATH"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("CREDENTIAL_STORE_URL", "memory://")


def build_both(**kw):
    """``build_services`` of each package on the same environment."""
    kw = dict(dict(model="test", with_drive=False, with_llm=False, max_workers=1), **kw)
    jsvc = jservices.build_services(**kw)
    try:
        svc = services.build_services(device="cpu", **kw)
    except BaseException:
        jsvc.engine.shutdown(wait=False)
        raise
    return jsvc, svc


def settings(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if f.name not in NOT_SETTINGS}


def assert_same_settings(jobj, obj):
    ours, ref = settings(obj), settings(jobj)
    shared = ours.keys() & ref.keys()
    assert {k: ours[k] for k in shared} == {k: ref[k] for k in shared}
    return shared


ENVS = {
    "defaults": {},
    "decode": dict(APTPU_BEAM_SIZE="3", APTPU_PATIENCE="2.0", APTPU_BEST_OF="2",
                   APTPU_LENGTH_PENALTY="0.5", APTPU_CONDITION="1", APTPU_LANGUAGE="zh",
                   APTPU_TASK="translate", APTPU_INITIAL_PROMPT="Minutes.",
                   APTPU_CARRY_INITIAL_PROMPT="1", APTPU_PREFIX="So",
                   APTPU_MAX_INITIAL_TIMESTAMP="-1"),
    "gates": dict(APTPU_TEMPERATURE="0.2", APTPU_COMPRESSION_RATIO_THRESHOLD="None",
                  APTPU_LOGPROB_THRESHOLD="-0.5", APTPU_NO_SPEECH_THRESHOLD="0.3",
                  APTPU_WITHOUT_TIMESTAMPS="1", APTPU_MAX_INITIAL_TIMESTAMP="2.0"),
    "speakers": dict(APTPU_NUM_SPEAKERS="4"),
    "speaker_bounds": dict(APTPU_MIN_SPEAKERS="2", APTPU_MAX_SPEAKERS="6"),
    "tpu_segmentation_pack": dict(APTPU_DIARIZER_PATH=BUNDLED_SEG, APTPU_MIN_SPEAKERS="2"),
}


@pytest.mark.parametrize("env", list(ENVS))
def test_env_gives_equal_transcriber_and_diarizer_fields(env, monkeypatch):
    for k, v in ENVS[env].items():
        monkeypatch.setenv(k, v)
    jsvc, svc = build_both(diarization=True)
    try:
        jt, t = jsvc.processor.transcriber, svc.processor.transcriber
        shared = assert_same_settings(jt, t)
        assert len(shared) >= 30 and t.device == torch.device("cpu")
        assert dataclasses.asdict(t.cfg) == {k: v for k, v in dataclasses.asdict(jt.cfg).items()
                                             if k in dataclasses.asdict(t.cfg)}
        jd, d = jsvc.processor.diarizer, svc.processor.diarizer
        assert len(assert_same_settings(jd, d)) >= 17
        assert d.untrained_parts == jd.untrained_parts
        assert dataclasses.asdict(d.seg_cfg) == dataclasses.asdict(jd.seg_cfg)
        assert dataclasses.asdict(d.emb_cfg) == dataclasses.asdict(jd.emb_cfg)
        assert svc.processor.drive_capable == jsvc.processor.drive_capable
        assert (svc.processor.gemini, svc.processor.notion, svc.processor.drive) == (None,) * 3
        assert svc.credential_store is not None
    finally:
        jsvc.engine.shutdown(wait=False)
        svc.engine.shutdown(wait=False)


def test_trained_embedding_env_equal(tmp_path, monkeypatch):
    cfg = jemb.EmbeddingConfig(n_mels=24, base_channels=8, blocks=(1, 1, 1, 1), embed_dim=32,
                               crop_s=1.0)
    path = str(tmp_path / "emb.npz")
    jet.save_params(path, jemb.init_params(cfg, jax.random.PRNGKey(0)), cfg)
    monkeypatch.setenv("APTPU_EMBEDDING_PATH", path)
    jsvc, svc = build_both(diarization=True)
    try:
        jd, d = jsvc.processor.diarizer, svc.processor.diarizer
        assert_same_settings(jd, d)
        assert dataclasses.asdict(d.emb_cfg) == dataclasses.asdict(cfg)
        assert d.emb_trained and "embedding" not in d.untrained_parts
    finally:
        jsvc.engine.shutdown(wait=False)
        svc.engine.shutdown(wait=False)


@pytest.mark.parametrize("var", ["model_path", "APTPU_DIARIZER_PATH", "APTPU_EMBEDDING_PATH",
                                 "APTPU_FALLBACK_MODEL_PATH"])
def test_configured_but_missing_paths_raise(var, tmp_path, monkeypatch):
    missing = str(tmp_path / "nope" / "x.npz")
    kw = dict(model="test", with_drive=False, with_llm=False, device="cpu",
              diarization=var in ("APTPU_DIARIZER_PATH", "APTPU_EMBEDDING_PATH"))
    if var == "model_path":
        kw["model_path"] = missing
    else:
        monkeypatch.setenv(var, missing)
    with pytest.raises(FileNotFoundError, match="refusing"):
        services.build_services(**kw)


def test_distributed_raises(monkeypatch):
    """APTPU_DISTRIBUTED=1 with no multi-process environment: ``initialize``
    returns False and the service is the one-process service (no mesh, no
    controller), as JAX's is with one process."""
    monkeypatch.setenv("APTPU_DISTRIBUTED", "1")
    for var in ("APTPU_COORDINATOR", "APTPU_NUM_PROCESSES", "APTPU_PROCESS_ID",
                "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    svc = services.build_services(model="test", device="cpu", with_drive=False,
                                  with_llm=False)
    try:
        assert svc.controller is None and svc.engine is not None
        assert isinstance(svc.processor.transcriber, Transcriber)
        assert svc.processor.transcriber.mesh is None and svc.processor.diarizer.mesh is None
    finally:
        svc.engine.shutdown(wait=False)


def test_language_out_of_range_fails_at_startup(monkeypatch):
    monkeypatch.setenv("APTPU_LANGUAGE", "de")  # index 2 >= the test config's 2 languages
    with pytest.raises(ValueError, match="out of range"):
        services.build_services(model="test", with_drive=False, with_llm=False,
                                diarization=False, device="cpu")


@pytest.mark.parametrize("env", [
    dict(APTPU_WORD_TIMESTAMPS="1"), dict(APTPU_HALLUCINATION_SILENCE_S="2.5"),
])
def test_word_timestamps_env_builds_what_jax_builds(env, monkeypatch):
    """Once a NotImplementedError (the port had no word timestamps); now the
    word-timestamp environment builds JAX's Transcriber fields."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jsvc, svc = build_both()
    try:
        jt, t = jsvc.processor.transcriber, svc.processor.transcriber
        assert len(assert_same_settings(jt, t)) >= 30
        assert t.word_timestamps
        assert t.hallucination_silence_threshold == jt.hallucination_silence_threshold
    finally:
        jsvc.engine.shutdown(wait=False)
        svc.engine.shutdown(wait=False)


def test_model_path_serves_embedded_tokenizer(tmp_path):
    content = b"\n".join(base64.b64encode(bytes([b])) + b" " + str(b).encode()
                         for b in range(256))
    tok = JBPETokenizer.from_tiktoken_bytes(content)
    cfg = dataclasses.replace(jget_config("tiny"), n_audio_ctx=32, n_audio_state=64,
                              n_audio_head=2, n_audio_layer=1, n_text_ctx=48,
                              n_text_state=64, n_text_head=2, n_text_layer=1)
    path = str(tmp_path / "model.npz")
    jconvert.save_params(path, jmodel.init_params(cfg, jax.random.PRNGKey(0)), cfg,
                         tokenizer=tok)
    svc = services.build_services(model_path=path, with_drive=False, with_llm=False,
                                  diarization=False, device="cpu")
    try:
        served = svc.processor.transcriber.tokenizer
        assert type(served).__name__ == "BPETokenizer"
        assert served.decode(served.encode("hello world")) == "hello world"
    finally:
        svc.engine.shutdown(wait=False)


@pytest.mark.parametrize("raw,n_chunks", [("1", None), ("2", 2)])  # 1 = one slab
def test_warmup_env_runs_warmup(raw, n_chunks, monkeypatch):
    calls = []
    monkeypatch.setattr(Transcriber, "warmup", lambda self, n=None: calls.append(n) or 0.0)
    monkeypatch.setenv("APTPU_WARMUP", raw)
    svc = services.build_services(model="test", diarization=False, with_drive=False,
                                  with_llm=False, device="cpu", max_workers=1)
    svc.engine.shutdown(wait=False)
    assert calls == [n_chunks]


def test_warmup_decodes():
    t = Transcriber.random_init("test", compute_dtype="float32", max_new_tokens=4,
                                max_chunk_batch=2, device="cpu")
    assert t.warmup(2) > 0


def test_env_fallback_model_wires_processor(monkeypatch):
    monkeypatch.setenv("APTPU_FALLBACK_MODEL", "test")
    svc = services.build_services(model="test", with_drive=False, with_llm=False,
                                  diarization=False, device="cpu")
    try:
        fb = svc.processor.fallback_transcriber
        assert fb is not None and fb is not svc.processor.transcriber
        assert fb.device == torch.device("cpu")
    finally:
        svc.engine.shutdown(wait=False)


def test_persistent_store_startup_serves(tmp_path):
    """A persistent store runs orphan recovery and pruning at startup; a
    second stack on the same file comes up and serves."""
    url = f"sqlite://{tmp_path}/jobs.db"
    services.build_services(model="test", store_url=url, diarization=False,
                            with_drive=False, with_llm=False, device="cpu").engine.shutdown()
    svc = services.build_services(model="test", store_url=url, diarization=False,
                                  with_drive=False, with_llm=False, device="cpu")
    try:
        from audio_processor_tpu_torch.server.app import create_app

        status, data, _ = call(create_app(svc, secret_key="t"), "GET", "/api/health")
        assert status == 200 and data["status"] == "healthy"
        svc.clear_credentials()
    finally:
        svc.engine.shutdown(wait=False)


# ---------------------------------------------------------------------------
# the device probe
# ---------------------------------------------------------------------------

def test_probe_on_the_cpu_when_asked():
    assert probe_device(timeout_s=60.0, device="cpu") == "cpu"


def test_probe_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe_device(timeout_s=60.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        services.build_services(model="test", with_drive=False, with_llm=False)


def test_probe_times_out_on_a_hung_device():
    start = time.monotonic()
    with pytest.raises(DeviceUnresponsiveError) as ei:
        probe_device(timeout_s=0.2, _probe=lambda: time.sleep(30))
    assert time.monotonic() - start < 5
    assert "APTPU_DEVICE_INIT_TIMEOUT_S" in str(ei.value)
    assert "APTPU_DEVICE=cpu" in str(ei.value)


def test_probe_propagates_errors_and_zero_timeout_runs_inline(monkeypatch):
    def boom():
        raise ValueError("no devices")

    with pytest.raises(ValueError, match="no devices"):
        probe_device(timeout_s=5.0, _probe=boom)
    assert probe_device(timeout_s=0, _probe=lambda: "inline") == "inline"
    monkeypatch.setenv("APTPU_DEVICE_INIT_TIMEOUT_S", "0.2")
    with pytest.raises(DeviceUnresponsiveError):
        probe_device(_probe=lambda: time.sleep(30))


def test_default_probe_reads_back_the_sum():
    assert device_check._default_probe("cpu") == "cpu"


# ---------------------------------------------------------------------------
# the serve entry
# ---------------------------------------------------------------------------

def test_application_builds_exactly_once(monkeypatch):
    builds = []
    barrier = threading.Barrier(8)

    def fake_build_app():
        builds.append(1)
        time.sleep(0.1)  # widen the race window
        return lambda environ, start_response: [b"ok"]

    monkeypatch.setattr(serve, "build_app", fake_build_app)
    monkeypatch.setattr(serve, "_wsgi_app", None)
    results = []

    def hit():
        barrier.wait()
        results.append(serve.application({}, lambda *a: None))

    threads = [threading.Thread(target=hit) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(builds) == 1 and len(results) == 8


def test_build_app_reads_the_environment(tmp_path, monkeypatch):
    """APTPU_DEVICE=cpu is the way to the CPU; the model, store and worker
    count come from the same variables as the root ``serve.py``."""
    monkeypatch.setenv("APTPU_DEVICE", "cpu")
    monkeypatch.setenv("APTPU_MODEL", "test")
    monkeypatch.setenv("JOB_STORE_URL", f"sqlite://{tmp_path}/jobs.db")
    monkeypatch.setenv("MAX_WORKERS", "2")
    seen = {}
    real = services.build_services

    def spy(**kw):
        seen.update(kw)
        return real(**{**kw, "diarization": False, "with_drive": False, "with_llm": False})

    monkeypatch.setattr(services, "build_services", spy)
    app = serve.build_app()
    try:
        assert seen["device"] == "cpu" and seen["model"] == "test" and seen["max_workers"] == 2
        status, data, _ = call(app, "GET", "/api/health")
        assert status == 200 and data["active_jobs"] == 0
    finally:
        app.config["services"].engine.shutdown(wait=False)
