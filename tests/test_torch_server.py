"""The port's server against the JAX package's, on the CPU.

One scripted request sequence runs against JAX's ``create_app`` and the
port's, each on its own package's services: the job API (health, process
validation, process and poll, not found, result before completion, SSE
events, metrics in JSON and Prometheus form, the API-key gate) on the
9-stage job, and the ``/v1`` surface (transcriptions in json, text, srt,
vtt and verbose_json, translations, models, error envelopes, streaming),
on the same weights (``convert.params_from_jax``, float32).  Responses
must be equal once job ids and times are masked and floats are rounded to
1e-4, the word-timestamp requests (``timestamp_granularities[]=word``)
included.  The store, engine, cancel and redis cases of
``tests/test_runtime_server.py`` then run against the port.
"""
import io
import json
import os
import re
import tempfile
import threading
import time

import numpy as np
import pytest
import jax

from audio_processor_tpu.pipeline import meeting as jmeeting
from audio_processor_tpu.pipeline.transcribe import Transcriber as JTranscriber
from audio_processor_tpu.runtime import job_engine as jjob_engine
from audio_processor_tpu.runtime import services as jservices
from audio_processor_tpu.server import app as japp
from audio_processor_tpu.server import openai_api as jopenai_api
from audio_processor_tpu_torch.models.whisper import convert
from audio_processor_tpu_torch.models.whisper.config import WhisperConfig
from audio_processor_tpu_torch.pipeline import meeting
from audio_processor_tpu_torch.pipeline.transcribe import Transcriber
from audio_processor_tpu_torch.runtime import job_engine, services, trace
from audio_processor_tpu_torch.runtime.device import set_full_fp32
from audio_processor_tpu_torch.runtime.job_engine import JobCancelled, JobEngine
from audio_processor_tpu_torch.runtime.job_store import (
    MemoryJobStore,
    RedisJobStore,
    SqliteJobStore,
    make_store,
)
from audio_processor_tpu_torch.server import api as api_mod
from audio_processor_tpu_torch.server import app as app_mod
from audio_processor_tpu_torch.server import openai_api
from audio_processor_tpu_torch.server.web import App
from audio_processor_tpu_torch.utils import wavio
from fake_redis import FakeRedis
from test_torch_parallel import LetterTokenizer

set_full_fp32()

ASR_KW = dict(compute_dtype="float32", max_new_tokens=8, tokenizer=LetterTokenizer(),
              no_speech_threshold=None)
V1 = "/v1/audio/transcriptions"


def call(app, method, path, body=b"", ctype="application/json", headers=None, query=""):
    """One WSGI request; returns (status, body as JSON or text, headers)."""
    if isinstance(body, (dict, list)) or body is None:
        body = json.dumps(body).encode() if body is not None else b""
    environ = {
        "REQUEST_METHOD": method, "PATH_INFO": path, "QUERY_STRING": query,
        "CONTENT_LENGTH": str(len(body)), "CONTENT_TYPE": ctype,
        "wsgi.input": io.BytesIO(body),
    }
    for k, v in (headers or {}).items():
        environ["HTTP_" + k.upper().replace("-", "_")] = v
    got = {}

    def start_response(status, hdrs):
        got["status"], got["headers"] = int(status.split()[0]), dict(hdrs)

    it = app(environ, start_response)
    try:
        chunks = []
        for chunk in it:
            chunks.append(chunk)
            if b"event: end" in chunk:  # a job's SSE stream ends here
                break
    finally:
        getattr(it, "close", lambda: None)()
    payload = b"".join(chunks)
    try:
        data = json.loads(payload)
    except ValueError:
        data = payload.decode()
    return got["status"], data, got["headers"]


def wav_bytes(seconds: float, f0: float = 330.0) -> bytes:
    sr = 16_000
    t = np.arange(int(seconds * sr)) / sr
    x = 0.3 * np.sin(2 * np.pi * f0 * t) * (np.sin(2 * np.pi * 0.9 * t) > -0.3)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "a.wav")
        wavio.write_wav(path, x.astype(np.float32), sr)
        with open(path, "rb") as f:
            return f.read()


def multipart(fields: dict, file: tuple | None):
    """(body, content_type) of a multipart/form-data POST."""
    boundary = "testboundary42"
    out = io.BytesIO()
    for name, vals in fields.items():
        for v in [vals] if isinstance(vals, str) else vals:
            out.write(f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"\r\n\r\n'
                      .encode() + v.encode() + b"\r\n")
    if file is not None:
        fname, payload = file
        out.write(f'--{boundary}\r\nContent-Disposition: form-data; name="file"; '
                  f'filename="{fname}"\r\nContent-Type: application/octet-stream\r\n\r\n'
                  .encode() + payload + b"\r\n")
    out.write(f"--{boundary}--\r\n".encode())
    return out.getvalue(), f"multipart/form-data; boundary={boundary}"


# ---------------------------------------------------------------------------
# masking: ids, times, float diagnostics
# ---------------------------------------------------------------------------

UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}")
ISO = re.compile(r"\d{4}-\d{2}-\d{2}T\d{2}:\d{2}:\d{2}(\.\d+)?(\+00:00)?")
TIME_KEYS = {"created_at", "updated_at", "timestamp", "completed_at", "started_at",
             "processing_s", "rtf_x", "rtf_x_p50", "rtf_x_mean", "stage_seconds_mean",
             "audio_seconds_total", "processing_seconds_total", "queue_wait_seconds_sum",
             "slot_wait_seconds_sum"}
# the one progress message that names the JAX package's chip
CHIP = ("on TPU", "on the device")


def mask(x):
    if isinstance(x, dict):
        return {mask(k): ("<t>" if k in TIME_KEYS else mask(v)) for k, v in x.items()}
    if isinstance(x, list):
        return [mask(v) for v in x]
    if isinstance(x, float):
        return round(x, 4)
    if isinstance(x, str):
        x = ISO.sub("<t>", UUID.sub("<id>", x.replace(*CHIP)))
        # text bodies: SSE data lines and the Prometheus exposition
        x = re.sub(r'("(?:processing_s|rtf_x)": )[0-9.e+-]+', r"\1<t>", x)
        x = re.sub(r"^(aptpu_(?:rtf_x\w*|stage_seconds_mean.*?|audio_seconds_total|"
                   r"processing_seconds_total|v1_\w+_seconds_sum)) [0-9.e+-]+$", r"\1 <t>", x,
                   flags=re.M)
        return x
    return x


# ---------------------------------------------------------------------------
# the two service stacks and the script
# ---------------------------------------------------------------------------

class _Processor:
    """The /v1 surface reads only ``processor.transcriber``."""

    def __init__(self, transcriber):
        self.transcriber = transcriber


@pytest.fixture(scope="module")
def stacks():
    """(package, app, engine) for JAX and the port: the real 9-stage job
    (no diarizer, no LLM) and the /v1 surface on the same weights."""
    jt = JTranscriber.random_init("test", **ASR_KW)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jt.params), "cpu")
    cfg = WhisperConfig(**{k: getattr(jt.cfg, k) for k in WhisperConfig.__dataclass_fields__})
    pt = Transcriber(params=params, cfg=cfg, enable_fallback=False, device="cpu", **ASR_KW)
    out = []
    for name, t, mods in (("jax", jt, (jjob_engine, jmeeting, jservices, japp)),
                          ("port", pt, (job_engine, meeting, services, app_mod))):
        eng_mod, meet_mod, svc_mod, app_pkg = mods
        engine = eng_mod.JobEngine(max_workers=1)
        svc = svc_mod.Services(engine=engine,
                               processor=meet_mod.MeetingProcessor(transcriber=t, diarizer=None))
        out.append((name, app_pkg.create_app(svc, secret_key="k"), engine))
    yield out
    for _, _, engine in out:
        engine.shutdown(wait=False)


def script(app, engine, wav_path: str) -> list:
    """The request sequence; every response as (label, status, masked body)."""
    log = []

    def req(label, method, path, body=b"", **kw):
        # health and metrics are cached for 2 s: read the store every time
        engine._active_cache = engine._metrics_cache = None
        status, data, headers = call(app, method, path, body, **kw)
        log.append((label, status, mask(data), headers.get("Content-Type")))
        return status, data

    req("health", "GET", "/api/health")
    req("health unprefixed", "GET", "/health")
    for i, body in enumerate((None, {}, {"file_id": 5}, {"file_id": "x", "attachment_file_ids": "no"},
                              {"file_id": "x", "attachment_file_ids": [1]})):
        req(f"process invalid {i}", "POST", "/api/process", body)
    req("job not found", "GET", "/api/job/nope")
    req("result not found", "GET", "/api/jobs/nope/result")
    req("cancel not found", "POST", "/api/job/nope/cancel")
    engine.create_job("slow")  # never submitted: stays pending
    req("result before completion", "GET", "/api/jobs/slow/result")
    _, data = req("process", "POST", "/api/process", {"file_id": wav_path})
    job_id = data["job_id"]
    deadline = time.time() + 120
    while time.time() < deadline:
        status, data, _ = call(app, "GET", f"/api/job/{job_id}")
        if data["job"]["status"] in ("completed", "failed"):
            break
        time.sleep(0.05)
    req("poll", "GET", f"/api/job/{job_id}")
    req("poll unprefixed", "GET", f"/job/{job_id}")
    req("result", "GET", f"/api/jobs/{job_id}/result")
    req("batch", "POST", "/api/jobs/status/batch", {"job_ids": [job_id, "ghost"]})
    req("list all", "GET", "/api/jobs", query="filter=all")
    req("list active", "GET", "/jobs")
    req("list bogus", "GET", "/api/jobs", query="filter=bogus")
    req("debug", "GET", "/api/jobs/debug")
    req("events", "GET", f"/api/job/{job_id}/events")
    req("events not found", "GET", "/api/job/ghost/events")
    req("metrics", "GET", "/api/metrics")
    req("metrics prometheus", "GET", "/api/metrics", query="format=prometheus")
    req("drive files", "GET", "/api/drive/files")
    req("cancel done", "POST", f"/api/job/{job_id}/cancel")

    clip = wav_bytes(3.0)
    for fields in ({}, {"response_format": "text"}, {"response_format": "srt"},
                   {"response_format": "vtt"}, {"response_format": "verbose_json"},
                   {"response_format": "verbose_json", "timestamp_granularities[]": "segment"},
                   {"language": "en", "prompt": "Hello there.", "temperature": "0.0"},
                   {"stream": "true"}, {"stream": "true", "response_format": "srt"},
                   {"response_format": "yaml"}, {"temperature": "1.5"}, {"language": "xx"},
                   {"timestamp_granularities[]": "word"},
                   {"response_format": "verbose_json", "timestamp_granularities[]": "word"}):
        body, ct = multipart(fields, ("a.wav", clip))
        req(f"v1 {fields}", "POST", V1, body, ctype=ct)
    body, ct = multipart({"response_format": "json"}, None)
    req("v1 no file", "POST", V1, body, ctype=ct)
    body, ct = multipart({}, ("a.mp3", b"\x00\x01notaudio"))
    req("v1 undecodable", "POST", V1, body, ctype=ct)
    req("v1 not multipart", "POST", V1, b"{}")
    for fields in ({"response_format": "verbose_json"}, {"language": "de"}):
        body, ct = multipart(fields, ("a.wav", clip))
        req(f"translations {fields}", "POST", "/v1/audio/translations", body, ctype=ct)
    req("models", "GET", "/v1/models")
    req("model", "GET", "/v1/models/whisper-1")
    req("model missing", "GET", "/v1/models/gpt-4o")

    os.environ["APTPU_API_KEYS"] = "sk-j"
    try:
        for path in ("/api/jobs", "/jobs", "/api/jobs/debug", "/api/metrics", "/v1/models"):
            req(f"gated {path}", "GET", path)
            req(f"key {path}", "GET", path, headers={"Authorization": "Bearer sk-j"})
        req("gated health", "GET", "/health")
        req("bad key", "GET", "/api/jobs", headers={"Authorization": "Bearer k\xe9"})
    finally:
        del os.environ["APTPU_API_KEYS"]
    return log


@pytest.fixture(scope="module")
def logs(stacks, tmp_path_factory):
    path = tmp_path_factory.mktemp("audio") / "REC_20250617_093000.wav"
    with open(path, "wb") as f:
        f.write(wav_bytes(12.0, f0=180.0))
    # other tests' batches and waits must not show in metrics
    jopenai_api._batch_stats.update(batches=0, files=0)
    trace.reset_totals()
    return {name: script(app, engine, str(path)) for name, app, engine in stacks}


WORD = "v1 {'response_format': 'verbose_json', 'timestamp_granularities[]': 'word'}"


# /api/metrics: the port exports its rate as sums over the completed jobs
# (JAX: rtf_x_p50 / rtf_x_mean), names each stage job.<stage> by its work
# (utils/constants.py STAGES; JAX: by its progress message) and adds the /v1 waits; the rest is JAX's
METRICS = ("metrics", "metrics prometheus", "key /api/metrics")
PORT_METRICS = {"audio_seconds_total", "processing_seconds_total", "rtf_x", "v1_waits"}
JAX_METRICS = {"rtf_x_p50", "rtf_x_mean"}
_METRIC_LINE = re.compile(r"^(# (HELP|TYPE) )?aptpu_(rtf_x|audio_seconds|processing_seconds|"
                          r"v1_(queue|slot)_wait|v1_decode_slots|stage_seconds_mean\{)")
JOB_STAGES = ["job." + k for k in ("metadata", "attachments", "download", "decode_audio",
                                   "transcribe", "speakers", "transcript", "summary", "notion",
                                   "rename")]


def _shared_metrics(entry, drop):
    """A metrics response less what only one package exports."""
    label, status, body, ctype = entry
    if isinstance(body, dict):
        m = {k: v for k, v in body["metrics"].items() if k not in drop}
        return label, status, dict(body, metrics=m), ctype
    lines = [ln for ln in body.splitlines() if not _METRIC_LINE.match(ln)]
    return label, status, "\n".join(lines), ctype


def _check_port_metrics(entry, ref) -> None:
    label, _, body, _ = entry
    if isinstance(body, dict):
        m = body["metrics"]
        assert PORT_METRICS <= set(m) and not JAX_METRICS & set(m), label
        assert set(m["v1_waits"]) == {"queue_wait_seconds_sum", "queue_wait_count",
                                      "slot_wait_seconds_sum", "slot_wait_count",
                                      "decode_slots_in_use"}, label
        return
    stages = re.findall(r'^aptpu_stage_seconds_mean\{stage="([^"]+)"\}', body, re.M)
    assert sorted(stages) == sorted(JOB_STAGES), label
    assert len(stages) == len(re.findall(r"^aptpu_stage_seconds_mean\{", ref[2], re.M))
    for name in ("aptpu_audio_seconds_total <t>", "aptpu_processing_seconds_total <t>",
                 "aptpu_v1_queue_wait_seconds_count", "aptpu_v1_slot_wait_seconds_sum <t>",
                 "aptpu_v1_decode_slots_in_use 0"):
        assert name in body, (label, name)
    assert "aptpu_rtf_x_p50" not in body and "aptpu_rtf_x " in body, label


def test_script_equals_jax(logs):
    jlog, log = logs["jax"], logs["port"]
    assert [e[0] for e in log] == [e[0] for e in jlog]
    for ours, ref in zip(log, jlog):
        if ours[0] in METRICS:
            _check_port_metrics(ours, ref)
            ours, ref = _shared_metrics(ours, PORT_METRICS), _shared_metrics(ref, JAX_METRICS)
        assert ours == ref, ours[0]
    by_label = dict((e[0], e) for e in log)
    # the script reached what it meant to: a completed job with segments,
    # and /v1 text
    poll = by_label["poll"][2]["job"]
    assert poll["status"] == "completed" and poll["result"]["segments"]
    assert by_label["v1 {}"][1] == 200 and by_label["v1 {}"][2]["text"]
    assert by_label["gated /api/jobs"][1] == 401 and by_label["key /api/jobs"][1] == 200


def test_word_granularity_equals_jax(logs):
    """Once a 400 naming the option (the port had no word timestamps);
    now both requests for word granularity answer 200 with JAX's words."""
    jlog, log = dict((e[0], e) for e in logs["jax"]), dict((e[0], e) for e in logs["port"])
    for label in (WORD, "v1 {'timestamp_granularities[]': 'word'}"):
        assert log[label] == jlog[label], label
    status, data = log[WORD][1:3]
    assert status == 200 and data["words"]
    assert {"word", "start", "end"} <= set(data["words"][0])


# ---------------------------------------------------------------------------
# /v1: the dynamic batcher and the slots, on the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def v1_app(stacks):
    t = next(a for n, a, _ in stacks if n == "port").config["services"].processor.transcriber
    engine = JobEngine(max_workers=1)
    app = App(secret_key="k")
    app.register_blueprint(openai_api.make_openai_blueprint(
        services.Services(engine=engine, processor=_Processor(t))))
    yield app, t
    engine.shutdown(wait=False)


def _concurrent(app, bodies):
    results = {}

    def go(i):
        body, ct = bodies[i]
        results[i] = call(app, "POST", V1, body, ctype=ct)

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(bodies))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return [results[i] for i in range(len(bodies))]


def test_dynamic_batching_coalesces_and_each_text_is_its_own(v1_app, monkeypatch):
    """Concurrent uploads with one option set decode in ONE
    transcribe_batch call, and each gets the text of its own transcribe."""
    app, t = v1_app
    monkeypatch.setenv("APTPU_DYNAMIC_BATCH_WAIT_MS", "1000")
    calls: list[int] = []
    orig = Transcriber.transcribe_batch

    def spy(self, audios, **kw):
        calls.append(len(audios))
        return orig(self, audios, **kw)

    monkeypatch.setattr(Transcriber, "transcribe_batch", spy)
    clips = [wav_bytes(2.0, 220.0), wav_bytes(3.0, 410.0)]
    results = _concurrent(app, [multipart({}, ("a.wav", c)) for c in clips])
    assert calls == [2]
    for (status, data, _), clip in zip(results, clips):
        assert status == 200
        monkeypatch.delenv("APTPU_DYNAMIC_BATCH_WAIT_MS")
        body, ct = multipart({}, ("a.wav", clip))
        assert call(app, "POST", V1, body, ctype=ct)[1]["text"] == data["text"]
        monkeypatch.setenv("APTPU_DYNAMIC_BATCH_WAIT_MS", "1000")


def test_dynamic_batching_keeps_option_sets_apart(v1_app, monkeypatch):
    app, _ = v1_app
    monkeypatch.setenv("APTPU_DYNAMIC_BATCH_WAIT_MS", "300")
    calls: list[int] = []
    orig = Transcriber.transcribe_batch

    def spy(self, audios, **kw):
        calls.append(len(audios))
        return orig(self, audios, **kw)

    monkeypatch.setattr(Transcriber, "transcribe_batch", spy)
    clip = wav_bytes(1.0)
    results = _concurrent(app, [multipart({}, ("a.wav", clip)),
                                multipart({"temperature": "0.4"}, ("b.wav", clip))])
    assert [r[0] for r in results] == [200, 200] and sorted(calls) == [1, 1]


def test_decode_and_stream_slots(v1_app, monkeypatch):
    app, _ = v1_app
    body, ct = multipart({}, ("a.wav", wav_bytes(1.0)))
    monkeypatch.setenv("APTPU_MAX_CONCURRENT_DECODES", "0")
    monkeypatch.setenv("APTPU_DECODE_QUEUE_TIMEOUT_S", "0.1")
    status, data, _ = call(app, "POST", V1, body, ctype=ct)
    assert status == 503 and "concurrent" in data["error"]["message"]
    monkeypatch.setenv("APTPU_MAX_TRANSCRIBE_STREAMS", "0")
    body, ct = multipart({"stream": "true"}, ("a.wav", wav_bytes(1.0)))
    status, data, _ = call(app, "POST", V1, body, ctype=ct)
    assert status == 503 and data["error"]["type"] == "server_error"


# ---------------------------------------------------------------------------
# job stores, engine, cancel, redis: the cases of tests/test_runtime_server.py
# ---------------------------------------------------------------------------

def _redis_store():
    return RedisJobStore(client=FakeRedis())


@pytest.mark.parametrize("backend", ["memory", "sqlite", "redis"])
def test_job_store_crud(backend, tmp_path):
    store = {"memory": MemoryJobStore, "redis": _redis_store,
             "sqlite": lambda: SqliteJobStore(str(tmp_path / "jobs.db"))}[backend]()
    store.create("j1", {"id": "j1", "status": "pending", "progress": 0})
    assert store.get("j1")["status"] == "pending"
    store.update("j1", status="processing", progress=50)
    assert store.get("j1")["progress"] == 50
    assert len(store.list()) == 1
    assert not store.is_cancel_requested("j1")
    store.request_cancel("j1")
    assert store.is_cancel_requested("j1")
    store.clear_cancel("j1")
    assert not store.is_cancel_requested("j1")
    store.delete("j1")
    assert store.get("j1") is None and store.list() == []


def test_sqlite_store_cross_instance_and_process(tmp_path):
    import subprocess
    import sys

    path = str(tmp_path / "jobs.db")
    a, b = SqliteJobStore(path), SqliteJobStore(path)
    a.create("j1", {"id": "j1", "status": "pending"})
    assert b.get("j1")["status"] == "pending"
    b.update("j1", status="completed")
    assert a.get("j1")["status"] == "completed"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (f"import sys; sys.path.insert(0, {repo!r});"
            "from audio_processor_tpu_torch.runtime.job_store import SqliteJobStore;"
            f"s = SqliteJobStore({path!r});"
            "s.create('xp', {'id': 'xp', 'status': 'pending', 'progress': 0});"
            "s.request_cancel('xp')")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=60)
    rec = a.get("xp")
    assert rec and rec["status"] == "pending" and a.is_cancel_requested("xp")


def test_make_store_urls(tmp_path):
    assert isinstance(make_store(None), MemoryJobStore)
    assert isinstance(make_store("memory://"), MemoryJobStore)
    assert isinstance(make_store(f"sqlite:///{tmp_path}/x.db"), SqliteJobStore)


def test_redis_store_ordered_listing_and_watch_retry():
    store = _redis_store()
    for i in range(5):
        store.create(f"j{i}", {"id": f"j{i}", "status": "pending", "progress": 0})
    assert [r["id"] for r in store.list()] == [f"j{i}" for i in range(5)]
    # a concurrent write between WATCH and EXEC retries, it loses nothing
    r = store.client
    pipe_cls = type(r.pipeline())
    orig_multi, conflicted = pipe_cls.multi, []

    def sneaky_multi(self):
        if not conflicted:
            conflicted.append(1)
            rec = json.loads(r.get("aptpu:job:j1"))
            rec["progress"] = 77
            r.set("aptpu:job:j1", json.dumps(rec))
        return orig_multi(self)

    pipe_cls.multi = sneaky_multi
    try:
        store.update("j1", status="processing")
    finally:
        pipe_cls.multi = orig_multi
    assert store.get("j1")["status"] == "processing" and store.get("j1")["progress"] == 77


def _wait_status(engine, job_id, statuses, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        st = engine.get_job_status(job_id)
        if st and st["status"] in statuses:
            return st
        time.sleep(0.02)
    raise TimeoutError(f"job {job_id} never reached {statuses}")


@pytest.mark.parametrize("store", ["memory", "redis"])
def test_job_success_failure_and_listing(store):
    engine = (JobEngine(max_workers=2) if store == "memory"
              else JobEngine(max_workers=2, store=_redis_store()))
    try:
        engine.create_job("ok", file_id="f1")
        engine.create_job("bad")
        engine.submit("ok", lambda ctx: ctx.stage(30, "working") or {"success": True, "answer": 42})

        def bad(ctx):
            ctx.partial["title"] = "salvaged"
            raise RuntimeError("boom")

        engine.submit("bad", bad,
                      failure_result=lambda exc, p: {"success": False, "title": p["title"]})
        st = _wait_status(engine, "ok", ["completed"])
        assert st["progress"] == 100 and st["result"]["answer"] == 42 and st["file_id"] == "f1"
        st = _wait_status(engine, "bad", ["failed"])
        assert "boom" in st["error"] and st["partial_result"]["title"] == "salvaged"
        assert engine.store.get("bad")["result"]["title"] == "salvaged"
        assert {j["id"] for j in engine.list_jobs("completed")} == {"ok"}
        assert {j["id"] for j in engine.list_jobs("failed")} == {"bad"}
        assert len(engine.list_jobs("all")) == 2 and engine.active_count() == 0
        assert engine.store.get("ok")["stage_timings"].keys() == {"job.transcribe"}
    finally:
        engine.shutdown(wait=False)


def test_job_cancellation_mid_flight_and_missing():
    engine = JobEngine(max_workers=2)
    try:
        engine.create_job("j3")
        started = threading.Event()

        def work(ctx):
            started.set()
            for _ in range(200):
                ctx.check_cancelled()
                time.sleep(0.02)
            return {}

        engine.submit("j3", work)
        started.wait(5)
        assert engine.cancel_job("j3")["success"]
        assert _wait_status(engine, "j3", ["cancelled"])["status"] == "cancelled"
        assert not engine.cancel_job("j3")["success"]
        assert engine.cancel_job("ghost")["success"] is False
        assert issubclass(JobCancelled, BaseException)
    finally:
        engine.shutdown(wait=False)


def test_concurrent_submit_cancel_stress(tmp_path):
    import random

    engine = JobEngine(max_workers=4, store_url=f"sqlite://{tmp_path}/stress.db")
    try:
        n = 24
        for i in range(n):
            engine.create_job(f"s{i}")

        def work(ctx):
            for _ in range(20):
                ctx.check_cancelled()
                time.sleep(0.005)
            return {"ok": True}

        def canceller(i):
            time.sleep(random.random() * 0.05)
            engine.cancel_job(f"s{i}")

        threads = []
        for i in range(n):
            threads.append(threading.Thread(target=engine.submit, args=(f"s{i}", work)))
            if i % 3 == 0:
                threads.append(threading.Thread(target=canceller, args=(i,)))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        deadline = time.time() + 30
        while time.time() < deadline:
            statuses = [engine.get_job_status(f"s{i}")["status"] for i in range(n)]
            if all(s in ("completed", "cancelled", "failed") for s in statuses):
                break
            time.sleep(0.05)
        assert all(s in ("completed", "cancelled") for s in statuses), statuses
        for i in range(n):
            st = engine.get_job_status(f"s{i}")
            if st["status"] == "completed":
                assert st["result"] == {"ok": True}
    finally:
        engine.shutdown(wait=False)


def test_prune_old_jobs_and_metrics_cache(tmp_path):
    engine = JobEngine(max_workers=1, store_url=f"sqlite://{tmp_path}/p.db")
    try:
        engine.create_job("old")
        engine.create_job("new")
        engine.store.update("old", status="completed", updated_at="2020-01-01T00:00:00+00:00")
        engine.store.update("new", status="completed")
        assert engine.prune_old_jobs(30) == 1
        assert engine.store.get("old") is None and engine.store.get("new") is not None
        engine.create_job("pending-old")
        engine.store.update("pending-old", updated_at="2020-01-01T00:00:00+00:00")
        assert engine.prune_old_jobs(30) == 0  # active jobs are never pruned
        m1, m2 = engine.metrics(), engine.metrics()
        assert m1 == m2 and m1 is not m2
        m1["jobs_by_status"]["injected"] = 99
        assert "injected" not in engine.metrics()["jobs_by_status"]
    finally:
        engine.shutdown(wait=False)


def test_saturated_pool_marks_jobs_queued():
    engine = JobEngine(max_workers=1)
    release = threading.Event()
    try:
        engine.create_job("busy")
        engine.submit("busy", lambda ctx: release.wait(10) or {"ok": True})
        time.sleep(0.1)
        engine.create_job("waiting")
        engine.submit("waiting", lambda ctx: {"ok": True})
        assert engine.get_job_status("waiting")["status"] == "queued"
        assert any(j["id"] == "waiting" for j in engine.list_jobs("active"))
        assert engine.cancel_job("waiting")["success"]
        assert _wait_status(engine, "waiting", ["cancelled"], 5)["status"] == "cancelled"
    finally:
        release.set()
        engine.shutdown(wait=True)


def test_orphan_recovery_on_a_persistent_store(tmp_path):
    """A job a dead process left in flight is finalised as failed by the
    next engine on the same store."""
    url = f"sqlite://{tmp_path}/o.db"
    store = make_store(url)
    store.create("orphan", {"id": "orphan", "status": "processing", "progress": 40,
                            "created_at": "2020-01-01T00:00:00+00:00",
                            "updated_at": "2020-01-01T00:00:00+00:00"})
    engine = JobEngine(max_workers=1, store_url=url)
    try:
        engine.recover_orphans()
        assert engine.get_job_status("orphan")["status"] == "failed"
    finally:
        engine.shutdown(wait=False)


def test_sse_subscriber_cap(monkeypatch):
    monkeypatch.setenv("APTPU_SSE_MAX_SUBSCRIBERS", "0")
    engine = JobEngine(max_workers=1)
    try:
        app = App(secret_key="k")
        app.register_blueprint(api_mod.make_api_blueprint(
            services.Services(engine=engine, processor=_Processor(None))))
        engine.create_job("capped")
        status, data, _ = call(app, "GET", "/api/job/capped/events")
        assert status == 503 and "polling" in data["error"]
    finally:
        engine.shutdown(wait=False)


def test_webui_is_served_from_the_jax_package_data():
    """The port serves the JAX package's web UI from its own byte-equal
    copy, which lies inside the port (test_torch_isolation.py holds
    every file of the copy to the JAX package's)."""
    engine = JobEngine(max_workers=1)
    try:
        app = app_mod.create_app(services.Services(engine=engine, processor=_Processor(None)),
                                 secret_key="k")
        status, body, headers = call(app, "GET", "/")
        assert status == 200 and "<html" in body.lower()
        status, body, _ = call(app, "GET", "/static/js/app.js")
        jax_webui = japp.TEMPLATE_DIR.rsplit(os.sep, 1)[0]
        with open(os.path.join(jax_webui, "static", "js", "app.js"), encoding="utf-8") as f:
            assert status == 200 and body == f.read()
        port = os.path.dirname(os.path.abspath(app_mod.__file__)).rsplit(os.sep, 1)[0]
        assert os.path.commonpath([app_mod.WEBUI_DIR, port]) == port
        assert app_mod.WEBUI_DIR == os.path.join(port, "webui")
        assert not os.path.samefile(app_mod.WEBUI_DIR, jax_webui)
    finally:
        engine.shutdown(wait=False)


def test_kernel_libraries_build_and_open_once_across_threads(monkeypatch, tmp_path):
    """Job workers and /v1 threads may reach a kernel's first launch
    together: the library is built and opened once."""
    import ctypes

    from audio_processor_tpu_torch.ops.kernels import build

    builds, opened = [], []

    def fake_build(names, ptxas_report=False):
        builds.append(tuple(names))
        time.sleep(0.05)  # widen the race window
        return {}

    class FakeLib:
        def __init__(self, path):
            opened.append(path)

    monkeypatch.setattr(build, "build", fake_build)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "library_path", lambda name: tmp_path / f"lib{name}.so")
    monkeypatch.setattr(ctypes, "CDLL", FakeLib)
    barrier = threading.Barrier(8)
    libs = []

    def first_launch():
        barrier.wait()
        libs.append(build.load("cross_attn_int4"))

    threads = [threading.Thread(target=first_launch) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert builds == [("cross_attn_int4",)] and len(opened) == 1
    assert len(libs) == 8 and all(lib is libs[0] for lib in libs)


@pytest.mark.parametrize("delay_s", [0.0, 0.2])
def test_shutdown_right_after_run_starts_stops_the_loop(delay_s):
    """``shutdown()`` as soon as ``run()`` is started on a thread (0 s: before
    the loop exists, which left it serving forever; 0.2 s: once it serves):
    the thread ends and the port is free again."""
    import socket

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    app = App()
    th = threading.Thread(target=app.run, kwargs=dict(host="127.0.0.1", port=port, max_threads=2),
                          daemon=True)
    th.start()
    time.sleep(delay_s)
    app.shutdown()
    th.join(5)
    assert not th.is_alive()
    with socket.socket() as again:
        again.bind(("127.0.0.1", port))
