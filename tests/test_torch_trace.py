"""The port's tracer (``runtime/trace.py``) and its users, on the CPU.

Spans nest and their self time is their duration less their children's;
requests stay apart across threads; counters add; an idle span allocates
nothing; under a profiler the spans land in its events.  Then the users:
a Transcriber's ``result["trace"]`` counts the decode steps its decodes
ran, the job's stage timings are its ``job.<stage>`` spans with the
Transcriber's spans under them, and ``/api/metrics`` exports the rate as
sums and the ``/v1`` waits, in JSON and in Prometheus form.
"""
import io
import json
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

from audio_processor_tpu_torch.models.whisper import decode
from audio_processor_tpu_torch.pipeline import meeting
from audio_processor_tpu_torch.pipeline.transcribe import Transcriber
from audio_processor_tpu_torch.runtime import services, trace
from audio_processor_tpu_torch.runtime.job_engine import JobEngine
from audio_processor_tpu_torch.server import app as app_mod
from audio_processor_tpu_torch.utils import wavio
from audio_processor_tpu_torch.utils.constants import PROGRESS

SR = 16_000


@pytest.fixture
def clock(monkeypatch):
    """The tracer's clock, moved by hand: ``clock[0] += ns``."""
    now = [0]
    monkeypatch.setattr(trace, "perf_counter_ns", lambda: now[0])
    return now


def _ns(summary: dict) -> dict:
    """name -> (total ns, self ns, count) of a summary's spans."""
    return {name: (round(s["total_s"] * 1e9), round(s["self_s"] * 1e9), s["count"])
            for name, s in summary["spans"].items()}


def test_spans_nest_and_self_time_is_duration_less_children(clock):
    with trace.request("r1") as rec:
        with trace.span("outer"):
            clock[0] += 10
            with trace.span("inner"):
                clock[0] += 20
                with trace.span("leaf"):
                    clock[0] += 5
            with trace.span("inner"):
                clock[0] += 10
        clock[0] += 3  # outside every span: no span's time
    s = rec.summary()
    assert s["request_id"] == "r1"
    assert _ns(s) == {"leaf": (5, 5, 1), "inner": (35, 30, 2), "outer": (45, 10, 1)}
    assert list(s["spans"]) == ["leaf", "inner", "outer"]  # in the order they first closed


def test_a_span_closed_out_of_order_hands_its_time_to_the_one_below(clock):
    """A stage span closed by hand while a span opened inside it is still
    open: each still counts its own time, and none is left open."""
    with trace.request() as rec:
        with trace.span("job"):
            stage = trace.span("job.transcribe")
            stage.__enter__()
            clock[0] += 4
            with trace.span("late"):
                clock[0] += 6
                stage.__exit__(None, None, None)
                clock[0] += 2
            clock[0] += 1
    totals = {name: (t, n) for name, (t, _, n) in _ns(rec.summary()).items()}
    assert totals == {"job.transcribe": (10, 1), "late": (8, 1), "job": (13, 1)}
    assert rec._open == [] and rec._root_ns == 13


def test_counters_add_and_need_an_open_request():
    trace.count("nobody.hears")  # no request: nothing to count into
    with trace.request() as rec:
        trace.count("decode.steps")
        trace.count("decode.steps", 4)
        trace.count("transcribe.windows", 60)
    assert rec.summary()["counters"] == {"decode.steps": 5, "transcribe.windows": 60}
    assert rec.summary()["request_id"] is None


def test_a_nested_request_hands_its_spans_to_the_enclosing_one(clock):
    with trace.request("job") as outer:
        with trace.span("job.transcribe"):
            clock[0] += 1
            with trace.request() as inner:
                with trace.span("transcribe"):
                    trace.count("decode.steps", 3)
                    clock[0] += 2
                    with trace.span("decode.step"):
                        clock[0] += 7
            with trace.span("diarize.crop_gather"):
                clock[0] += 4
    assert inner.summary() == {"request_id": "job",  # the enclosing request's id
                               "spans": {"decode.step": {"total_s": 7e-9, "self_s": 7e-9,
                                                         "count": 1},
                                         "transcribe": {"total_s": 9e-9, "self_s": 2e-9,
                                                        "count": 1}},
                               "counters": {"decode.steps": 3}}
    assert _ns(outer.summary()) == {"decode.step": (7, 7, 1), "transcribe": (9, 2, 1),
                                    "diarize.crop_gather": (4, 4, 1),
                                    "job.transcribe": (14, 1, 1)}
    assert outer.summary()["counters"] == {"decode.steps": 3}


def test_two_threads_keep_their_requests_apart():
    records, ready = {}, threading.Barrier(2)

    def work(name, n):
        with trace.request(name) as rec:
            ready.wait()
            for _ in range(n):
                with trace.span(f"{name}.step"):
                    trace.count(f"{name}.steps")
                    time.sleep(0.001)
        records[name] = rec

    threads = [threading.Thread(target=work, args=(n, k)) for n, k in (("a", 7), ("b", 11))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert trace.current() is None
    for name, n in (("a", 7), ("b", 11)):
        s = records[name].summary()
        assert list(s["spans"]) == [f"{name}.step"] and s["spans"][f"{name}.step"]["count"] == n
        assert s["counters"] == {f"{name}.steps": n}


def test_outermost_requests_add_to_the_process_totals():
    """Of the ``v1.*`` names alone, which the server exports."""
    trace.reset_totals()
    for _ in range(3):
        with trace.request():
            with trace.span("v1.slot_wait"):
                with trace.span("transcribe"):
                    trace.count("decode.steps")
            trace.count("v1.batches")
    with trace.request():
        with trace.request():  # nested: counted once, through the outer one
            with trace.span("v1.slot_wait"):
                pass
    tot = trace.totals()
    assert tot["spans"]["v1.slot_wait"]["count"] == 4
    assert tot["spans"]["v1.slot_wait"]["total_s"] >= 0
    assert tot["counters"] == {"v1.batches": 3}
    trace.reset_totals()
    assert trace.totals() == {"spans": {}, "counters": {}}


def test_totals_lose_nothing_under_many_threads():
    """Requests closing at once on more threads than cores: the process's
    totals hold every span and count (a lost update would break them)."""
    import os
    import sys

    trace.reset_totals()
    n_threads, per = 4 * (os.cpu_count() or 1) + 4, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                with trace.request():
                    with trace.span("v1.batch_wait"):
                        trace.count("v1.files", 2)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    tot = trace.totals()
    assert tot["spans"]["v1.batch_wait"]["count"] == n_threads * per
    assert tot["counters"]["v1.files"] == 2 * n_threads * per
    trace.reset_totals()


def test_an_idle_span_allocates_nothing():
    """No request open and no profiler: span() hands back one shared idle
    object and count() returns at once, so 20,000 spans hold no memory and
    raise the peak no more than the bare loop around them does."""
    assert trace.current() is None
    assert trace.span("a") is trace.span("b")

    def spans(n):
        for _ in range(n):
            with trace.span("decode.step"):
                trace.count("decode.steps")
                with trace.span("decode.wait"):
                    pass

    def bare(n):
        for _ in range(n):
            pass

    def peak(fn, n):
        tracemalloc.reset_peak()
        before = tracemalloc.get_traced_memory()[0]
        fn(n)
        current, top = tracemalloc.get_traced_memory()
        assert current == before, fn.__name__
        return top - before

    spans(100)  # warm
    tracemalloc.start()
    try:
        grows = peak(spans, 20_000) - peak(spans, 10)
        loop_grows = peak(bare, 20_000) - peak(bare, 10)
    finally:
        tracemalloc.stop()
    assert grows <= loop_grows


def test_spans_land_in_a_running_profile():
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("outside.any_request"):  # the timeline needs no request
            x @ x
        with trace.request() as rec:
            with trace.span("transcribe.encode"):
                x @ x
    names = {e.name for e in prof.events()}
    assert {"outside.any_request", "transcribe.encode"} <= names
    assert set(rec.summary()["spans"]) == {"transcribe.encode"}


# ---------------------------------------------------------------------------
# the Transcriber
# ---------------------------------------------------------------------------

def _audio(seconds: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    x = 0.3 * np.sin(2 * np.pi * 220 * t) * (np.sin(2 * np.pi * 0.7 * t) > -0.2)
    return (x + rng.normal(0, 0.01, t.size)).astype(np.float32)


def _steps_run(results, every: int) -> int:
    """What a decode loop runs: until a read of the finished flags (one
    every ``every`` steps) finds every row has emitted EOT, or to the cap."""
    return sum(min(cap, -(-(int(r.lengths.max()) + 1) // every) * every) for r, cap in results)


@pytest.mark.parametrize("kw", [dict(max_new_tokens=12),
                                dict(max_new_tokens=6, beam_size=2, patience=1.0)],
                         ids=["greedy", "beam"])
def test_transcriber_trace_counts_the_decode_steps(kw):
    tr = Transcriber.random_init("test", device="cpu", compute_dtype="float32", **kw)
    decodes = []
    run_decode = tr._run_decode

    def spy(*a, **k):
        res = run_decode(*a, **k)
        decodes.append((res, tr.max_new_tokens))
        return res

    tr._run_decode = spy
    out = tr.transcribe(_audio(65.0))
    t = out["trace"]
    spans, counters = t["spans"], t["counters"]
    steps = counters["decode.steps"]
    every = 1 if "beam_size" in kw else decode.READBACK_EVERY  # beam search reads each step
    assert steps == spans["decode.step"]["count"] == _steps_run(decodes, every) > 0
    assert counters["transcribe.windows"] == 3 and counters["decode.rows"] == 4
    assert spans["decode.wait"]["count"] <= steps
    assert spans["decode.wait"]["total_s"] <= spans["decode.step"]["total_s"]
    assert spans["decode.prefill"]["count"] == len(decodes)
    for name in ("transcribe", "transcribe.ingest", "transcribe.trim", "transcribe.slab_cut",
                 "transcribe.encode", "transcribe.decode", "transcribe.collect",
                 "transcribe.seek_repair", "transcribe.segments"):
        assert spans[name]["count"] >= 1, name
    root = spans["transcribe"]
    assert root["total_s"] >= sum(s["total_s"] for n, s in spans.items()
                                  if n.count(".") == 1 and n.startswith("transcribe."))
    assert 0 <= root["self_s"] < root["total_s"]
    json.dumps(t)


def test_transcribe_batch_results_carry_the_batch_trace():
    tr = Transcriber.random_init("test", device="cpu", compute_dtype="float32",
                                 max_new_tokens=6)
    outs = tr.transcribe_batch([_audio(20.0, 1), _audio(40.0, 2)])
    assert outs[0]["trace"] == outs[1]["trace"]
    c = outs[0]["trace"]["counters"]
    assert c["transcribe.windows"] == 3 and c["decode.steps"] >= 1
    assert outs[0]["trace"]["spans"]["transcribe.ingest"]["count"] == 2


# ---------------------------------------------------------------------------
# the job and /api/metrics
# ---------------------------------------------------------------------------

def test_job_stage_timings_are_its_stage_spans():
    tr = Transcriber.random_init("test", device="cpu", compute_dtype="float32",
                                 max_new_tokens=4)
    engine = JobEngine(max_workers=1)
    seen = {}

    def fn(ctx):
        ctx.stage(PROGRESS["start"], "Fetching file metadata...")
        ctx.stage(PROGRESS["convert"], "Transcribing on the device...")
        tr.transcribe(_audio(5.0), remove_silence=False)
        ctx.stage(PROGRESS["summary"], "Generating summary...")
        ctx.stage(77, "a stage with no PROGRESS key")
        seen["record"] = trace.current()
        return {"success": True}

    try:
        engine.create_job("j")
        engine.submit("j", fn)
        deadline = time.time() + 60
        while engine.get_job_status("j")["status"] != "completed":
            assert time.time() < deadline
            time.sleep(0.02)
        timings = engine.store.get("j")["stage_timings"]
    finally:
        engine.shutdown(wait=True)
    assert list(timings) == ["job.metadata", "job.transcribe", "job.summary",
                             "job.progress_77"]
    assert all(v >= 0 for v in timings.values())
    s = seen["record"].summary()
    assert s["request_id"] == "j"
    spans = {name: _ns({"spans": {name: v}})[name] for name, v in s["spans"].items()}
    # the Transcriber's root span lies under its stage, and the stages under the job
    assert spans["job.transcribe"][1] == spans["job.transcribe"][0] - spans["transcribe"][0]
    stages = sum(v[0] for k, v in spans.items() if k.startswith("job."))
    assert spans["job"][1] == spans["job"][0] - stages
    assert s["counters"]["transcribe.windows"] == 1


def _call(app, path, query="", method="GET", body=b"", ctype="application/json"):
    environ = {"REQUEST_METHOD": method, "PATH_INFO": path, "QUERY_STRING": query,
               "CONTENT_LENGTH": str(len(body)), "CONTENT_TYPE": ctype,
               "wsgi.input": io.BytesIO(body)}
    got = {}

    def start_response(status, headers):
        got["status"] = int(status.split()[0])

    payload = b"".join(app(environ, start_response))
    return got["status"], payload.decode()


def _upload(path, seconds: float, f0: float) -> tuple[bytes, str]:
    """A multipart /v1 body holding a WAV tone."""
    t = np.arange(int(seconds * SR)) / SR
    wavio.write_wav(str(path), (0.3 * np.sin(2 * np.pi * f0 * t)).astype(np.float32), SR)
    b = "tb42"
    body = (f'--{b}\r\nContent-Disposition: form-data; name="file"; filename="a.wav"\r\n'
            "Content-Type: application/octet-stream\r\n\r\n").encode() + path.read_bytes()
    return body + f"\r\n--{b}--\r\n".encode(), f"multipart/form-data; boundary={b}"


def test_api_metrics_export_rate_sums_and_v1_waits(monkeypatch, tmp_path):
    tr = Transcriber.random_init("test", device="cpu", compute_dtype="float32",
                                 max_new_tokens=4)
    engine = JobEngine(max_workers=1)
    svc = services.Services(engine=engine,
                            processor=meeting.MeetingProcessor(transcriber=tr, diarizer=None))
    app = app_mod.create_app(svc, secret_key="k")
    try:
        for i, (audio_s, proc_s) in enumerate(((60.0, 10.0), (30.0, 20.0))):
            engine.store.create(f"done{i}", {
                "id": f"done{i}", "status": "completed", "progress": 100,
                "result": {"duration_s": audio_s, "processing_s": proc_s, "rtf_x": 1.0},
                "stage_timings": {"job.metadata": 0.5, "job.transcribe": 4.0 + i}})
        engine.store.create("failed", {"id": "failed", "status": "failed",
                                       "result": {"duration_s": 99.0, "processing_s": 1.0}})
        trace.reset_totals()
        monkeypatch.setenv("APTPU_DYNAMIC_BATCH_WAIT_MS", "300")
        answers = []
        uploads = [_upload(tmp_path / f"{i}.wav", 1.0, f) for i, f in enumerate((220.0, 330.0))]
        threads = [threading.Thread(target=lambda u=u: answers.append(_call(
            app, "/v1/audio/transcriptions", method="POST", body=u[0], ctype=u[1])))
            for u in uploads]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert [a[0] for a in answers] == [200, 200]
        engine._metrics_cache = None
        status, body = _call(app, "/api/metrics")
        m = json.loads(body)["metrics"]
        status_p, prom = _call(app, "/api/metrics", query="format=prometheus")
    finally:
        engine.shutdown(wait=False)
    assert status == status_p == 200
    assert not {"rtf_x_p50", "rtf_x_mean"} & set(m)
    assert m["audio_seconds_total"] == 90.0 and m["processing_seconds_total"] == 30.0
    assert m["rtf_x"] == 3.0
    assert m["stage_seconds_mean"] == {"job.metadata": 0.5, "job.transcribe": 4.5}
    w = m["v1_waits"]
    assert w["queue_wait_count"] == 2 and w["queue_wait_seconds_sum"] > 0
    assert w["slot_wait_count"] == 1 and w["decode_slots_in_use"] == 0
    assert m["v1_dynamic_batching"] == {"batches": 1, "files": 2, "mean_files_per_batch": 2.0}
    lines = set(prom.splitlines())
    assert "aptpu_rtf_x_p50" not in prom and "aptpu_rtf_x_mean" not in prom
    for line in ("aptpu_audio_seconds_total 90.0", "aptpu_processing_seconds_total 30.0",
                 "aptpu_rtf_x 3.0", "aptpu_v1_queue_wait_seconds_count 2",
                 f"aptpu_v1_queue_wait_seconds_sum {w['queue_wait_seconds_sum']}",
                 "aptpu_v1_slot_wait_seconds_count 1", "aptpu_v1_decode_slots_in_use 0",
                 "aptpu_v1_dynamic_batches_total 1", "aptpu_v1_dynamic_batch_files_total 2",
                 'aptpu_stage_seconds_mean{stage="job.transcribe"} 4.5',
                 "# TYPE aptpu_v1_slot_wait_seconds summary"):
        assert line in lines, line
