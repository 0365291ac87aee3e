"""The port's 9-stage meeting job against the JAX package's, on the CPU.

Both packages run their ``MeetingProcessor`` on the same WAV (the JAX
suite's held-out 20 s, 3-speaker meeting, ``tests/test_torch_diarize.py``),
with the JAX weights carried across (``convert.params_from_jax``), the
bundled diarizer, every net in float32 (the ``f32`` fixture patches the
JAX embedding default and re-jits its ``embed_crops`` inside the test;
nothing in the JAX package changes) and identical fake Gemini and Notion
transports.  The result dicts must be equal apart from the two timings
(``processing_s``, ``rtf_x``), and so must the Gemini prompts, the Notion
requests and their payloads, and the sequence of progress values.  The
JAX suite's own cases (``tests/test_meeting_pipeline.py``) then run
against the port, and ``cli process`` is held to the JAX CLI's output.
"""
import functools
import io
import json
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from audio_processor_tpu import cli as jcli
from audio_processor_tpu.integrations.gemini import GeminiClient as JGeminiClient
from audio_processor_tpu.integrations.notion import NotionClient as JNotionClient
from audio_processor_tpu.models.diarization import embedding as jemb
from audio_processor_tpu.models.whisper import convert as jconvert
from audio_processor_tpu.pipeline import meeting as jmeeting
from audio_processor_tpu.pipeline.diarize import Diarizer as JDiarizer
from audio_processor_tpu.pipeline.transcribe import Transcriber as JTranscriber
from audio_processor_tpu.runtime.job_engine import JobEngine as JJobEngine
from audio_processor_tpu_torch import cli
from audio_processor_tpu_torch.integrations.gemini import GeminiClient
from audio_processor_tpu_torch.integrations.notion import NotionClient
from audio_processor_tpu_torch.models.diarization import embedding as emb
from audio_processor_tpu_torch.models.whisper import convert
from audio_processor_tpu_torch.models.whisper.config import WhisperConfig
from audio_processor_tpu_torch.pipeline import meeting
from audio_processor_tpu_torch.pipeline.diarize import Diarizer
from audio_processor_tpu_torch.pipeline.meeting import MeetingProcessor, build_failure_result
from audio_processor_tpu_torch.pipeline.transcribe import Transcriber
from audio_processor_tpu_torch.runtime.device import set_full_fp32
from audio_processor_tpu_torch.runtime.job_engine import JobEngine
from audio_processor_tpu_torch.utils import wavio
from test_torch_diarize import make_meeting
from test_torch_parallel import LetterTokenizer

set_full_fp32()

TIMINGS = ("processing_s", "rtf_x")
ASR_KW = dict(compute_dtype="float32", max_new_tokens=8, tokenizer=LetterTokenizer(),
              no_speech_threshold=None)


def gemini_http(prompts: list, speaker_map: str = '{"SPEAKER_00": "Alice"}'):
    """The JAX suite's fake Gemini transport (``test_meeting_pipeline.py``),
    recording every prompt."""
    def http(url, headers, payload, timeout):
        prompt = payload["contents"][0]["parts"][0]["text"]
        prompts.append(prompt)
        if "mapping each speaker code" in prompt:
            text = speaker_map
        elif '"todos"' in prompt:
            text = json.dumps({"title": "Sync", "summary": "We discussed things.",
                               "todos": ["ship it"]})
        else:
            text = "# Notes\n- point one"
        return 200, {"candidates": [{"content": {"parts": [{"text": text}]}}]}

    return http


def notion_http(calls: list):
    def http(method, url, headers, payload, timeout):
        calls.append((method, url, payload))
        if method == "POST":
            return 200, {"id": "page-7", "url": "https://notion.so/page-7"}
        return 200, {}

    return http


@pytest.fixture(scope="module")
def wav_file(tmp_path_factory):
    rng = np.random.default_rng(13579)
    f0s = (float(rng.uniform(95, 120)), float(rng.uniform(190, 240)),
           float(rng.uniform(320, 378)))
    audio, _ = make_meeting(rng, f0s)
    path = tmp_path_factory.mktemp("audio") / "REC_20250617_093000.wav"
    wavio.write_wav(str(path), audio, 16_000)
    return str(path)


@pytest.fixture(scope="module")
def transcribers():
    jt = JTranscriber.random_init("test", **ASR_KW)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jt.params), "cpu")
    cfg = WhisperConfig(**{k: getattr(jt.cfg, k) for k in WhisperConfig.__dataclass_fields__})
    pt = Transcriber(params=params, cfg=cfg, enable_fallback=False, device="cpu", **ASR_KW)
    return jt, pt


@pytest.fixture(scope="module")
def diarizers():
    return JDiarizer.bundled(window_step_s=2.0), Diarizer.bundled(window_step_s=2.0, device="cpu")


@pytest.fixture
def f32(monkeypatch):
    """Embedding convs in float32 on both sides (as ``test_torch_diarize.py``)."""
    monkeypatch.setattr(jemb, "forward", functools.partial(jemb.forward, compute_dtype=jnp.float32))
    monkeypatch.setattr(jemb, "embed_crops",
                        jax.jit(jemb.embed_crops.__wrapped__, static_argnames=("cfg",)))
    monkeypatch.setattr(emb, "embed_crops",
                        functools.partial(emb.embed_crops, compute_dtype=torch.float32))


def run_job(engine, proc, file_id, job_id="m1", failure_result=build_failure_result, **kw):
    """Submit ``proc.process`` as a job; return (public status, store record,
    progress values in the order the engine received them)."""
    values: list[int] = []
    update = engine.update_progress

    def record(jid, value, message=""):
        values.append(int(value))
        return update(jid, value, message)

    engine.update_progress = record
    try:
        engine.create_job(job_id, file_id=file_id)
        engine.submit(job_id, lambda ctx: proc.process(ctx, file_id, **kw),
                      failure_result=failure_result)
        deadline = time.time() + 120.0
        while time.time() < deadline:
            st = engine.get_job_status(job_id)
            if st["status"] in ("completed", "failed", "cancelled"):
                break
            time.sleep(0.05)
        return st, engine.store.get(job_id), values
    finally:
        engine.shutdown(wait=False)


def without_timings(result: dict) -> dict:
    return {k: v for k, v in result.items() if k not in TIMINGS}


def test_meeting_job_equals_jax(wav_file, transcribers, diarizers, f32):
    """The whole job, port against JAX: result, prompts, Notion requests
    and payloads, and progress values all equal."""
    (jt, pt), (jd, pd) = transcribers, diarizers
    runs = {}
    for name, mk_gemini, mk_notion, mod, engine in (
        ("jax", JGeminiClient, JNotionClient, jmeeting, JJobEngine(max_workers=1)),
        ("port", GeminiClient, NotionClient, meeting, JobEngine(max_workers=1)),
    ):
        prompts, calls = [], []
        proc = mod.MeetingProcessor(
            transcriber=jt if name == "jax" else pt,
            diarizer=jd if name == "jax" else pd,
            gemini=mk_gemini(api_key="k", http=gemini_http(prompts)),
            notion=mk_notion(token="t", database_id="db", http=notion_http(calls),
                             batch_pause_s=0),
        )
        st, rec, values = run_job(engine, proc, wav_file,
                                  failure_result=mod.build_failure_result)
        assert st["status"] == "completed", (name, st.get("error"))
        runs[name] = (st["result"], prompts, calls, values, rec["stage_timings"])
    (jres, jprompts, jcalls, jvalues, jstages), (res, prompts, calls, values, stages) = (
        runs["jax"], runs["port"])
    assert res["segments"]
    assert res["identified_speakers"]["SPEAKER_00"] == "Alice"
    assert res["diarizer"] == "bundled-synthetic"
    assert without_timings(res) == without_timings(jres)
    assert set(res) == set(jres)
    assert prompts == jprompts and len(prompts) == 3
    assert calls == jcalls and calls[0][0] == "POST"
    assert values == jvalues
    # the engine writes the final 100 itself, with the result
    assert values[0] == 5 and values[-1] == 95 and values == sorted(values)
    # the same 10 stages (stage 4 has two), in the same order; the port names
    # each by the work of the stage its stage() call starts, JAX by its message
    keys = ("metadata", "attachments", "download", "decode_audio", "transcribe", "speakers",
            "transcript", "summary", "notion", "rename")
    assert len(jstages) == len(keys) and list(stages) == [f"job.{k}" for k in keys]


def test_meeting_job_failure_salvage(wav_file, transcribers):
    class BoomNotion:
        available = True

        def create_meeting_page(self, *a, **k):
            raise RuntimeError("notion down")

    proc = MeetingProcessor(transcriber=transcribers[1], diarizer=None,
                            gemini=GeminiClient(api_key="k", http=gemini_http([])),
                            notion=BoomNotion())
    st, rec, _ = run_job(JobEngine(max_workers=1), proc, wav_file, "m2")
    assert st["status"] == "failed" and "notion down" in st["error"]
    # salvage: the summary survived the Notion failure
    assert rec["result"]["title"] == "Sync" and rec["result"]["success"] is False


def test_meeting_model_fallback(wav_file, transcribers):
    class Boom:
        def transcribe(self, *a, **k):
            raise RuntimeError("primary blew up")

    proc = MeetingProcessor(transcriber=Boom(), fallback_transcriber=transcribers[1],
                            diarizer=None)
    st, _, _ = run_job(JobEngine(max_workers=1), proc, wav_file, "fb")
    assert st["status"] == "completed", st.get("error")
    assert st["result"]["segments"]


def test_meeting_job_missing_file():
    proc = MeetingProcessor(transcriber=None, diarizer=None)
    st, _, _ = run_job(JobEngine(max_workers=1), proc, "/no/such/file.wav", "m3")
    assert st["status"] == "failed"


def test_all_attachments_reach_summary_prompt(wav_file, transcribers, tmp_path):
    pdfs = []
    for i, marker in enumerate(("ALPHA-DOC-CONTEXT", "BETA-DOC-CONTEXT")):
        p = tmp_path / f"doc{i}.pdf"
        p.write_bytes(b"%PDF-1.4\nstream\n" + f"({marker}) Tj".encode() + b"\nendstream\n%%EOF")
        pdfs.append(str(p))
    prompts: list = []
    proc = MeetingProcessor(transcriber=transcribers[1], diarizer=None,
                            gemini=GeminiClient(api_key="k", http=gemini_http(prompts, "{}")))
    st, _, _ = run_job(JobEngine(max_workers=1), proc, wav_file, "att1",
                       attachment_file_ids=pdfs)
    assert st["status"] == "completed", st.get("error")
    summary = [p for p in prompts if '"todos"' in p]
    assert summary and "ALPHA-DOC-CONTEXT" in summary[0] and "BETA-DOC-CONTEXT" in summary[0]


def test_local_paths_rejected_on_drive_backed_deployments(wav_file, transcribers, monkeypatch):
    monkeypatch.delenv("APTPU_ALLOW_LOCAL_FILES", raising=False)

    class _Drive:
        def get_metadata(self, file_id, fields="name"):
            raise FileNotFoundError(file_id)

    proc = MeetingProcessor(transcriber=transcribers[1], diarizer=None, drive=_Drive())
    st, _, _ = run_job(JobEngine(max_workers=1), proc, wav_file, "loc1")
    assert st["status"] == "failed", "local path was served despite Drive"
    # the explicit opt-in restores hermetic local-file behaviour
    monkeypatch.setenv("APTPU_ALLOW_LOCAL_FILES", "1")
    st, _, _ = run_job(JobEngine(max_workers=1), proc, wav_file, "loc2")
    assert st["status"] == "completed", st.get("error")


def test_local_paths_rejected_for_anonymous_on_oauth_only_deployments(
    wav_file, transcribers, monkeypatch
):
    monkeypatch.delenv("APTPU_ALLOW_LOCAL_FILES", raising=False)
    proc = MeetingProcessor(transcriber=transcribers[1], diarizer=None, drive_capable=True)
    st, _, _ = run_job(JobEngine(max_workers=1), proc, wav_file, "anon1",
                       attachment_file_ids=None, user_id=None, oauth_drive=None)
    assert st["status"] == "failed"


def test_profile_dir_writes_torch_trace(wav_file, transcribers, tmp_path, monkeypatch):
    """APTPU_PROFILE_DIR wraps the device stages in a torch.profiler trace,
    written as a Chrome trace under ``job_<id>/``."""
    monkeypatch.setenv("APTPU_PROFILE_DIR", str(tmp_path / "traces"))
    proc = MeetingProcessor(transcriber=transcribers[1], diarizer=None)
    st, _, _ = run_job(JobEngine(max_workers=1), proc, wav_file, "prof1")
    assert st["status"] == "completed", st
    trace = tmp_path / "traces" / "job_prof1" / "trace.json"
    assert trace.is_file()
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_profile_trace_is_best_effort(tmp_path):
    """A held profiler, or a trace that cannot be written, never fails the
    block: it runs untraced."""
    with meeting._trace_lock:  # another job holds the profiler
        with meeting._best_effort_trace(str(tmp_path), "held"):
            pass
    assert not (tmp_path / "job_held").exists()
    blocker = tmp_path / "file"
    blocker.write_text("")
    with meeting._best_effort_trace(str(blocker), "unwritable"):
        torch.ones(4).sum()
    assert not meeting._trace_lock.locked()


@pytest.fixture
def f32_checkpoints(monkeypatch):
    """``Transcriber.from_npz`` in float32 with 8 new tokens on both sides:
    the CLI serves a checkpoint at its bfloat16 default, where the two
    frameworks round at different points."""
    for cls in (JTranscriber, Transcriber):
        load = cls.from_npz.__func__

        def from_npz(c, *a, _load=load, **kw):
            return _load(c, *a, **{**kw, "compute_dtype": "float32", "max_new_tokens": 8})

        monkeypatch.setattr(cls, "from_npz", classmethod(from_npz))


def test_cli_process_equals_jax(wav_file, tmp_path, f32, f32_checkpoints):
    """``cli process`` on one WAV and one checkpoint: the JSON the port
    prints equals the JAX CLI's apart from the times."""
    jt = JTranscriber.random_init("test")
    path = str(tmp_path / "test.npz")
    jconvert.save_params(path, jt.params, jt.cfg)
    outs = []
    for main, extra in ((jcli.main, []), (cli.main, ["--device", "cpu"])):
        buf = io.StringIO()
        with redirect_stdout(buf):
            main(["process", wav_file, "--model-path", path, *extra])
        outs.append(json.loads(buf.getvalue()))
    jout, out = outs
    assert out["status"] == "completed" and out["progress"] == 100
    assert out["result"]["diarizer"] == "bundled-synthetic"
    for o in outs:
        for k in ("created_at", "updated_at"):
            o.pop(k)
        for k in TIMINGS:
            o["result"].pop(k)
    assert out == jout
