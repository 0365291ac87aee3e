"""The meeting job's language-model stages on the port's DeepSeek-V2
(``integrations/local_llm.py``), on the CPU at the ``tiny`` preset.

``build_services`` builds the on-card client when ``APTPU_LOCAL_LLM`` names
a preset, and a job of ``MeetingProcessor`` runs its speaker, summary and
notes stages through it: the trace of the job holds the model's spans and
counters, and the Gemini client's defaults hold, since random weights
write no JSON.  A backlog job (``/api/process`` with ``file_ids``) writes
its meetings up in two batched calls of the engine, and keeps the notes in
its result where no Notion page holds them.  This file imports neither jax
nor the JAX package.
"""
from __future__ import annotations

import io
import json
import time

import numpy as np
import pytest
import torch

from audio_processor_tpu_torch.integrations.gemini import GeminiClient, default_summary
from audio_processor_tpu_torch.integrations.local_llm import LocalLLMClient
from audio_processor_tpu_torch.models.llm.tokenizer import ByteTokenizer
from audio_processor_tpu_torch.pipeline.meeting import MeetingProcessor
from audio_processor_tpu_torch.runtime import services, trace
from audio_processor_tpu_torch.runtime.job_engine import JobContext, JobEngine
from audio_processor_tpu_torch.server import app as app_mod
from audio_processor_tpu_torch.utils import wavio

SEGMENTS = [{"start": 0.0, "end": 2.0, "speaker": "SPEAKER_00", "text": "Hi Bob, shall we start?"},
            {"start": 2.0, "end": 3.5, "speaker": "SPEAKER_01", "text": "Yes Alice."},
            {"start": 3.5, "end": 5.0, "speaker": "SPEAKER_00", "text": "The build is green."}]


@pytest.fixture(scope="module")
def client():
    llm = LocalLLMClient.random_init("tiny", device="cpu")
    llm.speaker_tokens, llm.summary_tokens, llm.notes_tokens = 5, 6, 9  # a tiny job's caps
    return llm


class FixedTranscriber:
    """Stage 4's transcript, without the ASR."""

    def transcribe(self, audio, **kw):
        return {"segments": [dict(s) for s in SEGMENTS], "language": "en", "text": ""}


class PageNotion:
    available = True

    def __init__(self):
        self.pages = []

    def create_meeting_page(self, title, summary, todos, segments, speaker_map, **kw):
        self.pages.append(dict(title=title, notes=kw["comprehensive_notes"],
                               trace=trace.current().summary()))
        return "page-1", "https://notion.example/page-1"


def test_build_services_builds_the_local_client(monkeypatch):
    monkeypatch.setenv("APTPU_LOCAL_LLM", "tiny")
    svc = services.build_services(model="test", device="cpu", with_drive=False,
                                  diarization=False, max_workers=1)
    try:
        llm = svc.processor.gemini
        assert isinstance(llm, LocalLLMClient) and llm.available
        assert llm.engine.cfg.name == "tiny" and llm.engine.device == torch.device("cpu")
        assert llm.engine.params["embed"].dtype == torch.float32
    finally:
        svc.engine.shutdown(wait=False)
    monkeypatch.setenv("APTPU_LOCAL_LLM", "no-such-model")
    with pytest.raises(ValueError, match="unknown language model"):
        services.build_services(model="test", device="cpu", with_drive=False,
                                diarization=False, max_workers=1)


def test_a_meeting_job_runs_its_language_stages_on_the_local_model(tmp_path, monkeypatch):
    """``build_services`` with the local option, then a job through its
    engine and ``MeetingProcessor`` (the transcript fixed, a page to hold
    the notes)."""
    monkeypatch.setenv("APTPU_LOCAL_LLM", "tiny")
    svc = services.build_services(model="test", device="cpu", with_drive=False,
                                  diarization=False, max_workers=1)
    llm = svc.processor.gemini
    llm.speaker_tokens, llm.summary_tokens, llm.notes_tokens = 5, 6, 9
    notion = PageNotion()
    svc.processor.transcriber, svc.processor.notion = FixedTranscriber(), notion
    wav = tmp_path / "standup.wav"
    wavio.write_wav(str(wav), np.zeros(16_000 * 5, np.float32), 16_000)
    try:
        svc.engine.create_job("j1", file_id=str(wav))
        svc.submit_processing_job("j1", str(wav), None, None)
        deadline = time.time() + 120
        while svc.engine.get_job_status("j1")["status"] not in ("completed", "failed"):
            assert time.time() < deadline
            time.sleep(0.05)
        st = svc.engine.get_job_status("j1")
    finally:
        svc.engine.shutdown(wait=True)
    assert st["status"] == "completed", st.get("error")
    res = st["result"]
    # random weights write no JSON: the Gemini client's defaults hold
    # (no diarizer: stage 4 labels every segment SPEAKER_UNKNOWN)
    assert res["identified_speakers"] == {"SPEAKER_UNKNOWN": "SPEAKER_UNKNOWN"}
    assert (res["title"], res["summary"], res["todos"]) == (
        "Meeting Notes", "Summary generation failed.", [])
    (page,) = notion.pages
    assert isinstance(page["notes"], str)
    tr = page["trace"]
    # the speaker task, then the summary and the notes as two rows of one call
    assert tr["counters"]["llm.decode.rows"] == 3
    assert tr["spans"]["llm.prefill"]["count"] == 2
    assert tr["counters"]["llm.decode.steps"] == 4 + 8
    for name in ("llm.decode", "llm.decode.step", "llm.decode.wait", "job.summary"):
        assert tr["spans"][name]["count"] >= 1
    assert tr["counters"]["llm.prefill_tokens"] > 0
    assert tr["counters"]["llm.moe.experts_touched"] > 0


def test_the_tasks_keep_the_gemini_defaults_and_parse_json(client, monkeypatch):
    assert client.identify_speakers_many([[]]) == [{}]
    (summary, notes), = client.summary_and_notes_many([("A: hi", "")])
    assert summary == default_summary() and isinstance(notes, str)
    monkeypatch.setattr(client, "text", lambda ids: '```json\n{"SPEAKER_00": "Alice", '
                        '"title": "Standup", "summary": "ok", "todos": ["ship"]}\n```')
    assert client.identify_speakers_many([SEGMENTS, []]) == [
        {"SPEAKER_00": "Alice", "SPEAKER_01": "SPEAKER_01"}, {}]
    assert client.summary_and_notes_many([("A: hi", "")])[0][0] == {
        "title": "Standup", "summary": "ok", "todos": ["ship"]}

    def boom(*a, **k):
        raise RuntimeError("out of memory")

    monkeypatch.undo()
    monkeypatch.setattr(client.engine, "generate", boom)
    assert client.identify_speakers_many([SEGMENTS])[0]["SPEAKER_01"] == "SPEAKER_01"
    assert client.summary_and_notes_many([("A: hi", ""), ("B: yo", "")]) == [
        (default_summary(), "")] * 2


def test_prompts_put_the_transcript_first_in_deepseek_chats_layout(client):
    summary, notes = client.write_up_prompts("SPEAKER_00: hi", "doc")
    bos = client.engine.cfg.bos_token_id
    assert summary[0] == notes[0] == bos
    tok = ByteTokenizer()
    assert tok.decode(summary[1:]).startswith("User: Transcript:\nSPEAKER_00: hi\n\nReference")
    assert tok.decode(notes[1:]).endswith("\n\nAssistant:")
    shared = len(tok.encode("User: Transcript:\nSPEAKER_00: hi\n\n")) + 1
    assert summary[:shared] == notes[:shared] and summary[shared] != notes[shared]
    assert tok.decode(tok.encode("naïve ✓")) == "naïve ✓"
    assert tok.decode([104, 105, 100001, 300]) == "hi"


def call(app, method, path, body):
    """One WSGI request with a JSON body; returns (status, JSON body)."""
    raw = json.dumps(body).encode()
    environ = {"REQUEST_METHOD": method, "PATH_INFO": path, "QUERY_STRING": "",
               "CONTENT_LENGTH": str(len(raw)), "CONTENT_TYPE": "application/json",
               "wsgi.input": io.BytesIO(raw)}
    got = {}

    def start_response(status, headers):
        got["status"] = int(status.split()[0])

    data = b"".join(app(environ, start_response))
    return got["status"], json.loads(data)


class TalkTranscriber:
    """Stage 4's transcript, a turn longer at each call, without the ASR."""

    def __init__(self):
        self.calls = 0

    def transcribe(self, audio, **kw):
        self.calls += 1
        more = [{"start": 5.0, "end": 6.0, "speaker": "SPEAKER_01", "text": "Next."}]
        return {"segments": [dict(s) for s in SEGMENTS] + more * self.calls, "language": "en",
                "text": ""}


@pytest.mark.parametrize("max_meetings, calls", [(16, [[1, 1, 1], [2, 2, 2]]),
                                                  (2, [[1, 1], [1], [2, 2], [2]])])
def test_a_backlog_is_written_up_in_two_batched_calls(tmp_path, monkeypatch, max_meetings, calls):
    """``/api/process`` with ``file_ids``: one job transcribes each
    recording, then the client takes every meeting's speaker task in one
    call of the engine and every summary and notes in another (in calls of
    at most ``max_meetings``); with no Notion the notes stay in each
    meeting's result, and progress rises once over the backlog."""
    monkeypatch.setenv("APTPU_LOCAL_LLM", "tiny")
    svc = services.build_services(model="test", device="cpu", with_drive=False,
                                  diarization=False, max_workers=1)
    llm = svc.processor.gemini
    llm.speaker_tokens, llm.summary_tokens, llm.notes_tokens = 5, 6, 9
    llm.max_meetings = max_meetings
    svc.processor.transcriber = TalkTranscriber()
    seen, generate = [], llm.engine.generate

    def spy(groups, caps):
        seen.append([len(g) for g in groups])
        return generate(groups, caps)

    monkeypatch.setattr(llm.engine, "generate", spy)
    values, update = [], svc.engine.update_progress
    monkeypatch.setattr(svc.engine, "update_progress",
                        lambda jid, v, m="": (values.append(v), update(jid, v, m))[1])
    wavs = []
    for i in range(3):
        wavs.append(str(tmp_path / f"REC_2025061{i}_093000.wav"))
        wavio.write_wav(wavs[-1], np.zeros(16_000 * (2 + i), np.float32), 16_000)
    app = app_mod.create_app(svc, secret_key="k")
    try:
        status, data = call(app, "POST", "/api/process", {"file_ids": wavs})
        assert status == 200 and data["success"], data
        deadline = time.time() + 120
        while svc.engine.get_job_status(data["job_id"])["status"] not in ("completed", "failed"):
            assert time.time() < deadline
            time.sleep(0.05)
        st = svc.engine.get_job_status(data["job_id"])
    finally:
        svc.engine.shutdown(wait=True)
    assert st["status"] == "completed", st.get("error")
    assert seen == calls
    res = st["result"]
    assert res["duration_s"] == 9.0 and len(res["meetings"]) == 3
    for i, m in enumerate(res["meetings"]):
        assert m["title"] == "Meeting Notes" and isinstance(m["notes"], str)
        assert m["duration_s"] == 2 + i and len(m["segments"]) == 3 + 1 + i
        assert m["drive_filename"].startswith(f"[2025-06-1{i}]")
    assert values == sorted(values) and values[0] < 5 and values[-1] == 98


@pytest.mark.parametrize("body", [{"file_ids": []}, {"file_ids": "a.wav"}, {"file_ids": [3]},
                                  {"file_ids": ["a.wav"], "file_id": "b.wav"},
                                  {"file_ids": ["a.wav"], "attachment_file_ids": ["c.pdf"]},
                                  {"file_ids": ["a.wav"] * 65}])
def test_a_backlog_request_is_checked(body):
    proc = MeetingProcessor(transcriber=None)
    engine = JobEngine(max_workers=1)
    app = app_mod.create_app(services.Services(engine=engine, processor=proc), secret_key="k")
    try:
        status, data = call(app, "POST", "/api/process", body)
    finally:
        engine.shutdown(wait=False)
    assert status == 400 and not data["success"] and "file_ids" in data["error"]


def test_notes_go_to_the_result_where_no_page_holds_them(tmp_path):
    """Gemini's notes too: written, with no Notion, into the result."""
    prompts = []

    def http(url, headers, payload, timeout):
        prompts.append(payload["contents"][0]["parts"][0]["text"])
        return 200, {"candidates": [{"content": {"parts": [{"text": "# Notes"}]}}]}

    proc = MeetingProcessor(transcriber=FixedTranscriber(), diarizer=None,
                            gemini=GeminiClient(api_key="k", http=http))
    wav = str(tmp_path / "standup.wav")
    wavio.write_wav(wav, np.zeros(16_000 * 5, np.float32), 16_000)
    engine = JobEngine(max_workers=1)
    engine.create_job("n1", file_id=wav)
    try:
        ctx = JobContext(engine, "n1")
        res = proc.process(ctx, wav)
        ctx.end_stage()
    finally:
        engine.shutdown(wait=False)
    assert res["notes"] == "# Notes" and len(prompts) == 3
    assert res["title"] == "Meeting Notes"  # "# Notes" is no JSON summary
