"""The 9-stage meeting-processing job, on the port's Transcriber and Diarizer.

metadata -> PDF attachments -> audio download -> transcribe + diarize +
fuse (on the device) -> LLM speaker identification -> LLM summary and
notes -> Notion page -> Drive rename -> result dict, with the progress checkpoints
(5/8/15/25/30/65/75/80/90/95/100), cooperative cancellation between every
stage, partial-result salvage on failure, and temp-dir cleanup in finally.

The port of the JAX package's ``pipeline/meeting.py``: the stages,
progress values, cancellation points, salvage, local-path rules, model
fallback and result dict are that module's.  Stage 4 runs the port's
``Transcriber`` and ``Diarizer`` (kernels A and B on the card), and the
``APTPU_PROFILE_DIR`` hook records a ``torch.profiler`` Chrome trace of it,
in which the job's stage spans and the Transcriber's and Diarizer's spans
(``runtime/trace.py``) name what the host was doing beside the kernels.
``file_id`` may also be a local filesystem path (standalone, Drive-less
operation).

Beyond the JAX module: the meeting notes are written whenever a language
model is configured, and go into the result (``notes``) where no Notion
page holds them; ``process_backlog`` runs several recordings as one job,
with stages 5-7 of all of them together (``write_up``), so that an
on-card model (``integrations/local_llm.py``) writes them up in batches.
"""
from __future__ import annotations

import contextlib
import logging
import os
import shutil
import tempfile
import threading
import time
from dataclasses import dataclass
from datetime import datetime
from typing import Any

import torch

from ..integrations.drive import sanitize_filename
from ..runtime.job_engine import JobContext
from ..utils.constants import PROGRESS
from ..utils.timestamps import extract_date_from_filename
from . import fuse, ingest

logger = logging.getLogger(__name__)


def build_failure_result(exc: Exception, partial: dict) -> dict:
    """Salvage partial pipeline outputs into the failure result
    (reference: audio_processor.py:1360-1374)."""
    return {
        "success": False,
        "error": f"Processing failed: {exc}",
        "notion_page_id": None,
        "notion_page_url": None,
        "title": partial.get("title", "Processing failed"),
        "summary": partial.get("summary", f"Error during processing: {exc}"),
        "todos": partial.get("todos", ["Check processing logs"]),
        "identified_speakers": partial.get("speaker_map"),
    }


# the profiler is process-wide: one job traces at a time, the others run
# untraced
_trace_lock = threading.Lock()


@contextlib.contextmanager
def _best_effort_trace(profile_dir: str | None, job_id: str):
    """A torch.profiler trace of the block, written as a Chrome trace to
    ``<profile_dir>/job_<job_id>/trace.json``.  Profiling is observability
    only and never fails the job: a held profiler, or a failure to start
    or write the trace, degrades to no trace with a warning."""
    if not profile_dir or not _trace_lock.acquire(blocking=False):
        if profile_dir:
            logger.warning("device trace unavailable for %s: another job holds "
                           "the profiler", job_id)
        yield
        return
    try:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        try:
            prof.__enter__()
        except Exception as exc:  # noqa: BLE001 — observability only
            logger.warning("device trace unavailable for %s: %s", job_id, exc)
            yield
            return
        try:
            yield
        finally:
            try:
                prof.__exit__(None, None, None)
                out_dir = os.path.join(profile_dir, f"job_{job_id}")
                os.makedirs(out_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
            except Exception as exc:  # noqa: BLE001
                logger.warning("device trace finalisation failed for %s: %s",
                               job_id, exc)
    finally:
        _trace_lock.release()


@dataclass
class MeetingProcessor:
    transcriber: Any  # pipeline.transcribe.Transcriber
    diarizer: Any | None = None  # pipeline.diarize.Diarizer
    drive: Any | None = None  # integrations.drive.DriveClient (service account)
    # the language-model stages: integrations.gemini.GeminiClient, or
    # integrations.local_llm.LocalLLMClient (the model on the card)
    gemini: Any | None = None
    notion: Any | None = None  # integrations.notion.NotionClient
    remove_silence: bool = True
    # smaller-model retry, mirroring the reference's medium->small fallback
    # on transcription failure (audio_processor.py:1056-1098)
    fallback_transcriber: Any | None = None
    # DEPLOYMENT-level Drive capability (SA client OR OAuth login config).
    # The local-path gate must key off this, not the per-job client: on an
    # OAuth-only Drive deployment an ANONYMOUS caller has no oauth_drive,
    # and a per-job check would hand exactly that caller local-file reads.
    drive_capable: bool = False

    def process(
        self,
        ctx: JobContext,
        file_id: str,
        attachment_file_ids: list[str] | None = None,
        user_id: str | None = None,
        oauth_drive: Any | None = None,
    ) -> dict:
        t_job = time.perf_counter()
        tmp: list[str] = []
        try:
            meeting = self._ingest(ctx, file_id, attachment_file_ids, oauth_drive, tmp)
            (written,) = self.write_up(ctx, [meeting])
            return self._publish(ctx, meeting, written, oauth_drive, t_job)
        finally:
            _remove(tmp)

    def process_backlog(
        self,
        ctx: JobContext,
        file_ids: list[str],
        user_id: str | None = None,
        oauth_drive: Any | None = None,
    ) -> dict:
        """Several recordings as one job, such as a day's backlog: stages
        1-4 of each in turn, then stages 5-7 of all of them together
        (``write_up``: an on-card language model gets each task of every
        meeting in one batched call), then stages 8-9 of each.  Progress
        runs once from 5 to 95 over the whole backlog.  A failure in any
        meeting fails the job, as it fails a one-meeting job.  The result
        holds ``meetings``, each as ``process`` returns it, and the
        backlog's ``duration_s``, ``processing_s`` and ``rtf_x``."""
        t_job = time.perf_counter()
        meetings = []
        for i, file_id in enumerate(file_ids):
            tmp: list[str] = []
            try:
                meetings.append(self._ingest(ctx, file_id, None, oauth_drive, tmp,
                                             part=(i, len(file_ids))))
            finally:
                _remove(tmp)
        written = self.write_up(ctx, meetings)
        results = [self._publish(ctx, m, w, oauth_drive, t_job, part=(i, len(meetings)))
                   for i, (m, w) in enumerate(zip(meetings, written))]
        duration_s = sum(m["duration_s"] for m in meetings)
        elapsed = time.perf_counter() - t_job
        return {
            "success": True,
            "meetings": results,
            "duration_s": round(duration_s, 2),
            "processing_s": round(elapsed, 2),
            "rtf_x": round(duration_s / max(elapsed, 1e-9), 2),
        }

    def _ingest(
        self,
        ctx: JobContext,
        file_id: str,
        attachment_file_ids: list[str] | None,
        oauth_drive: Any | None,
        tmp: list[str],
        part: tuple[int, int] | None = None,
    ) -> dict:
        """Stages 1-4 of one recording: its name, attachments' text and
        fused segments.  Temporary directories go on ``tmp``.  ``part``
        (i, n): the i-th of a backlog of n, which reports progress in its
        n-th of the range."""
        i, n = part or (0, 1)
        label = f"[{i + 1}/{n}] " if part else ""

        def at(value: int) -> int:
            return (i * PROGRESS["transcribe"] + value) // n

        def stage(key: str, message: str) -> None:
            ctx.stage(PROGRESS[key], label + message, progress=at(PROGRESS[key]))

        # reads fall back to the user's OAuth client when no service account
        # is configured; writes (rename) stay on the SA client — the OAuth
        # scope is drive.readonly (reference: auth_routes.py:96-101)
        read_drive = self.drive or oauth_drive

        # -- stage 1: metadata ---------------------------------------------
        stage("start", "Fetching file metadata...")
        # local-path file_ids are the hermetic/CLI mode (no Drive
        # configured).  On a Drive-backed deployment the job API takes
        # Drive ids ONLY (the reference's posture — its file_id is
        # always a Drive id, api_routes.py:36-57): otherwise any API
        # caller could read server-local files into the Gemini prompt
        # and the Notion page.  APTPU_ALLOW_LOCAL_FILES=1 opts back in.
        # Keyed off deployment capability (drive_capable), NOT the
        # per-job read_drive — see the field comment.
        allow_local = (
            not (self.drive_capable or read_drive is not None)
        ) or os.environ.get(
            "APTPU_ALLOW_LOCAL_FILES", ""
        ).lower() in ("1", "true", "yes")
        is_local = allow_local and os.path.exists(file_id)
        if is_local:
            original_filename = os.path.basename(file_id)
        elif read_drive is not None:
            meta = read_drive.get_metadata(file_id, fields="name")
            original_filename = meta.get("name", file_id)
        else:
            raise ValueError(f"file {file_id!r} not found and no Drive client")

        # -- stage 2: attachments ------------------------------------------
        stage("attachments", "Downloading attachments...")
        attachment_texts: list[str] = []
        if attachment_file_ids:
            from ..integrations import pdf as pdf_lib

            attach_tmp = tempfile.mkdtemp(prefix="aptpu_attach_")
            tmp.append(attach_tmp)
            for aid in attachment_file_ids:
                ctx.check_cancelled()
                try:
                    if allow_local and os.path.exists(aid):
                        text = pdf_lib.extract_text_from_file(aid)
                    elif read_drive is not None:
                        text = pdf_lib.extract_text(read_drive.download_bytes(aid))
                    else:
                        text = ""
                    if text:
                        attachment_texts.append(text)
                except Exception as exc:  # noqa: BLE001 — best-effort
                    logger.warning("attachment %s failed: %s", aid, exc)

        # -- stage 3: download audio ---------------------------------------
        stage("download", "Downloading audio file...")
        if is_local:
            audio_path = file_id
        else:
            audio_tmp = tempfile.mkdtemp(prefix="aptpu_audio_")
            tmp.append(audio_tmp)
            audio_path = os.path.join(audio_tmp, sanitize_filename(original_filename))
            read_drive.download(file_id, audio_path)

        # -- stage 4: decode + transcribe + diarize + fuse -----------------
        stage("preprocess", "Decoding audio...")
        audio = ingest.load_audio(audio_path)
        duration_s = len(audio) / ingest.TARGET_SR

        stage("convert", "Transcribing on the device...")
        span = PROGRESS["transcribe"] - PROGRESS["convert"]

        def _run_transcribe(t):
            return t.transcribe(
                audio,
                remove_silence=self.remove_silence,
                progress=lambda frac: ctx.progress(
                    at(PROGRESS["convert"] + int(frac * span)),
                    label + "Transcribing on the device...",
                ),
            )

        # APTPU_PROFILE_DIR=<dir>: a torch.profiler Chrome trace of the
        # device stages, one subdirectory per job (and per meeting of a
        # backlog), on top of the per-stage wall timings every job records
        trace_id = f"{ctx.job_id}_{i}" if part else ctx.job_id
        with _best_effort_trace(os.environ.get("APTPU_PROFILE_DIR"), trace_id):
            try:
                asr = _run_transcribe(self.transcriber)
            except Exception as exc:  # noqa: BLE001 — model-fallback boundary
                if self.fallback_transcriber is None:
                    raise
                logger.warning(
                    "primary transcriber failed (%s); retrying with fallback model",
                    exc,
                )
                asr = _run_transcribe(self.fallback_transcriber)
            segments_raw = asr["segments"]

            turns = (
                self.diarizer.diarize(audio) if self.diarizer is not None else []
            )
        diarizer_status = None
        if self.diarizer is not None:
            untrained = getattr(self.diarizer, "untrained_parts", [])
            diarizer_status = (
                "untrained:" + ",".join(untrained)
                if untrained
                else getattr(self.diarizer, "provenance", "trained")
            )
            if untrained:
                logger.warning(
                    "diarizer serving RANDOM %s weights — speaker labels "
                    "in this job are meaningless (configure "
                    "APTPU_DIARIZER_PATH / APTPU_EMBEDDING_PATH)",
                    " and ".join(untrained),
                )
        segments = fuse.fuse_segments(segments_raw, turns)
        ctx.partial["segments"] = segments
        return {
            "file_id": file_id,
            "name": original_filename,
            "is_local": is_local,
            "duration_s": duration_s,
            "segments": segments,
            # ALL attachments reach the prompt (the reference downloads
            # every PDF but passes only attachment_texts[0] to the
            # summary, reference:1297 — same defect class as its
            # first-20-segments speaker sampling, fixed deliberately)
            "attachment_text": "\n\n".join(attachment_texts),
            "diarizer": diarizer_status,
        }

    def write_up(self, ctx: JobContext, meetings: list[dict]) -> list[dict]:
        """Stages 5-7 of ``meetings`` (``_ingest``'s dicts; ``segments``,
        ``attachment_text``, ``name`` and ``duration_s`` are read): each
        one's speaker map, relabelled segments, title, summary, action
        items and meeting notes (None without a language model).  A
        client that takes a batch (``identify_speakers_many``,
        ``summary_and_notes_many``: the on-card model) gets each task of
        every meeting in one call; Gemini's gets them one at a time."""
        llm = self.gemini
        segments = [m["segments"] for m in meetings]

        # -- stage 5: speaker identification -------------------------------
        ctx.stage(PROGRESS["transcribe"], "Identifying speakers...")
        if llm is None:
            speaker_maps = [{s: s for s in sorted({x["speaker"] for x in segs})}
                            for segs in segments]
        elif hasattr(llm, "identify_speakers_many"):
            speaker_maps = llm.identify_speakers_many(segments)
        else:
            speaker_maps = [llm.identify_speakers(segs) for segs in segments]
        ctx.partial["speaker_map"] = speaker_maps[-1]

        # -- stage 6: relabel + transcript ---------------------------------
        ctx.stage(PROGRESS["identify_speakers"], "Building transcript...")
        relabelled = [fuse.relabel_speakers(segs, sm)
                      for segs, sm in zip(segments, speaker_maps)]
        transcripts = [fuse.format_transcript(segs, with_timestamps=False)
                       for segs in relabelled]

        # -- stage 7: summary and notes ------------------------------------
        ctx.stage(PROGRESS["summary"], "Generating summary...")
        if llm is None:
            written = [({"title": os.path.splitext(m["name"])[0],
                         "summary": f"Transcribed {m['duration_s']:.0f}s meeting with "
                         f"{len(segs)} segments.",
                         "todos": []}, None)
                       for m, segs in zip(meetings, relabelled)]
        elif hasattr(llm, "summary_and_notes_many"):
            # the on-card model decodes the summary and the notes as two
            # rows of one prefilled transcript
            written = llm.summary_and_notes_many(
                [(t, m["attachment_text"]) for t, m in zip(transcripts, meetings)])
        else:
            written = [(llm.generate_summary(t, m["attachment_text"]),
                        llm.generate_comprehensive_notes(t))
                       for t, m in zip(transcripts, meetings)]
        out = [{"speaker_map": sm, "segments": segs, "title": s["title"],
                "summary": s["summary"], "todos": s["todos"], "notes": notes}
               for sm, segs, (s, notes) in zip(speaker_maps, relabelled, written)]
        last = out[-1]
        ctx.partial.update(title=last["title"], summary=last["summary"], todos=last["todos"])
        return out

    def _publish(
        self,
        ctx: JobContext,
        meeting: dict,
        written: dict,
        oauth_drive: Any | None,
        t_job: float,
        part: tuple[int, int] | None = None,
    ) -> dict:
        """Stages 8-9 of one meeting and its result.  The notes go to the
        Notion page where one is configured, else into the result."""
        i, n = part or (0, 1)
        label = f"[{i + 1}/{n}] " if part else ""
        lo, hi = PROGRESS["notion"], PROGRESS["done"]

        def stage(key: str, message: str) -> None:
            value = PROGRESS[key]
            ctx.stage(value, label + message, progress=lo + (i * (hi - lo) + value - lo) // n)

        read_drive = self.drive or oauth_drive
        file_id, original_filename = meeting["file_id"], meeting["name"]
        title, summary, todos = written["title"], written["summary"], written["todos"]
        notes = written["notes"]

        # -- stage 8: Notion page ------------------------------------------
        stage("notion", "Creating Notion page...")
        file_date = extract_date_from_filename(original_filename)
        date_str = file_date or datetime.now().strftime("%Y-%m-%d")
        page_id = page_url = None
        paged = self.notion is not None and self.notion.available
        if paged:
            drive_link = (
                read_drive.file_link(file_id)
                if (read_drive is not None and not meeting["is_local"])
                else None
            )
            page_id, page_url = self.notion.create_meeting_page(
                title,
                summary,
                todos,
                written["segments"],
                written["speaker_map"],
                comprehensive_notes=notes or "",
                date_str=date_str,
                drive_link=drive_link,
            )

        # -- stage 9: rename Drive file ------------------------------------
        stage("rename", "Organizing Drive files...")
        ext = os.path.splitext(original_filename)[1] or ".m4a"
        new_filename = f"[{date_str}] {title}{ext}"
        if self.drive is not None and not meeting["is_local"]:
            try:
                self.drive.rename(file_id, new_filename)
            except Exception as exc:  # noqa: BLE001 — rename is optional
                logger.warning("drive rename failed: %s", exc)

        duration_s = meeting["duration_s"]
        elapsed = time.perf_counter() - t_job
        result = {
            "success": True,
            "notion_page_id": page_id,
            "notion_page_url": page_url,
            "title": title,
            "summary": summary,
            "todos": todos,
            "identified_speakers": written["speaker_map"],
            "drive_filename": new_filename,
            "segments": written["segments"],
            "duration_s": round(duration_s, 2),
            "processing_s": round(elapsed, 2),
            "rtf_x": round(duration_s / max(elapsed, 1e-9), 2),
            # "trained" | "untrained:<parts>" | None (diarization off) —
            # jobs must not pass random-weight speaker clusters off as
            # real output (reference serves trained pyannote weights
            # unconditionally, app/services/audio_processor.py:885)
            "diarizer": meeting["diarizer"],
        }
        if notes is not None and not paged:
            result["notes"] = notes
        return result


def _remove(dirs: list[str]) -> None:
    for tmp in dirs:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp, ignore_errors=True)
