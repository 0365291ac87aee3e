"""The 9-stage meeting-processing job, on the port's Transcriber and Diarizer.

metadata -> PDF attachments -> audio download -> transcribe + diarize +
fuse (on the device) -> LLM speaker identification -> LLM summary ->
Notion page -> Drive rename -> result dict, with the progress checkpoints
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
    gemini: Any | None = None  # integrations.gemini.GeminiClient
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
        audio_tmp: str | None = None
        attach_tmp: str | None = None
        # reads fall back to the user's OAuth client when no service account
        # is configured; writes (rename) stay on the SA client — the OAuth
        # scope is drive.readonly (reference: auth_routes.py:96-101)
        read_drive = self.drive or oauth_drive
        try:
            # -- stage 1: metadata -----------------------------------------
            ctx.stage(PROGRESS["start"], "Fetching file metadata...")
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

            # -- stage 2: attachments --------------------------------------
            ctx.stage(PROGRESS["attachments"], "Downloading attachments...")
            attachment_texts: list[str] = []
            if attachment_file_ids:
                from ..integrations import pdf as pdf_lib

                attach_tmp = tempfile.mkdtemp(prefix="aptpu_attach_")
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

            # -- stage 3: download audio -----------------------------------
            ctx.stage(PROGRESS["download"], "Downloading audio file...")
            if is_local:
                audio_path = file_id
            else:
                audio_tmp = tempfile.mkdtemp(prefix="aptpu_audio_")
                audio_path = os.path.join(
                    audio_tmp, sanitize_filename(original_filename)
                )
                read_drive.download(file_id, audio_path)

            # -- stage 4: decode + transcribe + diarize + fuse -------------
            ctx.stage(PROGRESS["preprocess"], "Decoding audio...")
            audio = ingest.load_audio(audio_path)
            duration_s = len(audio) / ingest.TARGET_SR

            ctx.stage(PROGRESS["convert"], "Transcribing on the device...")
            span = PROGRESS["transcribe"] - PROGRESS["convert"]

            def _run_transcribe(t):
                return t.transcribe(
                    audio,
                    remove_silence=self.remove_silence,
                    progress=lambda frac: ctx.progress(
                        PROGRESS["convert"] + int(frac * span),
                        "Transcribing on the device...",
                    ),
                )

            # APTPU_PROFILE_DIR=<dir>: a torch.profiler Chrome trace of the
            # device stages, one subdirectory per job, on top of the
            # per-stage wall timings every job records
            with _best_effort_trace(os.environ.get("APTPU_PROFILE_DIR"), ctx.job_id):
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

            # -- stage 5: speaker identification ---------------------------
            ctx.stage(PROGRESS["transcribe"], "Identifying speakers...")
            if self.gemini is not None:
                speaker_map = self.gemini.identify_speakers(segments)
            else:
                speaker_map = {s: s for s in sorted({x["speaker"] for x in segments})}
            ctx.partial["speaker_map"] = speaker_map

            # -- stage 6: relabel + transcript -----------------------------
            ctx.stage(PROGRESS["identify_speakers"], "Building transcript...")
            updated_segments = fuse.relabel_speakers(segments, speaker_map)
            transcript_for_summary = fuse.format_transcript(
                updated_segments, with_timestamps=False
            )

            # -- stage 7: summary ------------------------------------------
            ctx.stage(PROGRESS["summary"], "Generating summary...")
            if self.gemini is not None:
                # ALL attachments reach the prompt (the reference downloads
                # every PDF but passes only attachment_texts[0] to the
                # summary, reference:1297 — same defect class as its
                # first-20-segments speaker sampling, fixed deliberately)
                summary_data = self.gemini.generate_summary(
                    transcript_for_summary,
                    "\n\n".join(attachment_texts),
                )
            else:
                summary_data = {
                    "title": os.path.splitext(original_filename)[0],
                    "summary": f"Transcribed {duration_s:.0f}s meeting with "
                    f"{len(updated_segments)} segments.",
                    "todos": [],
                }
            title, summary, todos = (
                summary_data["title"],
                summary_data["summary"],
                summary_data["todos"],
            )
            ctx.partial.update(title=title, summary=summary, todos=todos)

            # -- stage 8: Notion page --------------------------------------
            ctx.stage(PROGRESS["notion"], "Creating Notion page...")
            file_date = extract_date_from_filename(original_filename)
            date_str = file_date or datetime.now().strftime("%Y-%m-%d")
            page_id = page_url = None
            if self.notion is not None and self.notion.available:
                notes = (
                    self.gemini.generate_comprehensive_notes(transcript_for_summary)
                    if self.gemini is not None
                    else ""
                )
                drive_link = (
                    read_drive.file_link(file_id)
                    if (read_drive is not None and not is_local)
                    else None
                )
                page_id, page_url = self.notion.create_meeting_page(
                    title,
                    summary,
                    todos,
                    updated_segments,
                    speaker_map,
                    comprehensive_notes=notes,
                    date_str=date_str,
                    drive_link=drive_link,
                )

            # -- stage 9: rename Drive file --------------------------------
            ctx.stage(PROGRESS["rename"], "Organizing Drive files...")
            ext = os.path.splitext(original_filename)[1] or ".m4a"
            new_filename = f"[{date_str}] {title}{ext}"
            if self.drive is not None and not is_local:
                try:
                    self.drive.rename(file_id, new_filename)
                except Exception as exc:  # noqa: BLE001 — rename is optional
                    logger.warning("drive rename failed: %s", exc)

            elapsed = time.perf_counter() - t_job
            return {
                "success": True,
                "notion_page_id": page_id,
                "notion_page_url": page_url,
                "title": title,
                "summary": summary,
                "todos": todos,
                "identified_speakers": speaker_map,
                "drive_filename": new_filename,
                "segments": updated_segments,
                "duration_s": round(duration_s, 2),
                "processing_s": round(elapsed, 2),
                "rtf_x": round(duration_s / max(elapsed, 1e-9), 2),
                # "trained" | "untrained:<parts>" | None (diarization off) —
                # jobs must not pass random-weight speaker clusters off as
                # real output (reference serves trained pyannote weights
                # unconditionally, app/services/audio_processor.py:885)
                "diarizer": diarizer_status,
            }
        finally:
            for tmp in (audio_tmp, attach_tmp):
                if tmp and os.path.isdir(tmp):
                    shutil.rmtree(tmp, ignore_errors=True)
