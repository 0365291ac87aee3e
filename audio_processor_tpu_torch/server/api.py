"""JSON API: the reference's 9 /api endpoints, byte-compatible shapes.

Route inventory and response contracts mirror
app/routes/api_routes.py:15-404 of the reference (SURVEY.md §2 'API
routes'): health, process, job/<id>, jobs?filter=, drive/files,
job/<id>/cancel, jobs/status/batch, jobs/<id>/result, jobs/debug.
Implementation differences (by design):
  * jobs live in a shared persistent store, so every server worker sees the
    same queue (fixes the reference's gunicorn split-brain defect);
  * messages are English equivalents of the reference's zh-TW strings;
  * /process also takes ``file_ids``, a backlog of recordings as one job
    (``MeetingProcessor.process_backlog``), which an on-card language
    model writes up in batches.

A copy of the JAX package's ``server/api.py``: the PyTorch package
imports nothing of that package.
"""
from __future__ import annotations

import logging
import os
import threading
import uuid
from datetime import datetime
from typing import Any

from .web import Blueprint, Request, Response

logger = logging.getLogger(__name__)

# recordings a backlog job at most
MAX_BACKLOG = 64


# SSE subscribers each hold a server thread; in the thread-per-request dev
# server a few dozen tabs would exhaust the pool, so cap concurrent streams
# PROCESS-WIDE (the /api and un-prefixed aliases share one pool) and let
# excess clients degrade to the 3 s polling transport the frontend already
# implements (round-1 review weak #5).  Default 8: half the gunicorn
# gthread pool (Dockerfile --threads 16) and a quarter of the dev server
# pool (APTPU_HTTP_WORKERS=32), so streams can never starve ordinary
# requests of worker threads.
_sse_slots = {"active": 0}
_sse_lock = threading.Lock()


def make_api_blueprint(services: Any, url_prefix: str = "/api") -> Blueprint:
    """services: runtime.services.Services (engine, processor, drive, ...).

    The reference README documents UN-prefixed endpoints (/process, /job,
    /jobs — reference README.md:114,152) while its code serves /api/*
    (app/__init__.py:76); create_app registers this blueprint under both
    prefixes so either client form works.
    """
    bp = Blueprint("api", url_prefix=url_prefix)
    engine = services.engine

    def _job_visible(request: Request, status: dict | None) -> bool:
        """Per-user job scoping (on by default; APTPU_SCOPE_JOBS_TO_USER=0
        restores the reference's everyone-sees-everything posture).

        Jobs carry the submitting user_id; another user's session must not
        read their transcript/result (the reference leaks all jobs to all
        callers).  Ownerless jobs (anonymous/CLI) stay visible to all;
        Bearer-key callers are operators and see everything.
        """
        if status is None:
            return False
        if os.environ.get(
            "APTPU_SCOPE_JOBS_TO_USER", "1"
        ).lower() in ("0", "false", "no"):
            return True
        owner = status.get("user_id")
        if owner is None:
            return True
        from .security import bearer_key_ok, configured_keys

        keys = configured_keys()
        if keys and bearer_key_ok(request, keys):
            return True
        sess_user = request.session.get("user_id") if request.session else None
        return sess_user == owner

    def _project(j: dict) -> dict:
        """The compact listing view /jobs and /jobs/debug share."""
        return {
            "id": j["id"],
            "status": j["status"],
            "progress": j["progress"],
            "created_at": j["created_at"],
            "updated_at": j["updated_at"],
        }

    @bp.route("/health")
    def health(request: Request):
        return {
            "status": "healthy",
            "timestamp": datetime.now().isoformat(),
            "active_jobs": engine.active_count(),
        }

    @bp.route("/process", methods=("POST",))
    def process(request: Request):
        data = request.get_json()
        if not data:
            return {"success": False, "error": "Invalid request body"}, 400
        file_id, file_ids = data.get("file_id"), data.get("file_ids")
        if file_ids is not None:
            # a backlog: several recordings as one job, written up together
            if file_id is not None or data.get("attachment_file_ids"):
                return {"success": False, "error": "file_ids goes without file_id "
                        "and attachment_file_ids"}, 400
            if (not isinstance(file_ids, list) or not file_ids
                    or not all(isinstance(x, str) and x for x in file_ids)):
                return {"success": False,
                        "error": "file_ids must be a non-empty list of strings"}, 400
            if len(file_ids) > MAX_BACKLOG:
                return {"success": False,
                        "error": f"at most {MAX_BACKLOG} file_ids a job"}, 400
            job_id = str(uuid.uuid4())
            user_id = request.session.get("user_id") if request.session else None
            job_data = engine.create_job(job_id, file_ids=file_ids, user_id=user_id)
            services.submit_backlog_job(job_id, file_ids, user_id)
            return {
                "success": True,
                "message": "Job submitted; processing in background",
                "job_id": job_id,
                "job_status": job_data["status"],
            }
        if not file_id:
            return {"success": False, "error": "Missing file_id parameter"}, 400
        if not isinstance(file_id, str):
            return {"success": False, "error": "file_id must be a string"}, 400
        attachment_file_ids = data.get("attachment_file_ids")
        if attachment_file_ids is not None:
            if not isinstance(attachment_file_ids, list):
                return {"success": False, "error": "attachment_file_ids must be a list"}, 400
            if not all(isinstance(x, str) for x in attachment_file_ids):
                return {
                    "success": False,
                    "error": "All items in attachment_file_ids must be strings",
                }, 400
            if not attachment_file_ids:
                attachment_file_ids = None

        job_id = str(uuid.uuid4())
        user_id = request.session.get("user_id") if request.session else None
        job_data = engine.create_job(
            job_id,
            file_id=file_id,
            attachment_file_ids=attachment_file_ids,
            user_id=user_id,
        )
        services.submit_processing_job(job_id, file_id, attachment_file_ids, user_id)
        return {
            "success": True,
            "message": "Job submitted; processing in background",
            "job_id": job_id,
            "job_status": job_data["status"],
        }

    @bp.route("/job/<job_id>")
    def job_status(request: Request, job_id: str):
        status = engine.get_job_status(job_id)
        if not _job_visible(request, status):
            # 404 for both missing and foreign jobs: existence is private
            return {"success": False, "error": f"Job {job_id} not found"}, 404
        return {"success": True, "job": status}

    @bp.route("/jobs")
    def jobs(request: Request):
        filter_status = request.query.get("filter", "active")
        if filter_status not in ("active", "all", "completed", "failed", "cancelled"):
            return {
                "success": False,
                "error": "Invalid filter parameter. Use 'active', 'all', 'completed', 'failed', or 'cancelled'",
            }, 400
        listed = engine.list_jobs(filter_status)
        jobs_map = {
            j["id"]: _project(j)
            for j in listed
            if _job_visible(request, j)
        }
        return {
            "success": True,
            "active_jobs": jobs_map,
            "count": len(jobs_map),
            "timestamp": datetime.now().isoformat(),
        }

    @bp.route("/drive/files")
    def drive_files(request: Request):
        if not (request.session and request.session.get("authenticated")):
            return {"success": False, "error": "Not authenticated"}, 401
        drive = services.drive_for(request.session.get("user_id"))
        if drive is None:
            return {"success": False, "error": "OAuth not completed; please log in"}, 401
        try:
            files = _list_drive_files(request, drive)
        except Exception as exc:  # noqa: BLE001 — external API boundary
            logger.exception("drive listing failed")
            return {"success": False, "error": f"Failed to list files: {exc}"}, 500
        return {"success": True, "files": files}

    @bp.route("/job/<job_id>/cancel", methods=("POST",))
    def cancel(request: Request, job_id: str):
        if not _job_visible(request, engine.get_job_status(job_id)):
            return {"success": False, "error": "Job not found"}, 404
        result = engine.cancel_job(job_id)
        if not result.get("success"):
            return result, 400
        return result

    @bp.route("/jobs/status/batch", methods=("POST",))
    def batch_status(request: Request):
        data = request.get_json()
        if not data or "job_ids" not in data:
            return {"success": False, "error": "Missing job_ids parameter"}, 400
        job_ids = data["job_ids"]
        if not isinstance(job_ids, list):
            return {"success": False, "error": "job_ids must be an array"}, 400
        if not all(isinstance(j, str) for j in job_ids):
            return {
                "success": False,
                "error": "All items in job_ids must be strings",
            }, 400
        statuses = {}
        for jid in job_ids:
            st = engine.get_job_status(jid)
            if st is not None and _job_visible(request, st):
                statuses[jid] = st
        return {"success": True, "jobs": statuses}

    @bp.route("/jobs/<job_id>/result")
    def job_result(request: Request, job_id: str):
        status = engine.get_job_status(job_id)
        if not _job_visible(request, status):
            return {"success": False, "error": f"Job {job_id} not found"}, 404
        if status.get("status") != "completed":
            return {"success": False, "error": "Job not completed yet"}, 400
        return {"success": True, "result": status.get("result", {})}

    @bp.route("/job/<job_id>/events")
    def job_events(request: Request, job_id: str):
        """Server-sent events: push status updates instead of 3 s polling
        (the frontend still supports polling as the fallback transport)."""
        import json as _json
        import time as _time

        from .web import StreamingResponse

        if not _job_visible(request, engine.get_job_status(job_id)):
            return {"success": False, "error": "Job not found"}, 404
        sse_max = int(os.environ.get("APTPU_SSE_MAX_SUBSCRIBERS", "8"))
        with _sse_lock:
            if _sse_slots["active"] >= sse_max:
                return (
                    {"success": False, "error": "Too many event streams; use polling"},
                    503,
                )
            _sse_slots["active"] += 1

        def release():
            # via on_close, NOT a finally inside stream(): a generator
            # close()d before its first iteration skips its finally, which
            # would leak the slot permanently
            with _sse_lock:
                _sse_slots["active"] -= 1

        def stream():
            last = None
            deadline = _time.time() + 1800
            while _time.time() < deadline:
                status = engine.get_job_status(job_id)
                if status is None:
                    break
                snapshot = (status["status"], status["progress"], status.get("message"))
                if snapshot != last:
                    last = snapshot
                    yield f"data: {_json.dumps(status)}\n\n"
                if status["status"] in ("completed", "failed", "cancelled"):
                    break
                _time.sleep(0.5)
            yield "event: end\ndata: {}\n\n"

        return StreamingResponse(stream(), on_close=release)

    @bp.route("/metrics")
    def metrics(request: Request):
        """JSON by default; ?format=prometheus returns the text exposition
        format so a Prometheus scraper can point straight at the service."""
        m = engine.metrics()
        from .openai_api import dynamic_batch_stats, wait_stats

        batch_stats = dynamic_batch_stats()
        if batch_stats["batches"]:
            m["v1_dynamic_batching"] = batch_stats
        waits = m["v1_waits"] = wait_stats()
        if request.query.get("format") != "prometheus":
            return {"success": True, "metrics": m}
        lines = [
            "# HELP aptpu_jobs_total Jobs known to the store",
            "# TYPE aptpu_jobs_total gauge",
            f"aptpu_jobs_total {m['jobs_total']}",
            "# HELP aptpu_jobs Jobs by status",
            "# TYPE aptpu_jobs gauge",
        ]
        for status, n in sorted(m.get("jobs_by_status", {}).items()):
            lines.append(f'aptpu_jobs{{status="{status}"}} {n}')
        if "rtf_x" in m:
            lines += [
                "# HELP aptpu_audio_seconds_total Audio seconds of the completed jobs",
                "# TYPE aptpu_audio_seconds_total counter",
                f"aptpu_audio_seconds_total {m['audio_seconds_total']}",
                "# HELP aptpu_processing_seconds_total Wall seconds of the completed jobs",
                "# TYPE aptpu_processing_seconds_total counter",
                f"aptpu_processing_seconds_total {m['processing_seconds_total']}",
                "# HELP aptpu_rtf_x Audio seconds over processing seconds, completed jobs",
                "# TYPE aptpu_rtf_x gauge",
                f"aptpu_rtf_x {m['rtf_x']}",
            ]
        if batch_stats["batches"]:
            lines += [
                "# HELP aptpu_v1_dynamic_batches_total Dynamic batches dispatched on /v1",
                "# TYPE aptpu_v1_dynamic_batches_total counter",
                f"aptpu_v1_dynamic_batches_total {batch_stats['batches']}",
                "# TYPE aptpu_v1_dynamic_batch_files_total counter",
                f"aptpu_v1_dynamic_batch_files_total {batch_stats['files']}",
            ]
        lines += [
            "# HELP aptpu_v1_queue_wait_seconds /v1 uploads' wait in a batch window or for "
            "its result",
            "# TYPE aptpu_v1_queue_wait_seconds summary",
            f"aptpu_v1_queue_wait_seconds_sum {waits['queue_wait_seconds_sum']}",
            f"aptpu_v1_queue_wait_seconds_count {waits['queue_wait_count']}",
            "# HELP aptpu_v1_slot_wait_seconds /v1 decodes' wait for a decode slot",
            "# TYPE aptpu_v1_slot_wait_seconds summary",
            f"aptpu_v1_slot_wait_seconds_sum {waits['slot_wait_seconds_sum']}",
            f"aptpu_v1_slot_wait_seconds_count {waits['slot_wait_count']}",
            "# HELP aptpu_v1_decode_slots_in_use /v1 decode slots held now",
            "# TYPE aptpu_v1_decode_slots_in_use gauge",
            f"aptpu_v1_decode_slots_in_use {waits['decode_slots_in_use']}",
        ]
        if "stage_seconds_mean" in m:
            lines += [
                "# HELP aptpu_stage_seconds_mean Mean wall seconds per pipeline stage",
                "# TYPE aptpu_stage_seconds_mean gauge",
            ]
            for stage, secs in sorted(m["stage_seconds_mean"].items()):
                lines.append(
                    f'aptpu_stage_seconds_mean{{stage="{stage}"}} {secs}'
                )
        return Response(
            "\n".join(lines) + "\n",
            content_type="text/plain; version=0.0.4; charset=utf-8",
        )

    @bp.route("/jobs/debug")
    def jobs_debug(request: Request):
        listed = engine.list_jobs("all")
        jobs_info = {
            j["id"]: {k: v for k, v in _project(j).items() if k != "id"}
            for j in listed
            if _job_visible(request, j)
        }
        return {"success": True, "total_jobs": len(jobs_info), "jobs": jobs_info}

    return bp


def _list_drive_files(request: Request, drive) -> list[dict]:
    """Audio + PDF listing with optional folder filters, deduped by id
    (reference behaviour: api_routes.py:187-284)."""
    recordings_folder = request.query.get("recordingsFolderName")
    pdf_folder = request.query.get("pdfFolderName")
    rec_filter = request.query.get("recordingsFilter") == "enabled"
    pdf_filter = request.query.get("pdfFilter") == "enabled"

    def fetch(base_query: str, filter_on: bool, folder_name: str | None):
        if not filter_on:
            return drive.list_files(query=base_query)
        if not folder_name:
            return []
        folder_id = drive.find_folder_id_by_path(folder_name)
        if not folder_id:
            return []
        return drive.list_files(query=f"{base_query} and '{folder_id}' in parents")

    audio = fetch(
        "trashed = false and mimeType contains 'audio/'", rec_filter, recordings_folder
    )
    pdfs = fetch(
        "trashed = false and mimeType = 'application/pdf'", pdf_filter, pdf_folder
    )

    merged: dict[str, dict] = {}
    for f in list(audio) + list(pdfs):
        if f.get("id"):
            merged[f["id"]] = f

    out = []
    for fid, f in merged.items():
        size = f.get("size", 0)
        try:
            size = int(size)
        except (TypeError, ValueError):
            size = 0
        out.append(
            {
                "id": fid,
                "name": f.get("name", "Untitled"),
                "mimeType": f.get("mimeType", "application/octet-stream"),
                "size": size,
                "parents": f.get("parents", []),
            }
        )
    return out
