"""Async job engine: lifecycle, worker pool, progress, cooperative cancel.

Rebuild of the reference's job machinery (reference:
app/services/audio_processor.py:49-69, 1150-1526) on top of a pluggable
persistent store (runtime/job_store.py) so any number of API workers see
one queue.  Same observable semantics:

  * lifecycle pending -> processing -> completed/failed/cancelled with the
    reference's progress checkpoints (utils/constants.py PROGRESS);
  * cooperative cancellation checked between stages (the
    _is_job_cancelled pattern, audio_processor.py:1195,1224,...);
  * failed jobs salvage partial results into the error record
    (audio_processor.py:1360-1374);
  * graceful executor shutdown on exit (audio_processor.py:1517-1526).

A copy of the JAX package's ``runtime/job_engine.py``: the PyTorch package
imports nothing of that package.
"""
from __future__ import annotations

import atexit
import logging
import os
import socket
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime, timezone
from typing import Any, Callable

from ..utils.constants import JOB_STATUS, STAGES
from . import trace
from .job_store import ACTIVE_STATUSES, make_store

logger = logging.getLogger(__name__)


class JobCancelled(Exception):
    """Raised inside a stage when cancellation was requested."""


def _utcnow() -> str:
    return datetime.now(timezone.utc).isoformat()


def _worker_id() -> str:
    """Stable owner tag for job records: which process runs the job."""
    return f"{socket.gethostname()}:{os.getpid()}"


def _worker_is_alive(worker: str) -> bool:
    """Best-effort liveness of a job's owning process.

    Another HOST's workers can't be probed by pid — the HEARTBEAT check in
    recover_orphans covers them (a container recreate gets a NEW hostname,
    so "hosts recover their own orphans at startup" never fires for the
    dead name; without the staleness sweep such jobs would stay
    'processing' forever).  On this host, a dead pid means the job is
    orphaned.  (A recycled pid can false-positive; the cost is only a
    delayed orphan sweep.)
    """
    host, _, pid_s = worker.rpartition(":")
    if host != socket.gethostname():
        return True
    try:
        pid = int(pid_s)
    except ValueError:
        return False
    if pid == os.getpid():
        return True
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


class JobContext:
    """Handle given to pipeline stages: progress reporting + cancel checks.

    Each ``stage()`` closes the span of the stage before it and opens
    ``job.<stage>`` (``utils/constants.py`` STAGES) in the job's trace
    (``runtime/trace.py``), so the Transcriber's and the Diarizer's spans
    nest under the stage that runs them."""

    def __init__(self, engine: "JobEngine", job_id: str):
        self.engine = engine
        self.job_id = job_id
        self.partial: dict[str, Any] = {}  # salvaged into failure results
        self._stage = None  # the open stage's span

    def progress(self, value: int, message: str = "") -> None:
        self.engine.update_progress(self.job_id, value, message)

    def check_cancelled(self) -> None:
        if self.engine.store.is_cancel_requested(self.job_id):
            raise JobCancelled(self.job_id)

    def stage(self, value: int, message: str = "", progress: int | None = None) -> None:
        """Cancel checkpoint + progress update + the stage's span.

        ``value`` is the stage's checkpoint (``PROGRESS``); ``progress``,
        where given, is reported in its place (a stage of one meeting of
        a backlog job reports its share of the backlog's range).
        Per-stage wall times land in the job record as `stage_timings`
        (SURVEY.md §5.1: the reference has no tracing at all; its only
        observability is the progress int itself)."""
        self.check_cancelled()
        self.end_stage()
        self._stage = trace.span("job." + STAGES.get(value, f"progress_{value}"))
        self._stage.__enter__()
        self.progress(value if progress is None else progress, message)

    def end_stage(self) -> None:
        """Close the open stage's span, if any."""
        if self._stage is not None:
            self._stage.__exit__(None, None, None)
            self._stage = None

    def stage_timings(self) -> dict[str, float]:
        """Seconds of each stage (``job.<stage>``), from the job's
        trace, in the order the stages ran."""
        rec = trace.current()
        if rec is None:
            return {}
        return {name: round(s["total_s"], 3) for name, s in rec.summary()["spans"].items()
                if name.startswith("job.")}


class JobEngine:
    def __init__(
        self,
        max_workers: int = 3,
        store_url: str | None = None,
        store=None,
    ):
        self.store = store if store is not None else make_store(store_url)
        self.max_workers = max_workers
        self.executor = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="job-worker"
        )
        self._futures: dict[str, Any] = {}
        self._futures_lock = threading.Lock()
        self._shutdown = False
        self._heartbeat_thread: threading.Thread | None = None
        atexit.register(self.shutdown)

    # -- lifecycle ----------------------------------------------------------

    def create_job(self, job_id: str, **info) -> dict:
        # field names match the reference's job records exactly
        # (audio_processor.py:1150-1161): 'id', 'status', 'progress',
        # 'message', 'created_at', 'updated_at'
        record = {
            "id": job_id,
            "status": JOB_STATUS["PENDING"],
            "progress": 0,
            "message": "Job created, waiting to process",
            "created_at": _utcnow(),
            "updated_at": _utcnow(),
            "result": None,
            "error": None,
            # owner tag: startup orphan recovery must not fail jobs that a
            # LIVE sibling worker / another host is still running
            "worker": _worker_id(),
            # stamped by the owner's heartbeat thread while in flight —
            # cross-host orphan recovery keys off its staleness
            "heartbeat_at": _utcnow(),
            **info,
        }
        self.store.create(job_id, record)
        return record

    def submit(
        self,
        job_id: str,
        fn: Callable[[JobContext], dict],
        failure_result: Callable[[Exception, dict], dict] | None = None,
    ) -> None:
        """Run fn(ctx) on the pool; fn returns the result dict.

        failure_result(exc, ctx.partial) builds a salvage result attached
        to failed jobs (the reference's partial-result behaviour,
        audio_processor.py:1360-1374).
        """
        if self._shutdown:
            raise RuntimeError("engine is shut down")
        with self._futures_lock:
            saturated = len(self._futures) >= self.max_workers
        if saturated:
            # every worker slot is occupied: this job WAITS — surface that
            # as 'queued' (the constants vocabulary the reference defines
            # but never uses); _run_job flips it to 'processing' on pickup
            self.store.update(
                job_id,
                status=JOB_STATUS["QUEUED"],
                message="Queued; waiting for a worker",
                updated_at=_utcnow(),
            )
        future = self.executor.submit(self._run_job, job_id, fn, failure_result)
        with self._futures_lock:
            self._futures[job_id] = future
        # the done callback is the authoritative cleanup: it fires for
        # cancelled futures (whose _run_job never executes) and closes the
        # submit/finish race (a fast job can complete before the insert
        # above — the callback then runs immediately in this thread)
        future.add_done_callback(
            lambda _f, jid=job_id: self._drop_future(jid)
        )
        self._ensure_heartbeat()

    def _drop_future(self, job_id: str) -> None:
        with self._futures_lock:
            self._futures.pop(job_id, None)

    # heartbeat cadence / cross-host staleness threshold (seconds)
    HEARTBEAT_S = float(os.environ.get("APTPU_HEARTBEAT_S", "30"))
    ORPHAN_STALE_S = float(os.environ.get("APTPU_ORPHAN_STALE_S", "900"))

    def _ensure_heartbeat(self) -> None:
        """Start the owner heartbeat thread on first submit.

        While this process has in-flight jobs, their records get a fresh
        heartbeat_at every HEARTBEAT_S — the signal recover_orphans on a
        DIFFERENT host (new container hostname) uses to tell a live
        long-running job from one whose owner died."""
        if self._heartbeat_thread is not None and self._heartbeat_thread.is_alive():
            return
        t = threading.Thread(
            target=self._heartbeat_loop, name="job-heartbeat", daemon=True
        )
        self._heartbeat_thread = t
        t.start()

    def _heartbeat_loop(self) -> None:
        while not self._shutdown:
            time.sleep(self.HEARTBEAT_S)
            with self._futures_lock:
                job_ids = list(self._futures)
            for job_id in job_ids:
                try:
                    self.store.update(job_id, heartbeat_at=_utcnow())
                except Exception:  # noqa: BLE001 — heartbeat must not die
                    logger.debug("heartbeat update failed for %s", job_id)

    def _run_job(
        self,
        job_id: str,
        fn: Callable[[JobContext], dict],
        failure_result: Callable[[Exception, dict], dict] | None = None,
    ) -> None:
        with trace.request(job_id):
            ctx = JobContext(self, job_id)
            try:
                if self.store.is_cancel_requested(job_id):
                    raise JobCancelled(job_id)
                self.store.update(
                    job_id,
                    status=JOB_STATUS["PROCESSING"],
                    message="Processing started",
                    updated_at=_utcnow(),
                )
                with trace.span("job"):
                    try:
                        result = fn(ctx)
                    finally:
                        ctx.end_stage()
                self.store.update(
                    job_id,
                    status=JOB_STATUS["COMPLETED"],
                    progress=100,
                    message="Completed",
                    result=result,
                    stage_timings=ctx.stage_timings(),
                    completed_at=_utcnow(),
                    updated_at=_utcnow(),
                )
            except JobCancelled:
                logger.info("job %s cancelled", job_id)
                self.store.update(
                    job_id,
                    status=JOB_STATUS["CANCELLED"],
                    message="Job cancelled by user",
                    cancelled_at=_utcnow(),
                    updated_at=_utcnow(),
                )
            except Exception as exc:  # noqa: BLE001 — job boundary
                logger.error("job %s failed: %s\n%s", job_id, exc, traceback.format_exc())
                fields: dict[str, Any] = {
                    "status": JOB_STATUS["FAILED"],
                    "message": f"Processing failed: {exc}",
                    "error": str(exc),
                    "completed_at": _utcnow(),
                    "updated_at": _utcnow(),
                }
                if ctx.partial:  # salvage partial results (audio_processor.py:1360-1374)
                    fields["partial_result"] = dict(ctx.partial)
                if failure_result is not None:
                    try:
                        fields["result"] = failure_result(exc, dict(ctx.partial))
                    except Exception:  # noqa: BLE001 — salvage must not mask the error
                        logger.exception("failure_result callback raised")
                self.store.update(job_id, **fields)
            finally:
                self.store.clear_cancel(job_id)
                with self._futures_lock:
                    self._futures.pop(job_id, None)

    def recover_orphans(self) -> int:
        """Mark jobs left 'processing'/'pending' by a dead process as failed.

        Call at startup with a persistent store.  The reference simply
        forgets all jobs on restart (in-memory dict, SURVEY.md §5.3/§5.4);
        here they survive and get a terminal state instead of spinning
        forever in the UI.  Jobs whose owning process is still ALIVE (a
        sibling worker on this host, or any other host sharing the store)
        are left untouched — only verifiably dead owners are swept.
        """
        n = 0
        now = time.time()
        for rec in self.store.list():
            if rec.get("status") in ACTIVE_STATUSES:
                worker = rec.get("worker")
                if worker and _worker_is_alive(worker):
                    # pid-alive is definitive only on THIS host; a foreign
                    # hostname (e.g. the dead pre-recreate container, which
                    # never comes back under its old name) is judged by
                    # heartbeat staleness instead
                    host = worker.rpartition(":")[0]
                    if host == socket.gethostname():
                        continue
                    stamp = (
                        rec.get("heartbeat_at")
                        or rec.get("updated_at")
                        or rec.get("created_at")
                    )
                    try:
                        age = now - datetime.fromisoformat(stamp).timestamp()
                    except (TypeError, ValueError):
                        # unknown age: conservatively assume the foreign
                        # owner is alive rather than fail its job
                        age = 0.0
                    if age < self.ORPHAN_STALE_S:
                        continue
                self.store.update(
                    rec["id"],
                    status=JOB_STATUS["FAILED"],
                    message="Orphaned by restart",
                    error="Server restarted while the job was in flight",
                    updated_at=_utcnow(),
                )
                n += 1
        if n:
            logger.info("recovered %d orphaned jobs", n)
        return n

    # -- observation --------------------------------------------------------

    def update_progress(self, job_id: str, progress: int, message: str = "") -> None:
        fields = {"progress": int(progress), "updated_at": _utcnow()}
        if message:
            fields["message"] = message
        self.store.update(job_id, **fields)

    def get_job_status(self, job_id: str) -> dict | None:
        """Status record with the reference's exact shape
        (audio_processor.py:1459-1491): base fields always, message if set,
        result iff completed, error iff failed."""
        rec = self.store.get(job_id)
        return self._status_view(rec)

    @staticmethod
    def _status_view(rec: dict | None) -> dict | None:
        """Shape one store record as the public status dict."""
        if rec is None:
            return None
        out = {
            "id": rec["id"],
            "status": rec["status"],
            "progress": rec.get("progress", 0),
            "created_at": rec.get("created_at"),
            "updated_at": rec.get("updated_at"),
        }
        if rec.get("message"):
            out["message"] = rec["message"]
        for k in ("file_name", "file_id", "user_id"):
            if rec.get(k) is not None:
                out[k] = rec[k]
        if rec["status"] == JOB_STATUS["COMPLETED"]:
            out["result"] = rec.get("result")
        elif rec["status"] == JOB_STATUS["FAILED"]:
            out["error"] = rec.get("error")
            if rec.get("partial_result"):
                out["partial_result"] = rec["partial_result"]
        return out

    def list_jobs(self, filter: str = "all") -> list[dict]:
        # store.list() already returns full records — re-fetching each id
        # through get_job_status doubled the store round trips (2N Redis
        # GETs per /api/health probe at N retained jobs)
        jobs = [self._status_view(r) for r in self.store.list()]
        jobs = [j for j in jobs if j]
        if filter == "active":
            jobs = [j for j in jobs if j["status"] in ACTIVE_STATUSES]
        elif filter in (
            JOB_STATUS["COMPLETED"],
            JOB_STATUS["FAILED"],
            JOB_STATUS["CANCELLED"],
        ):
            jobs = [j for j in jobs if j["status"] == filter]
        return jobs

    def active_count(self) -> int:
        """Active-job count for /api/health, cached briefly.

        Health is the hottest endpoint (LB probes every few seconds) and
        an exact count needs a full store scan; a 2 s-stale count is fine
        for a load-balancer signal."""
        now = time.monotonic()
        cached = getattr(self, "_active_cache", None)
        if cached is not None and now - cached[0] < self._METRICS_TTL_S:
            return cached[1]
        count = sum(
            1
            for rec in self.store.list()
            if rec.get("status") in ACTIVE_STATUSES
        )
        self._active_cache = (now, count)
        return count

    def prune_old_jobs(self, days: float = 30.0) -> int:
        """Delete TERMINAL jobs whose last update is older than ``days``.

        The reference never prunes server-side (its 30-day retention lives
        in the frontend's localStorage, static/js/app.js:42-164); without
        this the persistent store — and every store.list() consumer, e.g.
        a Prometheus scrape of /api/metrics — grows without bound.
        Returns the number of records deleted.
        """
        if days <= 0:
            return 0
        cutoff = time.time() - days * 86400.0
        removed = 0
        for rec in self.store.list():
            if rec.get("status") in ACTIVE_STATUSES:
                continue
            stamp = rec.get("updated_at") or rec.get("created_at")
            try:
                t = datetime.fromisoformat(stamp).timestamp()
            except (TypeError, ValueError):
                continue
            if t < cutoff:
                self.store.delete(rec["id"])
                removed += 1
        if removed:
            logger.info("pruned %d jobs older than %.0f days", removed, days)
        return removed

    # /api/metrics is a scrape target (docs advertise pointing Prometheus
    # at it): cache the aggregate briefly so a 15 s scrape cadence never
    # re-deserialises a large job history per request
    _METRICS_TTL_S = 2.0

    def metrics(self) -> dict:
        """Aggregate counters for the /api/metrics endpoint (SURVEY.md §5.5:
        the reference has no metrics system at all)."""
        now = time.monotonic()
        cached = getattr(self, "_metrics_cache", None)
        if cached is not None and now - cached[0] < self._METRICS_TTL_S:
            return self._copy_metrics(cached[1])
        records = self.store.list()
        by_status: dict[str, int] = {}
        audio_s = processing_s = 0.0
        stage_totals: dict[str, list[float]] = {}
        for rec in records:
            by_status[rec.get("status", "?")] = by_status.get(rec.get("status", "?"), 0) + 1
            result = rec.get("result") or {}
            if (rec.get("status") == JOB_STATUS["COMPLETED"] and isinstance(result, dict)
                    and result.get("processing_s")):
                audio_s += float(result.get("duration_s") or 0.0)
                processing_s += float(result["processing_s"])
            for name, secs in (rec.get("stage_timings") or {}).items():
                stage_totals.setdefault(name, []).append(float(secs))
        out: dict = {
            "jobs_total": len(records),
            "jobs_by_status": by_status,
        }
        if processing_s > 0:
            # a rate over the completed jobs: the ratio of the sums
            out["audio_seconds_total"] = round(audio_s, 3)
            out["processing_seconds_total"] = round(processing_s, 3)
            out["rtf_x"] = round(audio_s / processing_s, 2)
        if stage_totals:
            out["stage_seconds_mean"] = {
                k: round(sum(v) / len(v), 3) for k, v in stage_totals.items()
            }
        self._metrics_cache = (now, out)
        return self._copy_metrics(out)

    @staticmethod
    def _copy_metrics(m: dict) -> dict:
        """Callers annotate the returned dict (/api/metrics adds keys);
        handing out the cached object would let one request's additions
        poison the cache and race another thread's json.dumps."""
        return {k: (dict(v) if isinstance(v, dict) else v) for k, v in m.items()}

    # -- cancellation -------------------------------------------------------

    def cancel_job(self, job_id: str) -> dict:
        rec = self.store.get(job_id)
        if rec is None:
            return {"success": False, "error": "Job not found"}
        if rec["status"] not in ACTIVE_STATUSES:
            return {
                "success": False,
                "error": f"Job already {rec['status']}",
                "status": rec["status"],
            }
        self.store.request_cancel(job_id)
        if rec["status"] in (JOB_STATUS["PENDING"], JOB_STATUS["QUEUED"]):
            # not started yet: try to cancel the future and finalise now
            with self._futures_lock:
                fut = self._futures.get(job_id)
            if fut is not None and fut.cancel():
                self.store.update(
                    job_id,
                    status=JOB_STATUS["CANCELLED"],
                    message="Job cancelled by user",
                    cancelled_at=_utcnow(),
                    updated_at=_utcnow(),
                )
                self.store.clear_cancel(job_id)
        return {"success": True, "message": "Cancellation requested"}

    # -- shutdown -----------------------------------------------------------

    def shutdown(self, wait: bool = True) -> None:
        if self._shutdown:
            return
        self._shutdown = True
        logger.info("shutting down job executor")
        self.executor.shutdown(wait=wait, cancel_futures=True)
