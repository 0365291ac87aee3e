"""Persistent job store: the state behind the async job API.

The reference keeps jobs in a per-process dict guarded by one lock, which
gunicorn's 2 workers each get a private copy of — submitting to worker A
makes the job invisible to worker B (latent defect; reference:
app/services/audio_processor.py:60 x Dockerfile:44, SURVEY.md appendix).

Here the store is an interface with three backends:
  * SqliteJobStore — WAL-mode sqlite, safe across threads AND processes,
    jobs survive restarts (SURVEY.md §5.4 rebuild note);
  * RedisJobStore — for multi-host serving, matching the reference's
    Redis-centric deployment (docker-compose.yml:2-9; the reference only
    kept CREDENTIALS there, never jobs);
  * MemoryJobStore — dict + lock for tests and single-process runs.

Status vocabulary and payload shapes mirror the reference's job records
(audio_processor.py:1150-1167, 1459-1491) so the JSON API is byte-
compatible.

A copy of the JAX package's ``runtime/job_store.py``: the PyTorch package
imports nothing of that package.
"""
from __future__ import annotations

import json
import sqlite3
import threading
import time
from ..utils.constants import JOB_STATUS

ACTIVE_STATUSES = (
    JOB_STATUS["QUEUED"],
    JOB_STATUS["PENDING"],
    JOB_STATUS["PROCESSING"],
)
TERMINAL_STATUSES = (
    JOB_STATUS["COMPLETED"],
    JOB_STATUS["FAILED"],
    JOB_STATUS["CANCELLED"],
)


def _now() -> float:
    return time.time()


class MemoryJobStore:
    """In-memory backend (tests / single process)."""

    def __init__(self):
        self._jobs: dict[str, dict] = {}
        self._cancel: set[str] = set()
        self._lock = threading.Lock()

    def create(self, job_id: str, record: dict) -> None:
        with self._lock:
            self._jobs[job_id] = dict(record)

    def get(self, job_id: str) -> dict | None:
        with self._lock:
            rec = self._jobs.get(job_id)
            return dict(rec) if rec else None

    def update(self, job_id: str, **fields) -> None:
        with self._lock:
            if job_id in self._jobs:
                self._jobs[job_id].update(fields)

    def list(self) -> list[dict]:
        with self._lock:
            return [dict(r) for r in self._jobs.values()]

    def request_cancel(self, job_id: str) -> None:
        with self._lock:
            self._cancel.add(job_id)

    def is_cancel_requested(self, job_id: str) -> bool:
        with self._lock:
            return job_id in self._cancel

    def clear_cancel(self, job_id: str) -> None:
        with self._lock:
            self._cancel.discard(job_id)

    def delete(self, job_id: str) -> None:
        with self._lock:
            self._jobs.pop(job_id, None)
            self._cancel.discard(job_id)


class SqliteJobStore:
    """Cross-process job store on sqlite (WAL).  One connection per thread."""

    _SCHEMA = """
    CREATE TABLE IF NOT EXISTS jobs (
        job_id TEXT PRIMARY KEY,
        record TEXT NOT NULL,
        status TEXT NOT NULL,
        created_at REAL NOT NULL,
        cancel_requested INTEGER NOT NULL DEFAULT 0
    );
    """

    def __init__(self, path: str):
        self.path = path
        self._local = threading.local()
        with self._conn() as c:
            c.executescript(self._SCHEMA)
            c.execute("PRAGMA journal_mode=WAL")

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.path, timeout=30.0)
            conn.isolation_level = None  # autocommit; explicit txns below
            self._local.conn = conn
        return conn

    def create(self, job_id: str, record: dict) -> None:
        self._conn().execute(
            "INSERT OR REPLACE INTO jobs (job_id, record, status, created_at,"
            " cancel_requested) VALUES (?,?,?,?,0)",
            (job_id, json.dumps(record), record.get("status", ""), _now()),
        )

    def get(self, job_id: str) -> dict | None:
        row = self._conn().execute(
            "SELECT record FROM jobs WHERE job_id=?", (job_id,)
        ).fetchone()
        return json.loads(row[0]) if row else None

    def update(self, job_id: str, **fields) -> None:
        conn = self._conn()
        conn.execute("BEGIN IMMEDIATE")
        try:
            row = conn.execute(
                "SELECT record FROM jobs WHERE job_id=?", (job_id,)
            ).fetchone()
            if row:
                rec = json.loads(row[0])
                rec.update(fields)
                conn.execute(
                    "UPDATE jobs SET record=?, status=? WHERE job_id=?",
                    (json.dumps(rec), rec.get("status", ""), job_id),
                )
            conn.execute("COMMIT")
        except BaseException:
            conn.execute("ROLLBACK")
            raise

    def list(self) -> list[dict]:
        rows = self._conn().execute(
            "SELECT record FROM jobs ORDER BY created_at"
        ).fetchall()
        return [json.loads(r[0]) for r in rows]

    def request_cancel(self, job_id: str) -> None:
        self._conn().execute(
            "UPDATE jobs SET cancel_requested=1 WHERE job_id=?", (job_id,)
        )

    def is_cancel_requested(self, job_id: str) -> bool:
        row = self._conn().execute(
            "SELECT cancel_requested FROM jobs WHERE job_id=?", (job_id,)
        ).fetchone()
        return bool(row and row[0])

    def clear_cancel(self, job_id: str) -> None:
        self._conn().execute(
            "UPDATE jobs SET cancel_requested=0 WHERE job_id=?", (job_id,)
        )

    def delete(self, job_id: str) -> None:
        self._conn().execute("DELETE FROM jobs WHERE job_id=?", (job_id,))


class RedisJobStore:
    """Cross-HOST job store on Redis (the reference deployment's store,
    which it used only for credentials — jobs lived in process memory and
    died with the container).

    Layout: `aptpu:job:{id}` JSON record, `aptpu:cancel:{id}` flag,
    `aptpu:jobs` sorted set (score = created_at) for ordered listing.
    update() is a WATCH/MULTI read-merge-write transaction so concurrent
    workers can't lose fields.

    A pre-built client can be injected (tests use an in-repo fake; this
    image ships no redis daemon or redis-py).
    """

    PREFIX = "aptpu"

    def __init__(self, url: str | None = None, client=None):
        if client is None:
            import redis  # lazy: optional dependency

            client = redis.Redis.from_url(
                url or "redis://localhost:6379/0", decode_responses=True
            )
            client.ping()
        self.client = client

    def _key(self, job_id: str) -> str:
        return f"{self.PREFIX}:job:{job_id}"

    def _cancel_key(self, job_id: str) -> str:
        return f"{self.PREFIX}:cancel:{job_id}"

    @property
    def _index(self) -> str:
        return f"{self.PREFIX}:jobs"

    def create(self, job_id: str, record: dict) -> None:
        self.client.set(self._key(job_id), json.dumps(record))
        self.client.zadd(self._index, {job_id: _now()})

    def get(self, job_id: str) -> dict | None:
        raw = self.client.get(self._key(job_id))
        return json.loads(raw) if raw else None

    def update(self, job_id: str, **fields) -> None:
        key = self._key(job_id)
        with self.client.pipeline() as pipe:
            while True:
                try:
                    pipe.watch(key)
                    raw = pipe.get(key)
                    if raw is None:
                        pipe.unwatch()
                        return
                    rec = json.loads(raw)
                    rec.update(fields)
                    pipe.multi()
                    pipe.set(key, json.dumps(rec))
                    pipe.execute()
                    return
                except Exception as exc:  # noqa: BLE001 — retry only on WatchError
                    if type(exc).__name__ != "WatchError":
                        raise

    def list(self) -> list[dict]:
        ids = self.client.zrange(self._index, 0, -1)
        if not ids:
            return []
        # one MGET, not one GET per job: list() backs the hot /api/health
        # and /api/jobs paths, and N sequential round trips at ~1 ms RTT
        # is hundreds of ms per probe at a few hundred retained jobs
        raws = self.client.mget([self._key(i) for i in ids])
        return [json.loads(raw) for raw in raws if raw]

    def request_cancel(self, job_id: str) -> None:
        self.client.set(self._cancel_key(job_id), "1")

    def is_cancel_requested(self, job_id: str) -> bool:
        return bool(self.client.get(self._cancel_key(job_id)))

    def clear_cancel(self, job_id: str) -> None:
        self.client.delete(self._cancel_key(job_id))

    def delete(self, job_id: str) -> None:
        self.client.delete(self._key(job_id), self._cancel_key(job_id))
        self.client.zrem(self._index, job_id)


def make_store(url: str | None = None):
    """'memory://', 'sqlite:///path.db', 'redis://host:port/db', or None."""
    if not url or url == "memory://":
        return MemoryJobStore()
    if url.startswith("sqlite://"):
        # sqlite:///abs/path keeps the leading slash; sqlite://rel.db is relative
        return SqliteJobStore(url[len("sqlite://"):] or "jobs.db")
    if url.startswith("redis://") or url.startswith("rediss://"):
        return RedisJobStore(url)
    raise ValueError(f"unknown job store url {url!r}")
