"""Per-user OAuth credential persistence with TTL + auto-refresh.

Rebuild of the reference's Redis-backed CredentialManager (reference:
app/services/credential_manager.py:10-210): serialise OAuth credentials
under a per-user key with a 30-day TTL, rebuild live google-auth
Credentials (parsing expiry), auto-refresh when expired or within 5
minutes of expiry, plus delete and TTL-extension.  The backend is
pluggable — redis when available (matching the reference deployment),
sqlite for single-box installs, memory for tests — so serving never hard-
depends on a Redis daemon.

A copy of the JAX package's ``integrations/credentials.py``: the PyTorch package
imports nothing of that package.
"""
from __future__ import annotations

import json
import logging
import sqlite3
import threading
import time
from datetime import datetime, timedelta, timezone
from typing import Any

logger = logging.getLogger(__name__)

DEFAULT_TTL_S = 30 * 24 * 3600  # 30 days (reference: credential_manager.py:65-71)
REFRESH_MARGIN_S = 5 * 60  # refresh when <5 min left (reference :165-179)


class MemoryKV:
    def __init__(self):
        self._data: dict[str, tuple[str, float]] = {}
        self._lock = threading.Lock()

    def set(self, key: str, value: str, ttl_s: int) -> None:
        with self._lock:
            self._data[key] = (value, time.time() + ttl_s)

    def get(self, key: str) -> str | None:
        with self._lock:
            row = self._data.get(key)
            if row is None:
                return None
            value, expires = row
            if time.time() > expires:
                del self._data[key]
                return None
            return value

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)

    def expire(self, key: str, ttl_s: int) -> None:
        with self._lock:
            if key in self._data:
                self._data[key] = (self._data[key][0], time.time() + ttl_s)


class SqliteKV:
    def __init__(self, path: str):
        self.path = path
        self._local = threading.local()
        self._conn().execute(
            "CREATE TABLE IF NOT EXISTS kv (key TEXT PRIMARY KEY, value TEXT, expires_at REAL)"
        )

    def _conn(self):
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.path, timeout=30.0)
            conn.isolation_level = None
            self._local.conn = conn
        return conn

    def set(self, key, value, ttl_s):
        self._conn().execute(
            "INSERT OR REPLACE INTO kv VALUES (?,?,?)", (key, value, time.time() + ttl_s)
        )

    def get(self, key):
        row = self._conn().execute(
            "SELECT value, expires_at FROM kv WHERE key=?", (key,)
        ).fetchone()
        if row is None:
            return None
        if time.time() > row[1]:
            self.delete(key)
            return None
        return row[0]

    def delete(self, key):
        self._conn().execute("DELETE FROM kv WHERE key=?", (key,))

    def expire(self, key, ttl_s):
        self._conn().execute(
            "UPDATE kv SET expires_at=? WHERE key=?", (time.time() + ttl_s, key)
        )


class RedisKV:
    def __init__(
        self, host: str, port: int, db: int, password: str | None = None
    ):
        import redis

        self.client = redis.Redis(
            host=host, port=port, db=db, password=password,
            decode_responses=True,
        )
        self.client.ping()

    def set(self, key, value, ttl_s):
        self.client.setex(key, ttl_s, value)

    def get(self, key):
        return self.client.get(key)

    def delete(self, key):
        self.client.delete(key)

    def expire(self, key, ttl_s):
        self.client.expire(key, ttl_s)


def make_kv(url: str | None = None):
    """'redis://host:port/db', 'sqlite:///path', 'memory://', or None ->
    redis if importable+reachable else sqlite file, mirroring the reference
    deployment without hard-requiring a Redis daemon."""
    import os

    if url is None:
        url = os.environ.get("CREDENTIAL_STORE_URL")
    if url:
        if url.startswith("memory"):
            return MemoryKV()
        if url.startswith("sqlite://"):
            return SqliteKV(url[len("sqlite://"):] or "credentials.db")
        if url.startswith("redis://"):
            # urlsplit handles the standard auth form
            # redis://[:password@]host[:port][/db] — the old manual
            # partition crashed on '@' (int('secret@host:6379'))
            from urllib.parse import urlsplit

            parts = urlsplit(url)
            db_s = parts.path.lstrip("/")
            return RedisKV(
                parts.hostname or "localhost",
                parts.port or 6379,
                int(db_s or 0),
                password=parts.password,
            )
        raise ValueError(f"unknown credential store url {url!r}")
    try:
        return RedisKV(
            os.environ.get("REDIS_HOST", "localhost"),
            int(os.environ.get("REDIS_PORT", 6379)),
            int(os.environ.get("REDIS_DB", 0)),
        )
    except Exception:
        return SqliteKV(os.environ.get("CREDENTIAL_DB_PATH", "credentials.db"))


class CredentialStore:
    KEY_PREFIX = "oauth_credentials:"

    def __init__(self, kv=None, ttl_s: int = DEFAULT_TTL_S):
        self.kv = kv if kv is not None else make_kv()
        self.ttl_s = ttl_s

    def _key(self, user_id: str) -> str:
        return f"{self.KEY_PREFIX}{user_id}"

    # -- save / load --------------------------------------------------------

    def save_credentials(self, user_id: str, creds: Any) -> None:
        """Accepts a google-auth Credentials object or a plain dict."""
        if isinstance(creds, dict):
            data = dict(creds)
        else:
            data = {
                "token": creds.token,
                "refresh_token": getattr(creds, "refresh_token", None),
                "token_uri": getattr(creds, "token_uri", None),
                "client_id": getattr(creds, "client_id", None),
                "client_secret": getattr(creds, "client_secret", None),
                "scopes": list(getattr(creds, "scopes", []) or []),
                "expiry": creds.expiry.isoformat() if getattr(creds, "expiry", None) else None,
            }
        self.kv.set(self._key(user_id), json.dumps(data), self.ttl_s)

    def load_credentials_dict(self, user_id: str) -> dict | None:
        raw = self.kv.get(self._key(user_id))
        return json.loads(raw) if raw else None

    def load_credentials(self, user_id: str):
        """Rebuild google.oauth2 Credentials, expiry parsed (reference
        :96-129)."""
        data = self.load_credentials_dict(user_id)
        if not data:
            return None
        from google.oauth2.credentials import Credentials

        expiry = None
        if data.get("expiry"):
            try:
                expiry = datetime.fromisoformat(data["expiry"].replace("Z", "+00:00"))
                if expiry.tzinfo is not None:
                    expiry = expiry.astimezone(timezone.utc).replace(tzinfo=None)
            except ValueError:
                expiry = None
        creds = Credentials(
            token=data.get("token"),
            refresh_token=data.get("refresh_token"),
            token_uri=data.get("token_uri"),
            client_id=data.get("client_id"),
            client_secret=data.get("client_secret"),
            scopes=data.get("scopes"),
        )
        creds.expiry = expiry
        return creds

    # -- validity / refresh -------------------------------------------------

    def get_valid_credentials(self, user_id: str):
        """Load and refresh if expired or within 5 minutes of expiry."""
        creds = self.load_credentials(user_id)
        if creds is None:
            return None
        needs_refresh = creds.expired or (
            creds.expiry is not None
            and creds.expiry - datetime.now(timezone.utc).replace(tzinfo=None)
            < timedelta(seconds=REFRESH_MARGIN_S)
        )
        if needs_refresh:
            if not creds.refresh_token:
                # unrefreshable: expired (or about to) with no way back —
                # handing these out would mark sessions authenticated and
                # 401 every Drive call; None sends the user to re-login
                if creds.expired:
                    return None
                return creds  # inside the margin but still valid
            try:
                import google.auth.transport.requests

                creds.refresh(google.auth.transport.requests.Request())
                self.save_credentials(user_id, creds)
            except Exception as exc:  # noqa: BLE001 — network boundary
                logger.warning("credential refresh failed for %s: %s", user_id, exc)
                if creds.expired:
                    return None
        return creds

    def delete_credentials(self, user_id: str) -> None:
        self.kv.delete(self._key(user_id))

    def extend_credential_expiry(self, user_id: str) -> None:
        self.kv.expire(self._key(user_id), self.ttl_s)
