"""Google Drive v3 client (service-account + per-user OAuth), REST-native.

Rebuild of the reference's two Drive services (reference:
app/services/audio_processor.py:76-118 service-account init, 133-150 OAuth
service, 152-227 download, 229-251 listing, 253-272 folder-path
resolution, 316-330 rename, 371-421 reverse folder walk) without the
google-api-python-client dependency: plain Drive v3 REST over an
injectable transport, with google-auth used only to mint/refresh tokens.

A copy of the JAX package's ``integrations/drive.py``: the PyTorch package
imports nothing of that package.
"""
from __future__ import annotations

import json
import logging
import os
import re
from typing import Callable

logger = logging.getLogger(__name__)

API_ROOT = "https://www.googleapis.com/drive/v3"
CHUNK = 1024 * 1024  # 1 MiB download chunks (reference uses chunked media)

_SANITIZE_RE = re.compile(r"[\\/:*?\"<>|]")


def sanitize_filename(name: str) -> str:
    """Strip filesystem-hostile characters (reference regex :168,207)."""
    return _SANITIZE_RE.sub("_", name).strip() or "untitled"


class DriveError(RuntimeError):
    pass


def _default_transport(
    method: str,
    url: str,
    headers: dict,
    params: dict | None = None,
    body: dict | None = None,
    timeout: float = 120.0,
):
    import requests

    resp = requests.request(
        method, url, headers=headers, params=params, json=body, timeout=timeout
    )
    return resp.status_code, resp.headers, resp.content


class DriveClient:
    """Drive v3 over REST.  `token_provider` returns a live bearer token."""

    def __init__(
        self,
        token_provider: Callable[[], str] | None = None,
        transport: Callable | None = None,
    ):
        self.token_provider = token_provider or (lambda: "")
        self.transport = transport or _default_transport

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_service_account_file(cls, path: str | None = None, transport=None):
        """SA auth with the reference's path fallback chain (:94-106)."""
        candidates = [
            path,
            os.environ.get("GOOGLE_SA_JSON_PATH"),
            "service-account.json",
            "/app/service-account.json",
        ]
        sa_path = next((p for p in candidates if p and os.path.isfile(p)), None)
        if sa_path is None:
            raise DriveError("no service-account JSON found")
        from google.oauth2 import service_account

        creds = service_account.Credentials.from_service_account_file(
            sa_path, scopes=["https://www.googleapis.com/auth/drive"]
        )
        return cls.from_google_credentials(creds, transport=transport)

    @classmethod
    def from_google_credentials(cls, creds, transport=None):
        def provider() -> str:
            if not creds.valid:
                import google.auth.transport.requests

                creds.refresh(google.auth.transport.requests.Request())
            return creds.token

        return cls(token_provider=provider, transport=transport)

    # -- plumbing -----------------------------------------------------------

    def _headers(self) -> dict:
        return {"Authorization": f"Bearer {self.token_provider()}"}

    def _get_json(self, url: str, params: dict | None = None, retries: int = 3) -> dict:
        """GET with backoff on 5xx/429/transport errors (failure-detection
        hardening the reference's google-api client gave it for free)."""
        import time as _time

        delay = 1.0
        last: Exception | None = None
        for attempt in range(retries):
            if attempt:  # backoff BEFORE a retry, never after the last try
                _time.sleep(delay)
                delay *= 2
            try:
                status, _, content = self.transport(
                    "GET", url, self._headers(), params, None
                )
            except Exception as exc:  # noqa: BLE001 — transport boundary
                last = exc
                continue
            if status == 200:
                return json.loads(content)
            if status in (429, 500, 502, 503, 504):
                last = DriveError(f"GET {url}: HTTP {status}")
                continue
            raise DriveError(f"GET {url}: HTTP {status}: {content[:200]!r}")
        raise last or DriveError(f"GET {url} failed")

    # -- API surface --------------------------------------------------------

    def list_files(
        self, query: str, page_size: int = 100, order_by: str = "modifiedTime desc"
    ) -> list[dict]:
        files: list[dict] = []
        token: str | None = None
        while True:
            params = {
                "q": query,
                "pageSize": page_size,
                "orderBy": order_by,
                "fields": "nextPageToken, files(id, name, mimeType, size, parents, modifiedTime)",
            }
            if token:
                params["pageToken"] = token
            body = self._get_json(f"{API_ROOT}/files", params)
            files.extend(body.get("files", []))
            token = body.get("nextPageToken")
            if not token:
                break
        return files

    def get_metadata(self, file_id: str, fields: str = "id, name, mimeType, size, parents") -> dict:
        return self._get_json(f"{API_ROOT}/files/{file_id}", {"fields": fields})

    def download(self, file_id: str, dest_path: str, retries: int = 3) -> str:
        """Chunked media download via Range requests (reference: chunked
        MediaIoBaseDownload loop, :173-218).

        Each chunk retries with backoff on 429/5xx/transport errors (same
        policy as _get_json — a multi-GB recording is hundreds of Range
        requests and one transient 429 must not abort the file), and the
        Authorization header is re-minted per attempt so downloads longer
        than the OAuth token lifetime keep working.
        """
        import time as _time

        offset = 0
        with open(dest_path, "wb") as f:
            while True:
                delay = 1.0
                last: Exception | None = None
                for attempt in range(retries):
                    if attempt:  # backoff before a retry, not after the last
                        _time.sleep(delay)
                        delay *= 2
                    h = dict(self._headers())
                    h["Range"] = f"bytes={offset}-{offset + CHUNK - 1}"
                    try:
                        status, resp_headers, content = self.transport(
                            "GET", f"{API_ROOT}/files/{file_id}", h,
                            {"alt": "media"}, None,
                        )
                    except Exception as exc:  # noqa: BLE001 — transport
                        last = exc
                        continue
                    if status == 416:
                        # Range Not Satisfiable: a ZERO-BYTE file at
                        # offset 0 (valid — write the empty file), or
                        # end-of-file on a later chunk
                        status, resp_headers, content = 206, {}, b""
                        break
                    if status in (200, 206):
                        break
                    if status in (429, 500, 502, 503, 504):
                        last = DriveError(f"download {file_id}: HTTP {status}")
                        continue
                    raise DriveError(f"download {file_id}: HTTP {status}")
                else:
                    raise last or DriveError(f"download {file_id} failed")
                f.write(content)
                offset += len(content)
                total = _content_range_total(resp_headers)
                if status == 200 or (total is not None and offset >= total) or not content:
                    break
        return dest_path

    def download_bytes(self, file_id: str, retries: int = 3) -> bytes:
        """Whole-file download with the same 429/5xx/transport backoff as
        download()/_get_json — one transient blip used to silently drop a
        PDF attachment from the summary prompt (meeting stage 2 is
        best-effort)."""
        import time as _time

        delay = 1.0
        last: Exception | None = None
        for attempt in range(retries):
            if attempt:  # backoff before a retry, not after the last try
                _time.sleep(delay)
                delay *= 2
            try:
                status, _, content = self.transport(
                    "GET", f"{API_ROOT}/files/{file_id}",
                    self._headers(), {"alt": "media"}, None,
                )
            except Exception as exc:  # noqa: BLE001 — transport boundary
                last = exc
                continue
            if status in (200, 206):
                return content
            if status in (429, 500, 502, 503, 504):
                last = DriveError(f"download {file_id}: HTTP {status}")
                continue
            raise DriveError(f"download {file_id}: HTTP {status}")
        raise last or DriveError(f"download {file_id} failed")

    def rename(self, file_id: str, new_name: str) -> dict:
        status, _, content = self.transport(
            "PATCH",
            f"{API_ROOT}/files/{file_id}",
            {**self._headers(), "Content-Type": "application/json"},
            None,
            {"name": new_name},
        )
        if status != 200:
            raise DriveError(f"rename {file_id}: HTTP {status}: {content[:200]!r}")
        return json.loads(content)

    def find_folder_id_by_path(self, path: str) -> str | None:
        """Resolve 'A/B/C' to a folder id, one files.list per segment
        (reference :253-272)."""
        parent = "root"
        for segment in [s for s in path.split("/") if s]:
            # backslashes must double BEFORE quote-escaping, or a name
            # like Q3\Reports injects a stray escape into the query
            safe = segment.replace("\\", "\\\\").replace("'", "\\'")
            q = (
                f"name = '{safe}' and mimeType = 'application/vnd.google-apps.folder'"
                f" and '{parent}' in parents and trashed = false"
            )
            found = self.list_files(query=q, page_size=10, order_by="name")
            if not found:
                return None
            parent = found[0]["id"]
        return parent

    def get_file_folder_path(self, file_id: str, max_depth: int = 10) -> str:
        """Reverse walk: file -> parent chain -> 'A/B/C' (reference :371-421)."""
        parts: list[str] = []
        meta = self.get_metadata(file_id, fields="name, parents")
        parents = meta.get("parents") or []
        depth = 0
        while parents and depth < max_depth:
            pmeta = self.get_metadata(parents[0], fields="name, parents")
            name = pmeta.get("name", "")
            if name and name != "My Drive":
                parts.append(name)
            parents = pmeta.get("parents") or []
            depth += 1
        return "/".join(reversed(parts))

    def file_link(self, file_id: str) -> str:
        return f"https://drive.google.com/file/d/{file_id}/view"


def _content_range_total(headers) -> int | None:
    cr = None
    for k in headers:
        if k.lower() == "content-range":
            cr = headers[k]
            break
    if cr and "/" in cr:
        try:
            return int(cr.rsplit("/", 1)[1])
        except ValueError:
            return None
    return None
