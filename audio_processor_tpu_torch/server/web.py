"""Minimal first-party WSGI framework (the image ships no Flask).

Provides exactly what the HTTP layer needs, on the stdlib only: a router
with path parameters, blueprints with URL prefixes, JSON request/response
helpers, HMAC-signed cookie sessions, before-request hooks, static file
serving, and a threaded dev server.  The public surface intentionally reads
like the reference's Flask app so the route modules stay recognisable
(reference: app/__init__.py, app/routes/*), but the implementation is
original and stdlib-WSGI underneath.

A copy of the JAX package's ``server/web.py``: the PyTorch package
imports nothing of that package.
"""
from __future__ import annotations

import base64
import hashlib
import hmac
import json
import logging
import mimetypes
import os
import re
import threading
from http.cookies import SimpleCookie
from typing import Any, Callable
from urllib.parse import parse_qs
from wsgiref.simple_server import WSGIServer, make_server

logger = logging.getLogger(__name__)

_STATUS_TEXT = {
    200: "200 OK",
    201: "201 Created",
    204: "204 No Content",
    302: "302 Found",
    400: "400 Bad Request",
    401: "401 Unauthorized",
    403: "403 Forbidden",
    404: "404 Not Found",
    405: "405 Method Not Allowed",
    409: "409 Conflict",
    413: "413 Content Too Large",
    500: "500 Internal Server Error",
    503: "503 Service Unavailable",
}


class RequestEntityTooLarge(Exception):
    """Request body exceeds the configured cap (APTPU_MAX_BODY_MB)."""


def _max_body_bytes() -> int:
    # Uploads are buffered in memory (Request.body), so an unauthenticated
    # POST could otherwise balloon the process; 512 MB covers ~80 min of
    # 16 kHz float WAV with headroom.  Read per-request so tests and
    # operators can retune without restarting.
    return int(os.environ.get("APTPU_MAX_BODY_MB", "512")) * 1024 * 1024


class Request:
    def __init__(self, environ: dict):
        self.environ = environ
        self.method = environ.get("REQUEST_METHOD", "GET").upper()
        self.path = environ.get("PATH_INFO", "/")
        self.query = {
            k: v[0] for k, v in parse_qs(environ.get("QUERY_STRING", "")).items()
        }
        self.headers = {
            k[5:].replace("_", "-").title(): v
            for k, v in environ.items()
            if k.startswith("HTTP_")
        }
        if environ.get("CONTENT_TYPE"):
            self.headers["Content-Type"] = environ["CONTENT_TYPE"]
        self._body: bytes | None = None
        self.params: dict[str, str] = {}  # path params, filled by router
        self.session: Session | None = None

    @property
    def body(self) -> bytes:
        if self._body is None:
            try:
                length = int(self.environ.get("CONTENT_LENGTH") or 0)
            except ValueError:
                length = 0
            if length > _max_body_bytes():
                raise RequestEntityTooLarge(
                    f"request body of {length} bytes exceeds the "
                    f"{_max_body_bytes()}-byte cap (APTPU_MAX_BODY_MB)"
                )
            self._body = self.environ["wsgi.input"].read(length) if length else b""
        return self._body

    def get_json(self, silent: bool = True) -> Any:
        try:
            return json.loads(self.body.decode("utf-8")) if self.body else None
        except (ValueError, UnicodeDecodeError):
            if silent:
                return None
            raise

    def form(self) -> tuple[dict[str, list[str]], dict[str, tuple[str, bytes]]]:
        """Parse a multipart/form-data (or urlencoded) body.

        Returns (fields, files): fields maps name -> list of values
        (repeated fields like OpenAI's ``timestamp_granularities[]``
        accumulate), files maps name -> (filename, bytes).  Raises
        ValueError on a missing/garbled body — callers turn that into a
        400.  Stdlib-only by design (the ``cgi`` module is gone in 3.13).
        """
        ctype = self.headers.get("Content-Type", "")
        fields: dict[str, list[str]] = {}
        files: dict[str, tuple[str, bytes]] = {}
        if ctype.startswith("application/x-www-form-urlencoded"):
            for k, vs in parse_qs(self.body.decode("utf-8")).items():
                fields.setdefault(k, []).extend(vs)
            return fields, files
        if not ctype.startswith("multipart/form-data"):
            raise ValueError(f"expected multipart/form-data, got {ctype!r}")
        # quoted form first: RFC 2046 bchars include ';' and ',', which a
        # quoted boundary may contain but an unquoted HTTP token cannot
        m = re.search(r'boundary="([^"]+)"|boundary=([^";,\s]+)', ctype)
        if not m:
            raise ValueError("multipart body without a boundary parameter")
        delim = b"--" + (m.group(1) or m.group(2)).encode("latin-1")
        # parts live between boundary delimiters; the closing delimiter is
        # followed by "--", which marks the epilogue chunk to stop at
        for raw in self.body.split(delim)[1:]:
            if raw.startswith(b"--"):
                break
            raw = raw.removeprefix(b"\r\n")
            head, sep, content = raw.partition(b"\r\n\r\n")
            if not sep:
                continue
            content = content.removesuffix(b"\r\n")
            disp = ""
            for line in head.split(b"\r\n"):
                k, _, v = line.partition(b":")
                if k.strip().lower() == b"content-disposition":
                    disp = v.decode("utf-8", "replace")
            name_m = re.search(r'name="([^"]*)"', disp)
            if not name_m:
                continue
            name = name_m.group(1)
            file_m = re.search(r'filename="([^"]*)"', disp)
            if file_m:
                files[name] = (file_m.group(1), content)
            else:
                fields.setdefault(name, []).append(
                    content.decode("utf-8", "replace")
                )
        return fields, files

    @property
    def remote_addr(self) -> str:
        return self.environ.get("REMOTE_ADDR", "")

    @property
    def host_url(self) -> str:
        """Effective external base URL.

        X-Forwarded-Proto/Host are CLIENT-SUPPLIED unless a proxy strips
        them, and this URL feeds the OAuth redirect_uri — so they are
        honored only behind a declared proxy (APTPU_TRUST_PROXY_HEADERS=1;
        EXTERNAL_URL remains the explicit override for tunnels).  Only the
        first value of a comma-joined multi-hop header is used.
        """
        trust_proxy = os.environ.get(
            "APTPU_TRUST_PROXY_HEADERS", ""
        ).lower() in ("1", "true", "yes")
        scheme = self.environ.get("wsgi.url_scheme", "http")
        host = self.headers.get("Host", "localhost")
        if trust_proxy:
            fwd_proto = self.headers.get("X-Forwarded-Proto")
            fwd_host = self.headers.get("X-Forwarded-Host")
            if fwd_proto:
                scheme = fwd_proto.split(",")[0].strip()
            if fwd_host:
                host = fwd_host.split(",")[0].strip()
        return f"{scheme}://{host}/"


class Response:
    def __init__(
        self,
        body: bytes | str = b"",
        status: int = 200,
        headers: dict[str, str] | None = None,
        content_type: str = "text/html; charset=utf-8",
    ):
        self.body = body.encode("utf-8") if isinstance(body, str) else body
        self.status = status
        self.headers = dict(headers or {})
        self.headers.setdefault("Content-Type", content_type)
        self._cookies: list[str] = []

    def set_cookie(
        self,
        name: str,
        value: str,
        max_age: int | None = None,
        path: str = "/",
        http_only: bool = True,
        same_site: str = "Lax",
        secure: bool = False,
    ) -> None:
        c = f"{name}={value}; Path={path}; SameSite={same_site}"
        if http_only:
            c += "; HttpOnly"
        if secure:
            c += "; Secure"
        if max_age is not None:
            c += f"; Max-Age={max_age}"
        self._cookies.append(c)

    def wsgi(self, start_response) -> list[bytes]:
        headers = list(self.headers.items())
        headers.append(("Content-Length", str(len(self.body))))
        for c in self._cookies:
            headers.append(("Set-Cookie", c))
        start_response(
            _STATUS_TEXT.get(self.status, f"{self.status} Unknown"),
            _clean_headers(headers),
        )
        return [self.body]


def _clean_headers(headers: list[tuple[str, str]]) -> list[tuple[str, str]]:
    """Strip CR/LF from header values at the one WSGI chokepoint.

    parse_qs URL-decodes %0d%0a into raw CRLF, so any header built from
    request data (e.g. a Location echoing an OAuth ?error=) would otherwise
    split the response on servers that don't validate (wsgiref doesn't)."""
    return [
        (k, v.replace("\r", "").replace("\n", "")) for k, v in headers
    ]


class _StreamBody:
    """WSGI body iterable that guarantees an on_close callback fires
    EXACTLY once — on normal exhaustion, on close(), or at GC.

    A plain generator's ``finally`` is skipped when the server close()s it
    before the first iteration (a GEN_CREATED generator's body never ran),
    which silently leaks anything the handler acquired before returning
    the response (SSE/stream slots).  WSGI servers must call close() on
    the body if it has one, so routing cleanup through here is reliable;
    __del__ is the belt-and-braces for nonconforming servers."""

    def __init__(self, iterator, on_close=None):
        self._it = iter(iterator)
        self._on_close = on_close

    def __iter__(self):
        return self

    def __next__(self):
        chunk = next(self._it)
        return chunk.encode("utf-8") if isinstance(chunk, str) else chunk

    def _fire(self):
        cb, self._on_close = self._on_close, None
        if cb is not None:
            try:
                cb()
            except Exception:  # noqa: BLE001 — cleanup must not mask errors
                logger.exception("stream on_close callback failed")

    def close(self):
        try:
            inner = getattr(self._it, "close", None)
            if inner is not None:
                inner()
        finally:
            self._fire()

    def __del__(self):
        self._fire()


class StreamingResponse(Response):
    """Chunked/streaming body from a bytes iterator (used for SSE).

    on_close: cleanup callback guaranteed to run exactly once when the
    response ends (exhaustion, client disconnect, or pre-iteration close)
    — use it to release concurrency slots instead of a ``finally`` inside
    the generator, which close() can skip."""

    def __init__(
        self,
        iterator,
        status: int = 200,
        headers: dict[str, str] | None = None,
        content_type: str = "text/event-stream",
        on_close=None,
    ):
        super().__init__(b"", status=status, headers=headers, content_type=content_type)
        self.headers.setdefault("Cache-Control", "no-cache")
        self.iterator = iterator
        self.on_close = on_close

    def wsgi(self, start_response):
        headers = list(self.headers.items())
        for c in self._cookies:
            headers.append(("Set-Cookie", c))
        start_response(
            _STATUS_TEXT.get(self.status, f"{self.status} Unknown"),
            _clean_headers(headers),
        )
        return _StreamBody(self.iterator, on_close=self.on_close)


def jsonify(data: Any, status: int = 200) -> Response:
    return Response(
        json.dumps(data), status=status, content_type="application/json"
    )


def redirect(location: str, status: int = 302) -> Response:
    return Response(b"", status=status, headers={"Location": location})


# ---------------------------------------------------------------------------
# Sessions: HMAC-signed JSON cookie (no server-side state needed)
# ---------------------------------------------------------------------------

class Session(dict):
    """dict with write-back tracking: EVERY mutating method must set
    ``modified`` — an untracked mutation is silently never saved to the
    cookie (the change evaporates on the next request)."""

    def __init__(self, data: dict | None = None):
        super().__init__(data or {})
        self.modified = False

    def __setitem__(self, k, v):
        super().__setitem__(k, v)
        self.modified = True

    def __delitem__(self, k):
        super().__delitem__(k)
        self.modified = True

    def pop(self, k, *a):
        self.modified = True
        return super().pop(k, *a)

    def popitem(self):
        self.modified = True
        return super().popitem()

    def setdefault(self, k, default=None):
        if k not in self:
            self.modified = True
        return super().setdefault(k, default)

    def update(self, *a, **kw):
        super().update(*a, **kw)
        self.modified = True

    def clear(self):
        super().clear()
        self.modified = True


class SessionCodec:
    COOKIE = "aptpu_session"

    def __init__(self, secret: str):
        self.key = hashlib.sha256(secret.encode()).digest()

    def load(self, request: Request) -> Session:
        raw = SimpleCookie(request.headers.get("Cookie", "")).get(self.COOKIE)
        if not raw:
            return Session()
        try:
            payload_b64, sig = raw.value.rsplit(".", 1)
            payload = base64.urlsafe_b64decode(payload_b64.encode())
            expect = hmac.new(self.key, payload, hashlib.sha256).hexdigest()
            if hmac.compare_digest(expect, sig):
                return Session(json.loads(payload))
        except Exception:  # malformed cookie -> fresh session
            pass
        return Session()

    def save(self, session: Session, response: Response) -> None:
        payload = json.dumps(dict(session), separators=(",", ":")).encode()
        sig = hmac.new(self.key, payload, hashlib.sha256).hexdigest()
        value = base64.urlsafe_b64encode(payload).decode() + "." + sig
        response.set_cookie(
            self.COOKIE, value, max_age=30 * 24 * 3600,
            secure=_cookie_secure(),
        )


def _cookie_secure() -> bool:
    """Mark the session cookie Secure when the deployment is HTTPS-facing:
    forced via APTPU_COOKIE_SECURE, or inferred from an https EXTERNAL_URL
    (the tunnel/proxy scenario) — otherwise the 30-day authenticated
    cookie rides any plaintext http request to the same host."""
    forced = os.environ.get("APTPU_COOKIE_SECURE", "").lower()
    if forced in ("1", "true", "yes"):
        return True
    if forced in ("0", "false", "no"):
        return False
    return os.environ.get("EXTERNAL_URL", "").lower().startswith("https://")


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

_PARAM_RE = re.compile(r"<([a-zA-Z_][a-zA-Z0-9_]*)>")


def _compile_rule(rule: str) -> re.Pattern:
    pattern = _PARAM_RE.sub(r"(?P<\1>[^/]+)", re.escape(rule).replace(r"\<", "<").replace(r"\>", ">"))
    return re.compile(f"^{pattern}$")


class Blueprint:
    def __init__(self, name: str, url_prefix: str = ""):
        self.name = name
        self.url_prefix = url_prefix
        self.routes: list[tuple[str, tuple[str, ...], Callable]] = []

    def route(self, rule: str, methods: tuple[str, ...] = ("GET",)):
        def deco(fn):
            self.routes.append((rule, tuple(m.upper() for m in methods), fn))
            return fn

        return deco


class App:
    def __init__(
        self,
        secret_key: str = "dev-secret",
        static_dir: str | None = None,
        template_dir: str | None = None,
    ):
        self.routes: list[tuple[re.Pattern, tuple[str, ...], Callable]] = []
        self.before_request_hooks: list[Callable[[Request], Response | None]] = []
        self.session_codec = SessionCodec(secret_key)
        self.static_dir = static_dir
        self.template_dir = template_dir
        self.config: dict[str, Any] = {}
        # the dev server's loop: shutdown() and run() agree on it under the lock
        self._server = None
        self._stop_requested = False
        self._serve_lock = threading.Lock()

    # -- registration -------------------------------------------------------

    def route(self, rule: str, methods: tuple[str, ...] = ("GET",)):
        def deco(fn):
            self.routes.append((_compile_rule(rule), tuple(m.upper() for m in methods), fn))
            return fn

        return deco

    def register_blueprint(self, bp: Blueprint) -> None:
        for rule, methods, fn in bp.routes:
            self.routes.append((_compile_rule(bp.url_prefix + rule), methods, fn))

    def before_request(self, fn):
        self.before_request_hooks.append(fn)
        return fn

    # -- templates / static -------------------------------------------------

    def render_template(self, name: str, **context) -> Response:
        assert self.template_dir, "no template_dir configured"
        with open(os.path.join(self.template_dir, name), encoding="utf-8") as f:
            html = f.read()
        for k, v in context.items():
            html = html.replace("{{ " + k + " }}", str(v))
        return Response(html)

    def _serve_static(self, path: str) -> Response:
        assert self.static_dir
        # resolve both sides and compare path components — a bare
        # startswith(root) would let /static/../static-sibling escape to any
        # sibling directory sharing the root's name as a prefix, and breaks
        # for a relative static_dir
        root = os.path.realpath(self.static_dir)
        full = os.path.realpath(os.path.join(root, path))
        if os.path.commonpath([root, full]) != root:
            return Response(b"forbidden", 403)
        if not os.path.isfile(full):
            return jsonify({"error": "not found"}, 404)
        ctype = mimetypes.guess_type(full)[0] or "application/octet-stream"
        with open(full, "rb") as f:
            return Response(f.read(), content_type=ctype)

    # -- WSGI ---------------------------------------------------------------

    def __call__(self, environ, start_response):
        request = Request(environ)
        try:
            response = self._dispatch(request)
        except RequestEntityTooLarge as e:
            response = jsonify({"error": str(e)}, 413)
        except Exception:  # noqa: BLE001 — server boundary
            logger.exception("unhandled error for %s %s", request.method, request.path)
            response = jsonify({"error": "Internal server error"}, 500)
        if request.session is not None and request.session.modified:
            self.session_codec.save(request.session, response)
        if request.method == "HEAD":
            if isinstance(response, StreamingResponse):
                # HEAD must not stream a body (protocol violation) or pin
                # a worker thread + SSE slot for the stream's lifetime:
                # close the generator (running its finally blocks), fire
                # the slot-release hook, and answer headers-only
                try:
                    close = getattr(response.iterator, "close", None)
                    if close is not None:
                        close()
                finally:
                    if response.on_close is not None:
                        cb, response.on_close = response.on_close, None
                        cb()
                plain = Response(
                    b"", status=response.status, headers=response.headers
                )
                plain._cookies = response._cookies
                response = plain
            response.body = b""  # HEAD: headers only (static/errors too)
        return response.wsgi(start_response)

    def _dispatch(self, request: Request) -> Response:
        if self.static_dir and request.path.startswith("/static/"):
            return self._serve_static(request.path[len("/static/"):])

        request.session = self.session_codec.load(request)

        for hook in self.before_request_hooks:
            early = hook(request)
            if early is not None:
                return early

        # HEAD is answered by the GET handler with the body stripped
        # (Flask's auto-HEAD rule — load balancers probe HEAD /health)
        head = request.method == "HEAD"
        lookup = "GET" if head else request.method
        allowed: set[str] = set()
        for pattern, methods, fn in self.routes:
            m = pattern.match(request.path)
            if m:
                if lookup in methods:
                    request.params = m.groupdict()
                    out = fn(request, **m.groupdict())
                    if isinstance(out, Response):
                        resp = out
                    elif isinstance(out, tuple):  # (data, status)
                        resp = jsonify(out[0], out[1])
                    elif isinstance(out, (dict, list)):
                        resp = jsonify(out)
                    else:
                        resp = Response(str(out))
                    return resp
                allowed.update(methods)
        if allowed:
            return jsonify({"error": "Method not allowed"}, 405)
        return jsonify({"error": "Not found"}, 404)

    # -- dev server ---------------------------------------------------------

    def run(
        self,
        host: str = "0.0.0.0",
        port: int = 5000,
        max_threads: int | None = None,
    ) -> None:
        """Bounded threaded WSGI server.

        At most max_threads (APTPU_HTTP_WORKERS, default 32) requests run
        concurrently — a status-poll burst queues at the accept loop
        instead of spawning a thread per connection (the reference at
        least ran gunicorn with worker limits, reference Dockerfile:44;
        production here runs gunicorn too — see the repo Dockerfile —
        this server is the dev/fallback path).  Handler threads stay
        DAEMON (a semaphore bounds them, not a ThreadPoolExecutor, whose
        non-daemon workers are joined at interpreter exit — Ctrl+C would
        hang behind any open SSE stream).  SSE streams hold a slot each;
        their subscriber cap (server/api.py) is sized well below the
        default bound.
        """
        if max_threads is None:
            max_threads = int(os.environ.get("APTPU_HTTP_WORKERS", "32"))
        slots = threading.BoundedSemaphore(max_threads)

        class ThreadingWSGIServer(WSGIServer):
            daemon_threads = True

            def process_request(self, request, client_address):
                slots.acquire()  # backpressure: accept loop waits for a slot
                try:
                    t = threading.Thread(
                        target=self._handle, args=(request, client_address),
                        daemon=True, name=f"http-{client_address[1]}",
                    )
                    t.start()
                except BaseException:
                    # Thread.start() can fail under fd/thread exhaustion —
                    # the slot must come back or capacity shrinks forever
                    slots.release()
                    raise

            def _handle(self, request, client_address):
                try:
                    self.finish_request(request, client_address)
                except Exception:
                    self.handle_error(request, client_address)
                finally:
                    self.shutdown_request(request)
                    slots.release()

        with make_server(host, port, self, server_class=ThreadingWSGIServer) as srv:
            # the server is published before its loop starts, so a
            # shutdown() from here on stops the loop; one that came earlier
            # left a request, and the loop never starts
            with self._serve_lock:
                stop, self._stop_requested = self._stop_requested, False
                self._server = None if stop else srv
            if stop:
                logger.info("shutdown requested before serving on %s:%d", host, port)
                return
            logger.info(
                "serving on %s:%d (%d worker threads)", host, port, max_threads
            )
            try:
                srv.serve_forever()
            finally:
                with self._serve_lock:
                    self._server = None

    def shutdown(self) -> None:
        """Stop a run() loop started on another thread (test harnesses —
        production fronts with gunicorn).  Called before the loop has
        started (run() on a thread that has not reached it), it leaves a
        request that the next run() takes: that run() closes its socket
        and returns without serving."""
        with self._serve_lock:
            srv = self._server
            if srv is None:
                self._stop_requested = True
        if srv is not None:
            srv.shutdown()
