"""Google OAuth2 web flow, first-party (no google_auth_oauthlib).

Rebuild of the reference's auth blueprint (reference:
app/routes/auth_routes.py:20-708): login/callback pages, the
authorization-URL construction with localhost->EXTERNAL_URL redirect rewriting
(:62-72), code exchange (server-side /api/auth/callback and the JS-driven
/api/auth/token used by callback.html), credential persistence with
30-day TTL, status/userinfo endpoints that restore+refresh credentials
from the store, and logout that actually clears the processor's OAuth
Drive client (the reference calls a method that doesn't exist,
auth_routes.py:698-701).

The flow itself is plain OAuth2: authorization endpoint -> code ->
token endpoint -> userinfo endpoint, all over an injectable transport so
tests run hermetically.

A copy of the JAX package's ``server/auth.py``: the PyTorch package
imports nothing of that package.
"""
from __future__ import annotations

import json
import logging
import os
import secrets
import time
from typing import Any, Callable
from urllib.parse import quote, urlencode

from .web import Blueprint, Request, redirect

logger = logging.getLogger(__name__)

AUTH_ENDPOINT = "https://accounts.google.com/o/oauth2/v2/auth"
TOKEN_ENDPOINT = "https://oauth2.googleapis.com/token"
USERINFO_ENDPOINT = "https://www.googleapis.com/oauth2/v2/userinfo"

SCOPES = (
    "https://www.googleapis.com/auth/drive.readonly",
    "https://www.googleapis.com/auth/userinfo.profile",
    "https://www.googleapis.com/auth/userinfo.email",
    "openid",
)


def load_client_config(path: str | None = None) -> dict | None:
    """{client_id, client_secret} from client-secret JSON or env vars."""
    path = path or os.environ.get("GOOGLE_CLIENT_SECRET_PATH")
    if path and os.path.isfile(path):
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        web = data.get("web") or data.get("installed") or {}
        if web.get("client_id"):
            return {
                "client_id": web["client_id"],
                "client_secret": web.get("client_secret", ""),
            }
    cid = os.environ.get("GOOGLE_CLIENT_ID")
    if cid:
        return {
            "client_id": cid,
            "client_secret": os.environ.get("GOOGLE_CLIENT_SECRET", ""),
        }
    return None


def _default_post(url: str, data: dict, timeout: float = 30.0) -> tuple[int, dict]:
    import requests

    resp = requests.post(url, data=data, timeout=timeout)
    try:
        return resp.status_code, resp.json()
    except ValueError:
        return resp.status_code, {"error": resp.text[:300]}


def _default_get(url: str, headers: dict, timeout: float = 30.0) -> tuple[int, dict]:
    import requests

    resp = requests.get(url, headers=headers, timeout=timeout)
    try:
        return resp.status_code, resp.json()
    except ValueError:
        return resp.status_code, {"error": resp.text[:300]}


def external_redirect_uri(request: Request, path: str = "/callback") -> str:
    """Rewrite localhost hosts to EXTERNAL_URL (reference :62-72) so the
    OAuth consent redirect works behind a tunnel/proxy."""
    base = request.host_url.rstrip("/")
    external = os.environ.get("EXTERNAL_URL", "").rstrip("/")
    if external and ("localhost" in base or "127.0.0.1" in base):
        base = external
    return base + path


def make_auth_blueprint(
    services: Any,
    post: Callable = _default_post,
    get: Callable = _default_get,
) -> Blueprint:
    bp = Blueprint("auth")
    store = services.credential_store

    def client_config() -> dict | None:
        return load_client_config()

    # -- pages --------------------------------------------------------------

    @bp.route("/login")
    def login_page(request: Request):
        from .app import render

        return render("login.html")

    @bp.route("/callback")
    def callback_page(request: Request):
        from .app import render

        return render("callback.html")

    # -- start flow ---------------------------------------------------------

    @bp.route("/api/auth/google")
    def auth_google(request: Request):
        cfg = client_config()
        if cfg is None:
            return {"success": False, "error": "OAuth client not configured"}, 503
        state = secrets.token_urlsafe(24)
        redirect_uri = external_redirect_uri(request)
        request.session["flow_state"] = state
        request.session["redirect_uri"] = redirect_uri
        params = {
            "client_id": cfg["client_id"],
            "redirect_uri": redirect_uri,
            "response_type": "code",
            "scope": " ".join(SCOPES),
            "state": state,
            "access_type": "offline",
            "prompt": "consent",
            "include_granted_scopes": "true",
        }
        return redirect(f"{AUTH_ENDPOINT}?{urlencode(params)}")

    # -- code exchange ------------------------------------------------------

    def _exchange_code(code: str, redirect_uri: str) -> dict:
        cfg = client_config()
        if cfg is None:
            raise RuntimeError("OAuth client not configured")
        status, body = post(
            TOKEN_ENDPOINT,
            {
                "code": code,
                "client_id": cfg["client_id"],
                "client_secret": cfg["client_secret"],
                "redirect_uri": redirect_uri,
                "grant_type": "authorization_code",
            },
        )
        if status != 200 or "access_token" not in body:
            raise RuntimeError(f"token exchange failed: {body.get('error', status)}")
        return body

    def _fetch_userinfo(access_token: str) -> dict:
        status, body = get(
            USERINFO_ENDPOINT, {"Authorization": f"Bearer {access_token}"}
        )
        if status != 200:
            raise RuntimeError(f"userinfo failed: HTTP {status}")
        return body

    def _complete_login(request: Request, token_body: dict) -> dict:
        cfg = client_config() or {}
        user = _fetch_userinfo(token_body["access_token"])
        user_id = user.get("id") or user.get("email") or "user"
        expiry = time.time() + float(token_body.get("expires_in", 3600))
        creds_dict = {
            "token": token_body["access_token"],
            "refresh_token": token_body.get("refresh_token"),
            "token_uri": TOKEN_ENDPOINT,
            "client_id": cfg.get("client_id"),
            "client_secret": cfg.get("client_secret"),
            "scopes": list(SCOPES),
            "expiry": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(expiry)),
        }
        if store is not None:
            store.save_credentials(user_id, creds_dict)
        request.session["authenticated"] = True
        request.session["user_id"] = user_id
        request.session["user_info"] = {
            "id": user_id,
            "name": user.get("name", ""),
            "email": user.get("email", ""),
            "picture": user.get("picture", ""),
        }
        _restore_drive(user_id)
        return request.session["user_info"]

    def _restore_drive(user_id: str) -> None:
        if store is None:
            return
        creds = store.get_valid_credentials(user_id)
        if creds is not None:
            services.set_oauth_credentials(creds, user_id=user_id)

    @bp.route("/api/auth/callback")
    def auth_callback(request: Request):
        error = request.query.get("error")
        if error:
            # re-encode: the decoded value may hold &, spaces, or CRLF
            return redirect(f"/login?error={quote(error)}")
        code = request.query.get("code")
        state = request.query.get("state")
        if not code:
            return {"success": False, "error": "Missing authorization code"}, 400
        # the state must EXIST and match: a fresh session has no
        # flow_state, and `None != None` is False — an attacker-initiated
        # code with no state would otherwise bind the victim's session to
        # the attacker's account (login CSRF; same hard check as
        # /api/auth/token)
        expected = request.session.get("flow_state")
        if not expected or state != expected:
            return {"success": False, "error": "State mismatch"}, 400
        redirect_uri = request.session.get("redirect_uri") or external_redirect_uri(request)
        try:
            token_body = _exchange_code(code, redirect_uri)
            _complete_login(request, token_body)
        except Exception as exc:  # noqa: BLE001 — IdP boundary
            logger.exception("oauth callback failed")
            return redirect(f"/login?error={quote(str(exc))}")
        request.session.pop("flow_state", None)
        return redirect("/")

    @bp.route("/api/auth/token", methods=("POST",))
    def auth_token(request: Request):
        """JS-driven exchange used by callback.html (reference :345)."""
        data = request.get_json() or {}
        code = data.get("code")
        if not code:
            return {"success": False, "error": "Missing code"}, 400
        # HARD state check: the session must have initiated the flow and
        # the posted state must match.  An optional check was login-CSRF —
        # omitting `state` let an attacker complete THEIR code on a
        # victim's session, silently pointing Drive jobs at their account.
        expected = request.session.get("flow_state")
        if not expected or data.get("state") != expected:
            return {"success": False, "error": "State mismatch"}, 400
        # the session's redirect_uri (stored when the flow started) is
        # authoritative; the request body must not override it
        redirect_uri = (
            request.session.get("redirect_uri")
            or external_redirect_uri(request)
        )
        try:
            token_body = _exchange_code(code, redirect_uri)
            user_info = _complete_login(request, token_body)
        except Exception as exc:  # noqa: BLE001
            logger.exception("token exchange failed")
            return {"success": False, "error": str(exc)}, 400
        request.session.pop("flow_state", None)
        return {"success": True, "user": user_info}

    # -- status / userinfo --------------------------------------------------

    @bp.route("/api/auth/status")
    def auth_status(request: Request):
        user_id = request.session.get("user_id")
        if request.session.get("authenticated") and user_id:
            # same guard as app.py's restore hook: the frontend polls this
            # every few seconds, and an unconditional restore re-read the
            # store (+ possible token-refresh HTTP call) and rebuilt the
            # Drive client per poll
            if services.drive_for(user_id) is None:
                _restore_drive(user_id)
            return {
                "authenticated": True,
                "user": request.session.get("user_info", {"id": user_id}),
            }
        # try restoring from the persistent store via a user hint cookie
        if user_id and store is not None:
            creds = store.get_valid_credentials(user_id)
            if creds is not None:
                request.session["authenticated"] = True
                services.set_oauth_credentials(creds, user_id=user_id)
                return {
                    "authenticated": True,
                    "user": request.session.get("user_info", {"id": user_id}),
                }
        return {"authenticated": False}

    @bp.route("/api/auth/userinfo")
    def auth_userinfo(request: Request):
        if not request.session.get("authenticated"):
            return {"success": False, "error": "Not authenticated"}, 401
        return {"success": True, "user": request.session.get("user_info", {})}

    # POST-only: logout deletes the stored refresh token, and SameSite=Lax
    # cookies ride top-level GET navigations — a GET logout is forced
    # logout + credential destruction by cross-site link (webui POSTs)
    @bp.route("/api/auth/logout", methods=("POST",))
    def logout(request: Request):
        user_id = request.session.get("user_id")
        if user_id:
            # only THIS user's state: clear_credentials(None) clears every
            # user's Drive client, so an anonymous GET (no session) used to
            # wipe all logged-in users process-wide
            if store is not None:
                store.delete_credentials(user_id)
            services.clear_credentials(user_id)
        request.session.clear()
        return {"success": True}

    return bp
