"""App factory: assembles the WSGI app from services + blueprints.

Rebuild of the reference's create_app (reference: app/__init__.py:14-78):
session secret, credential-restore before_request middleware that skips
static/auth endpoints, and the three blueprints (auth, main, api).  The
dead drive_routes blueprint is intentionally not rebuilt (reference
defect: registered nowhere, references a nonexistent attribute —
SURVEY.md appendix).

The port's copy of the JAX package's ``server/app.py``.  The web UI's
templates and static files are the port's own copy of that package's
``webui/`` directory, byte for byte, in this package's ``webui/``.
"""
from __future__ import annotations

import logging
import os
from typing import Any

from .api import make_api_blueprint
from .auth import make_auth_blueprint
from .openai_api import make_openai_blueprint
from .web import App, Blueprint, Request, Response, jsonify

logger = logging.getLogger(__name__)

WEBUI_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "webui")
TEMPLATE_DIR = os.path.join(WEBUI_DIR, "templates")
STATIC_DIR = os.path.join(WEBUI_DIR, "static")


# template renderer bound to this package's webui dir — ONE definition
# (the framework's App.render_template), not a parallel re-implementation
_render_app = App(template_dir=TEMPLATE_DIR)


def render(name: str, **ctx) -> Response:
    return _render_app.render_template(name, **ctx)


# paths exempt from BOTH credential restore and key-gating — one list, so
# an exemption added to one behavior cannot silently miss the other
_SKIP_RESTORE_PREFIXES = (
    "/static/", "/api/auth/", "/login", "/callback", "/api/health",
    "/health", "/v1/"
)


def _session_secret(secret_key: str | None) -> str:
    """SECRET_KEY, or a RANDOM per-process secret when unset.

    A well-known fallback ('dev-secret') lets anyone forge an
    authenticated session cookie — silently defeating APTPU_API_KEYS and
    per-user job scoping.  A random secret keeps cookies unforgeable;
    the cost (sessions reset on restart and don't share across gunicorn
    workers) is logged so operators set SECRET_KEY for real deployments.
    """
    secret = secret_key or os.environ.get("SECRET_KEY")
    if secret:
        return secret
    import logging
    import secrets

    logging.getLogger(__name__).warning(
        "SECRET_KEY is not set — using a random per-process session "
        "secret (sessions reset on restart and do not share across "
        "workers); set SECRET_KEY for production"
    )
    return secrets.token_hex(32)


def create_app(services: Any, secret_key: str | None = None) -> App:
    app = App(
        secret_key=_session_secret(secret_key),
        static_dir=STATIC_DIR,
        template_dir=TEMPLATE_DIR,
    )
    app.config["services"] = services

    @app.before_request
    def enforce_api_keys(request: Request):
        """When APTPU_API_KEYS is set, the JOB API (both /api/* and the
        un-prefixed aliases) requires either an authenticated browser
        session or one of the Bearer keys — otherwise key-gating only /v1
        would leave the same transcripts readable one path over
        (/jobs/<id>/result).  Health stays open for liveness probes; /v1
        runs its own check with the OpenAI error envelope."""
        from .security import bearer_key_ok, configured_keys

        keys = configured_keys()
        if not keys:
            return None
        if request.path == "/" or any(
            request.path.startswith(p) for p in _SKIP_RESTORE_PREFIXES
        ):
            return None
        if request.session and request.session.get("authenticated"):
            return None
        if bearer_key_ok(request, keys):
            return None
        return jsonify(
            {"success": False, "error": "authentication required"}, status=401
        )

    @app.before_request
    def restore_credentials(request: Request):
        """Re-hydrate per-user OAuth creds from the store into the Drive
        client on every authenticated request (reference:
        app/__init__.py:24-66), skipping static/auth endpoints."""
        if any(request.path.startswith(p) for p in _SKIP_RESTORE_PREFIXES):
            return None
        user_id = request.session.get("user_id") if request.session else None
        if not user_id or services.credential_store is None:
            return None
        if services.drive_for(user_id) is None:
            try:
                creds = services.credential_store.get_valid_credentials(user_id)
                if creds is not None:
                    services.set_oauth_credentials(creds, user_id=user_id)
                    request.session["authenticated"] = True
            except Exception as exc:  # noqa: BLE001 — auth is best-effort here
                logger.warning("credential restore failed for %s: %s", user_id, exc)
        return None

    main_bp = Blueprint("main")

    @main_bp.route("/")
    def index(request: Request):
        return render("index.html")

    app.register_blueprint(make_auth_blueprint(services))
    app.register_blueprint(main_bp)
    app.register_blueprint(make_api_blueprint(services))
    # the reference README documents the job API UN-prefixed (/process,
    # /job/<id>, /jobs — reference README.md:114,152) while its code
    # serves /api/*; alias both so clients written against either work
    app.register_blueprint(make_api_blueprint(services, url_prefix=""))
    app.register_blueprint(make_openai_blueprint(services))
    return app
