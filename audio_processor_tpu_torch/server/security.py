"""Shared request-authentication helpers.

APTPU_API_KEYS (comma-separated) turns on key auth for the whole HTTP
surface: the /v1 endpoints take OpenAI's ``Authorization: Bearer`` form,
and the job API accepts the same Bearer keys for machine clients while
browser sessions authenticated through the OAuth flow pass as-is.  Unset
keeps everything open (the reference's LAN deployment posture).

A copy of the JAX package's ``server/security.py``: the PyTorch package
imports nothing of that package.
"""
from __future__ import annotations

import hmac
import os


def configured_keys() -> list[str]:
    raw = os.environ.get("APTPU_API_KEYS", "")
    return [k.strip() for k in raw.split(",") if k.strip()]


def bearer_key_ok(request, keys: list[str]) -> bool:
    """True when the request carries a valid Bearer key.

    Scheme match is case-insensitive (RFC 7235 §2.1) and the comparison is
    constant-time over bytes (str compare_digest rejects non-ASCII, which
    a hostile header can contain).
    """
    auth = request.headers.get("Authorization", "")
    if auth[:7].lower() != "bearer ":
        return False
    given = auth[7:].encode("utf-8", "surrogateescape")
    return any(hmac.compare_digest(given, k.encode()) for k in keys)
