"""Minimal first-party PDF text extraction (no PyPDF2 in the image).

The reference downloads PDF attachments and extracts text with PyPDF2 to
feed the summary prompt (reference:
app/services/audio_processor.py:274-303).  This extractor handles the
common case natively: walks PDF objects, inflates FlateDecode content
streams, and collects text-showing operators (Tj, TJ, ', ") including
hex strings.  Exotic encodings (CID fonts etc.) degrade gracefully to
partial/empty text — the summary prompt treats attachment text as
best-effort context anyway.

A copy of the JAX package's ``integrations/pdf.py``: the PyTorch package
imports nothing of that package.
"""
from __future__ import annotations

import logging
import re
import zlib

logger = logging.getLogger(__name__)

_STREAM_RE = re.compile(rb"stream\r?\n(.*?)(?:\r?\n)?endstream", re.DOTALL)
_TEXT_OP_RE = re.compile(
    rb"(\((?:\\.|[^\\()])*\)|<[0-9A-Fa-f\s]+>)\s*(Tj|'|\")" rb"|\[((?:\((?:\\.|[^\\()])*\)|<[0-9A-Fa-f\s]+>|[-0-9.\s])+)\]\s*TJ"
)
_STRING_RE = re.compile(rb"\((?:\\.|[^\\()])*\)|<[0-9A-Fa-f\s]+>")

_ESCAPES = {
    b"n": b"\n", b"r": b"\r", b"t": b"\t", b"b": b"\b", b"f": b"\f",
    b"(": b"(", b")": b")", b"\\": b"\\",
}


def _decode_pdf_string(raw: bytes) -> bytes:
    if raw.startswith(b"<"):  # hex string
        hexstr = re.sub(rb"\s", b"", raw[1:-1])
        if len(hexstr) % 2:
            hexstr += b"0"
        try:
            data = bytes.fromhex(hexstr.decode("ascii"))
        except ValueError:
            return b""
        # UTF-16BE BOM or 2-byte CID-ish content: best-effort decode
        if data.startswith(b"\xfe\xff"):
            try:
                return data[2:].decode("utf-16-be").encode("utf-8")
            except UnicodeDecodeError:
                return b""
        return data
    # literal string: handle escapes
    out = bytearray()
    i = 1
    end = len(raw) - 1
    while i < end:
        c = raw[i : i + 1]
        if c == b"\\" and i + 1 < end:
            nxt = raw[i + 1 : i + 2]
            if nxt in _ESCAPES:
                out += _ESCAPES[nxt]
                i += 2
                continue
            if nxt.isdigit():  # octal escape
                oct_digits = raw[i + 1 : i + 4]
                m = re.match(rb"[0-7]{1,3}", oct_digits)
                if m:
                    out.append(int(m.group(0), 8) & 0xFF)
                    i += 1 + len(m.group(0))
                    continue
            i += 2
            continue
        out += c
        i += 1
    return bytes(out)


def extract_text(pdf_bytes: bytes) -> str:
    """Best-effort text extraction from a PDF's content streams."""
    if not pdf_bytes.startswith(b"%PDF"):
        return ""
    chunks: list[str] = []
    for m in _STREAM_RE.finditer(pdf_bytes):
        stream = m.group(1)
        # try raw and inflated forms
        candidates = [stream]
        try:
            candidates.insert(0, zlib.decompress(stream))
        except zlib.error:
            pass
        for data in candidates:
            if b"Tj" not in data and b"TJ" not in data and b"'" not in data:
                continue
            text_parts: list[bytes] = []
            for tm in _TEXT_OP_RE.finditer(data):
                if tm.group(1):  # Tj / ' / "
                    text_parts.append(_decode_pdf_string(tm.group(1)))
                elif tm.group(3):  # TJ array
                    for sm in _STRING_RE.finditer(tm.group(3)):
                        text_parts.append(_decode_pdf_string(sm.group(0)))
                    text_parts.append(b" ")
                if tm.group(2) in (b"'", b'"'):
                    text_parts.append(b"\n")
            if text_parts:
                try:
                    chunks.append(b"".join(text_parts).decode("utf-8", errors="ignore"))
                except Exception:  # noqa: BLE001
                    pass
            break
    text = "\n".join(c for c in chunks if c.strip())
    return text.strip()


def extract_text_from_file(path: str) -> str:
    try:
        with open(path, "rb") as f:
            return extract_text(f.read())
    except OSError as exc:
        logger.warning("cannot read PDF %s: %s", path, exc)
        return ""
