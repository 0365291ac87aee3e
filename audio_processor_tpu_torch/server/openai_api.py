"""OpenAI-compatible audio endpoints: /v1/audio/transcriptions|translations.

A drop-in serving surface for OpenAI / whisper-server clients: multipart
uploads, the same form fields (file, model, language, prompt,
response_format, temperature, timestamp_granularities[]) and the same
response shapes (json / text / srt / vtt / verbose_json, error envelope
included).  The reference has no such surface — its engine is the same
whisper.transcribe the OpenAI API wraps (reference:
app/services/audio_processor.py:1076), so exposing the standard API makes
this framework a drop-in replacement for hosted transcription too.

The port of the JAX package's ``server/openai_api.py``: the same fields,
formats, error envelopes, slots and dynamic batcher, on the port's
``Transcriber``.  Decode options are applied per request by
dataclasses.replace on the shared Transcriber; its ``__post_init__`` casts
and moves nothing that is already cast and on its device, and keeps
sharded parameters as they are, so a replaced copy shares the weights.
``timestamp_granularities[]=word`` turns on ``word_timestamps`` for the
request.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import tempfile
import threading
import time
from typing import Any

from .web import Blueprint, Request, Response, StreamingResponse, jsonify

logger = logging.getLogger(__name__)

_FORMATS = ("json", "text", "srt", "verbose_json", "vtt")
_GRANULARITIES = ("word", "segment")

# stream=true holds a worker thread for the whole decode; cap concurrency
# so streams can't starve the request pool (same rationale as the job-SSE
# cap in api.py)
_stream_slots = {"active": 0}
_stream_lock = threading.Lock()

# EVERY /v1 decode (stream or not) also holds a device-decode slot: the
# slab cap (Transcriber.max_chunk_batch) budgets device memory for a small
# number of concurrent decodes, and without a gate each request thread
# could start its own full-slab decode — an out-of-memory error on the
# card.  Excess requests wait briefly, then 503.
_decode_slots = {"active": 0}
_decode_cond = threading.Condition()


def _acquire_stream_slot() -> bool:
    limit = int(os.environ.get("APTPU_MAX_TRANSCRIBE_STREAMS", "4"))
    with _stream_lock:
        if _stream_slots["active"] >= limit:
            return False
        _stream_slots["active"] += 1
        return True


def _release_stream_slot() -> None:
    with _stream_lock:
        _stream_slots["active"] -= 1


def _acquire_decode_slot() -> bool:
    limit = int(os.environ.get("APTPU_MAX_CONCURRENT_DECODES", "2"))
    timeout_s = float(os.environ.get("APTPU_DECODE_QUEUE_TIMEOUT_S", "60"))
    deadline = time.monotonic() + timeout_s
    with _decode_cond:
        while _decode_slots["active"] >= limit:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            _decode_cond.wait(remaining)
        _decode_slots["active"] += 1
        return True


def _release_decode_slot() -> None:
    with _decode_cond:
        _decode_slots["active"] -= 1
        _decode_cond.notify()


class _DecodeBusy(Exception):
    """Decode capacity unavailable within the queue timeout -> 503."""


class _BatchEntry:
    __slots__ = ("audio", "event", "result", "error")

    def __init__(self, audio):
        self.audio = audio
        self.event = threading.Event()
        self.result: dict | None = None
        self.error: BaseException | None = None


class _OpenBatch:
    __slots__ = ("entries", "closed", "full")

    def __init__(self):
        self.entries: list[_BatchEntry] = []
        self.closed = False
        self.full = threading.Event()  # set when max_files is reached


# cross-request dynamic batching (opt-in: APTPU_DYNAMIC_BATCH_WAIT_MS > 0).
# Concurrent non-stream uploads whose decode option sets are IDENTICAL
# coalesce into one Transcriber.transcribe_batch call: their 30 s windows
# pack into shared decode slabs, so N concurrent short clips cost ~one slab
# decode instead of N under-filled ones.  The first arrival becomes the
# batch LEADER: it waits the collection window, then decodes the whole
# batch under ONE decode slot while followers block on their entry events.
_open_batches: dict[Any, _OpenBatch] = {}
_batch_lock = threading.Lock()

# observability: batches formed / files coalesced (served by /api/metrics)
_batch_stats = {"batches": 0, "files": 0}


def dynamic_batch_stats() -> dict:
    """Counters for the dynamic batcher: batches dispatched, files they
    carried, mean occupancy.  Zeroes when batching is off/unused."""
    with _batch_lock:
        b, f = _batch_stats["batches"], _batch_stats["files"]
    return {
        "batches": b,
        "files": f,
        "mean_files_per_batch": round(f / b, 3) if b else 0.0,
    }


def _coalesced_transcribe(key, t, audio) -> dict:
    """Transcribe via the dynamic batcher (see _open_batches above).

    Raises _DecodeBusy when no decode slot frees up within the queue
    timeout; re-raises the leader's decode exception in every member.
    """
    wait_s = float(os.environ.get("APTPU_DYNAMIC_BATCH_WAIT_MS", "0")) / 1e3
    max_files = int(os.environ.get("APTPU_DYNAMIC_BATCH_MAX_FILES", "16"))
    entry = _BatchEntry(audio)
    with _batch_lock:
        batch = _open_batches.get(key)
        leader = (
            batch is None or batch.closed or len(batch.entries) >= max_files
        )
        if leader:
            batch = _OpenBatch()
            _open_batches[key] = batch
        batch.entries.append(entry)
        if len(batch.entries) >= max_files:
            batch.full.set()
    if leader:
        try:
            # collection window; a full batch ends it early (no point
            # holding max_files responses for the rest of the window)
            batch.full.wait(wait_s)
            with _batch_lock:
                batch.closed = True
                if _open_batches.get(key) is batch:
                    del _open_batches[key]
            entries = batch.entries
            if not _acquire_decode_slot():
                raise _DecodeBusy()
            try:
                if len(entries) > 1:
                    logger.info(
                        "dynamic batch: %d concurrent uploads in one "
                        "shared-slab decode", len(entries),
                    )
                results = t.transcribe_batch([e.audio for e in entries])
            finally:
                _release_decode_slot()
            if len(results) != len(entries):  # defensive: must never happen
                raise RuntimeError(
                    f"transcribe_batch returned {len(results)} results "
                    f"for {len(entries)} files"
                )
            for e, r in zip(entries, results):
                e.result = r
            # counted only on a delivered decode: a 503/failed dispatch
            # must not inflate the coalescing-throughput metrics
            with _batch_lock:
                _batch_stats["batches"] += 1
                _batch_stats["files"] += len(entries)
        except BaseException as exc:  # noqa: BLE001 — fan the failure out
            with _batch_lock:  # close FIRST so no newcomer misses the error
                batch.closed = True
                if _open_batches.get(key) is batch:
                    del _open_batches[key]
            for e in batch.entries:
                if e.result is None:
                    e.error = exc
        finally:
            # ALWAYS close + wake, even if the wait itself raised —
            # a leaderless open batch would swallow every later request
            with _batch_lock:
                batch.closed = True
                if _open_batches.get(key) is batch:
                    del _open_batches[key]
            for e in batch.entries:
                e.event.set()
    else:
        # bounded wait sized for worst-case decode (first kernel build +
        # multi-hour uploads); it only fires if the leader thread died,
        # since the leader's finally always sets the event
        timeout_s = float(
            os.environ.get("APTPU_DECODE_QUEUE_TIMEOUT_S", "60")
        ) + 3600.0
        if not entry.event.wait(timeout_s):
            raise _DecodeBusy()
    if entry.error is not None:
        raise entry.error
    if entry.result is None:
        raise _DecodeBusy()
    return entry.result


def _check_auth(request: Request):
    """Optional Bearer auth for the /v1 surface (OpenAI clients always
    send ``Authorization: Bearer <key>``).  APTPU_API_KEYS holds one or
    more comma-separated accepted keys; unset = open (the default for the
    reference's LAN deployment).  Returns an error response or None."""
    from .security import bearer_key_ok, configured_keys

    keys = configured_keys()
    if not keys or bearer_key_ok(request, keys):
        return None
    return _error(
        "Incorrect API key provided.", param=None, status=401
    )


def _error(message: str, param: str | None = None, status: int = 400):
    """OpenAI's error envelope."""
    return jsonify(
        {
            "error": {
                "message": message,
                "type": (
                    "invalid_request_error" if status < 500 else "server_error"
                ),
                "param": param,
                "code": None,
            }
        },
        status=status,
    )


def _verbose_segment(seg: dict) -> dict:
    """Segment dict in the OpenAI verbose_json field order/surface."""
    out = {
        "id": seg.get("id", 0),
        "seek": seg.get("seek", 0),
        "start": seg["start"],
        "end": seg["end"],
        "text": seg["text"],
        "tokens": seg.get("tokens", []),
        "temperature": seg.get("temperature", 0.0),
        "avg_logprob": seg.get("avg_logprob", 0.0),
        "compression_ratio": seg.get("compression_ratio", 0.0),
        "no_speech_prob": seg.get("no_speech_prob", 0.0),
    }
    return out


# fixed "created" stamp for model listings (clients treat it as opaque)
_MODELS_CREATED = 1677532384


def _model_ids(services: Any) -> list[str]:
    """Servable model ids: the OpenAI alias plus the configured variant."""
    ids = ["whisper-1"]
    t = getattr(services.processor, "transcriber", None)
    name = getattr(getattr(t, "cfg", None), "name", None)
    if name and name not in ids:
        ids.append(name)
    return ids


def _model_obj(model_id: str) -> dict:
    return {
        "id": model_id,
        "object": "model",
        "created": _MODELS_CREATED,
        "owned_by": "audio-processor-tpu",
    }


def make_openai_blueprint(services: Any) -> Blueprint:
    bp = Blueprint("openai", url_prefix="/v1")

    @bp.route("/audio/transcriptions", methods=("POST",))
    def transcriptions(request: Request):
        return _check_auth(request) or _handle(
            request, services, task="transcribe"
        )

    @bp.route("/audio/translations", methods=("POST",))
    def translations(request: Request):
        return _check_auth(request) or _handle(
            request, services, task="translate"
        )

    @bp.route("/models", methods=("GET",))
    def models(request: Request):
        # OpenAI clients probe this for connectivity/model discovery
        denied = _check_auth(request)
        if denied:
            return denied
        return jsonify({
            "object": "list",
            "data": [_model_obj(i) for i in _model_ids(services)],
        })

    @bp.route("/models/<model_id>", methods=("GET",))
    def model(request: Request, model_id: str):
        denied = _check_auth(request)
        if denied:
            return denied
        if model_id not in _model_ids(services):
            return _error(
                f"The model {model_id!r} does not exist",
                param="model",
                status=404,
            )
        return jsonify(_model_obj(model_id))

    return bp


def _sse(event: str, obj: dict) -> str:
    import json

    return f"event: {event}\ndata: {json.dumps(obj)}\n\n"


def _stream_transcription(t, audio) -> StreamingResponse:
    """OpenAI's streaming transcription events: one transcript.text.delta
    per decoded segment, then transcript.text.done with the full text.
    The decode runs in a worker thread; segments flow through a queue as
    their windows drain (Transcriber's on_segment callback)."""
    import queue
    import threading

    q: queue.Queue = queue.Queue()

    def run():
        got_slot = False
        try:
            got_slot = _acquire_decode_slot()
            if not got_slot:
                q.put(("error", {"type": "error", "error": {
                    "message": "too many concurrent decodes; retry later"}}))
                return
            result = t.transcribe(audio, on_segment=lambda seg: q.put(
                ("transcript.text.delta",
                 {"type": "transcript.text.delta", "delta": seg["text"]})
            ))
            q.put((
                "transcript.text.done",
                {"type": "transcript.text.done",
                 "text": result["text"].strip()},
            ))
        except Exception as e:  # noqa: BLE001 — surfaced as an SSE error
            logger.exception("streaming transcription failed")
            q.put(("error", {"type": "error",
                             "error": {"message": str(e)}}))
        finally:
            if got_slot:
                _release_decode_slot()
            q.put(None)

    threading.Thread(target=run, daemon=True).start()

    def gen():
        while True:
            item = q.get()
            if item is None:
                break
            yield _sse(*item)

    # slot release rides on_close (fires exactly once, even when the
    # response is closed before its first iteration — a generator finally
    # would be skipped there and leak the slot)
    return StreamingResponse(gen(), on_close=_release_stream_slot)


def _handle(request: Request, services: Any, task: str):
    from ..models.whisper.tokenizer import LANGUAGE_NAMES, language_index
    from ..pipeline import ingest

    try:
        fields, files = request.form()
    except ValueError as e:
        return _error(str(e))
    if "file" not in files:
        return _error("'file' is a required property", param="file")
    filename, payload = files["file"]
    if not payload:
        return _error("The uploaded file is empty.", param="file")

    def field(name: str) -> str | None:
        vals = fields.get(name)
        return vals[0] if vals else None

    fmt = field("response_format") or "json"
    if fmt not in _FORMATS:
        return _error(
            f"response_format must be one of {_FORMATS}, got {fmt!r}",
            param="response_format",
        )
    grans = fields.get("timestamp_granularities[]") or fields.get(
        "timestamp_granularities", []
    )
    for g in grans:
        if g not in _GRANULARITIES:
            return _error(
                f"timestamp_granularities entries must be one of "
                f"{_GRANULARITIES}, got {g!r}",
                param="timestamp_granularities",
            )
    if grans and fmt != "verbose_json":
        return _error(
            "timestamp_granularities requires response_format=verbose_json",
            param="timestamp_granularities",
        )

    t = getattr(services.processor, "transcriber", None)
    if t is None:
        return _error("no transcription model is configured", status=503)
    changes: dict[str, Any] = {}
    if task != t.task:
        changes["task"] = task
    lang = field("language")
    if lang:
        if task == "translate":
            return _error(
                "language is not supported for translations",
                param="language",
            )
        try:
            changes["language"] = language_index(
                lang, t.special.num_languages
            )
        except ValueError:
            return _error(f"unsupported language {lang!r}", param="language")
    prompt = field("prompt")
    if prompt:
        changes["initial_prompt"] = prompt
    temp_raw = field("temperature")
    if temp_raw is not None:
        try:
            temp = float(temp_raw)
        except ValueError:
            return _error(
                f"temperature must be a number, got {temp_raw!r}",
                param="temperature",
            )
        if not 0.0 <= temp <= 1.0:
            return _error(
                "temperature must be between 0 and 1", param="temperature"
            )
        if temp != t.temperature:
            changes["temperature"] = temp
    if "word" in grans and not t.word_timestamps:
        changes["word_timestamps"] = True

    if changes:
        try:
            # a mesh proxy (parallel/controller.py) replaces its object and
            # has the other ranks replace theirs alike
            rebuild = getattr(t, "replace", None)
            t = rebuild(**changes) if rebuild else dataclasses.replace(t, **changes)
        except ValueError as e:
            return _error(str(e))

    stream = (field("stream") or "").lower() in ("true", "1")
    if stream and fmt not in ("json", "text"):
        return _error(
            "stream=true supports response_format json or text only",
            param="stream",
        )

    suffix = os.path.splitext(filename or "")[1] or ".wav"
    tmp = tempfile.NamedTemporaryFile(suffix=suffix, delete=False)
    try:
        tmp.write(payload)
        tmp.close()
        try:
            audio = ingest.load_audio(tmp.name)
        except Exception as e:  # noqa: BLE001 — any decode failure is a 400
            logger.info("openai api: undecodable upload %r: %s", filename, e)
            return _error(
                "The audio file could not be decoded or its format is "
                "not supported.",
                param="file",
            )
    finally:
        tmp.close()
        os.unlink(tmp.name)

    if stream:
        if not _acquire_stream_slot():
            return _error(
                "too many concurrent transcription streams; retry without "
                "stream or later",
                param="stream",
                status=503,
            )
        try:
            return _stream_transcription(t, audio)
        except BaseException:
            # e.g. Thread.start() failing under fd/thread exhaustion —
            # the slot was already taken and no response owns it yet
            _release_stream_slot()
            raise

    if (
        float(os.environ.get("APTPU_DYNAMIC_BATCH_WAIT_MS", "0")) > 0
        and getattr(t, "supports_shared_slabs", False)
    ):
        # identical option sets coalesce into one shared-slab decode; the
        # key is canonical because `changes` holds only deltas from the
        # ONE shared base transcriber
        key = (id(services.processor), task,
               tuple(sorted(changes.items())))
        try:
            result = _coalesced_transcribe(key, t, audio)
        except _DecodeBusy:
            return _error(
                "too many concurrent transcriptions; retry later",
                status=503,
            )
    else:
        if not _acquire_decode_slot():
            return _error(
                "too many concurrent transcriptions; retry later",
                status=503,
            )
        try:
            result = t.transcribe(audio)
        finally:
            _release_decode_slot()

    text = result["text"].strip()
    if fmt == "json":
        return jsonify({"text": text})
    if fmt == "text":
        return Response(text + "\n", content_type="text/plain; charset=utf-8")
    if fmt in ("srt", "vtt"):
        from ..utils import writers

        return Response(
            writers.format_segments(result["segments"], fmt),
            content_type="text/plain; charset=utf-8",
        )
    # verbose_json.  Default granularity is segment; words appear only
    # when requested, and segments disappear when ONLY word is requested.
    code = result.get("language", "en")
    out: dict[str, Any] = {
        "task": task,
        "language": LANGUAGE_NAMES.get(code, code),
        "duration": result["duration"],
        "text": text,
    }
    if "word" in grans:
        out["words"] = [
            {"word": w["word"], "start": w["start"], "end": w["end"]}
            for seg in result["segments"]
            for w in seg.get("words", [])
        ]
    if "segment" in grans or "word" not in grans:
        out["segments"] = [_verbose_segment(s) for s in result["segments"]]
    return jsonify(out)
