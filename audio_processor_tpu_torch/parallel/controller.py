"""The mesh service's controller: rank 0 serves, the other ranks follow.

Under ``APTPU_DISTRIBUTED=1`` every rank is a process that holds the same
Transcribers and Diarizer on a (data, model) mesh, and one call of theirs
is a sequence of collectives that every rank must enter in the same
order.  If two ranks took different jobs, one rank's all-reduces would
pair with another job's.  So only rank 0 serves HTTP and runs the job
engine; its Transcribers and Diarizer are wrapped in ``MeshProxy``s, and
each proxied call

  1. takes one process-wide lock (job workers and the ``/v1`` batcher call
     from several threads: two calls' collectives must never interleave);
  2. broadcasts the call from rank 0: the object ("primary", "fallback",
     "diarizer"), the method (``transcribe``, ``transcribe_batch``,
     ``diarize``, ``warmup``), the ``dataclasses.replace`` changes a
     ``/v1`` request applied, the Diarizer's speaker bounds, the keyword
     arguments without callbacks, and the audio as a tensor;
  3. runs the call itself, its callbacks held: an exception of theirs is
     raised once the call is over, so the call's collectives stay in step;
  4. gathers how the call ended on every rank.

The other ranks sit in ``follow()``: they replay each call with the
callbacks set to None and drop the result, then take part in step 4.
When every rank's call ended alike (all returned, or all raised the same
type of exception, as the inputs decide for a ``ValueError`` from options
or an out-of-memory error on a long recording), the world serves on and
rank 0's caller sees the exception as in one process: the job fails or
takes its fallback Transcriber.  When the ranks disagree (one rank's own
failure, a collective that failed or timed out) every rank ends its
process with a non-zero exit.  A rank that fails alone first leaves its
peers in a collective of the mesh, which fails after the process group's
timeout (``APTPU_DIST_TIMEOUT_S``), so the world ends instead of hanging.

The calls and step 4 go over a gloo group of their own (``control_group``)
whose timeout is long: the followers wait there for as long as rank 0 is
idle, and a rank that dies closes its sockets, which gloo reports to the
others at once.  ``stop()`` sends the message that ends the followers'
loop.  JAX needs none of this: its one controller launches each jitted
program on every device at once.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import sys
import threading
import time
import traceback
from typing import Any

import numpy as np
import torch

from ..pipeline import ingest
from . import mesh as mesh_lib

logger = logging.getLogger(__name__)

_CALLBACKS = ("progress", "on_segment")
# how long the followers wait for rank 0's next call: as long as it serves
IDLE_TIMEOUT_S = 365 * 24 * 3600.0


def _end_world(what: str) -> None:
    """The ranks disagree: log it and exit non-zero at once (the other
    ranks see this one's sockets close, or leave their collectives at the
    group's timeout)."""
    logger.error("mesh controller: %s; ending this rank", what)
    logging.shutdown()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(1)


def _outcome(exc: BaseException | None, rank: int) -> str | None:
    """How a rank's call ended, to compare over the world: None, the
    exception's type, or, for a failure inside a collective (a peer that
    failed alone, a timeout), an outcome no other rank shares."""
    if exc is None:
        return None
    if any(f"torch{os.sep}distributed" in f.filename
           for f in traceback.extract_tb(exc.__traceback__)):
        return f"a collective failed on rank {rank}"
    return type(exc).__qualname__


class Controller:
    """One mesh call at a time, started on rank 0 and replayed by the other
    ranks.  ``objects`` maps a role to the rank's own Transcriber or
    Diarizer (the same roles on every rank; a role may be None).  Every
    rank makes its Controller at the same point: it makes the control
    group."""

    def __init__(self, mesh, objects: dict[str, Any]):
        self.mesh = mesh
        self.objects = {k: v for k, v in objects.items() if v is not None}
        self.rank = mesh.data_rank * mesh.tp + mesh.model_rank  # make_mesh's layout
        self.group = mesh_lib.control_group(IDLE_TIMEOUT_S)
        self._lock = threading.Lock()
        self._stopped = False
        self._replaced: dict = {}  # followers: (role, changes) -> rebuilt object
        # rank 0: calls made and seconds the mesh spent in them (the lock
        # held), which a serving run reads as the mesh's busy share
        self.calls = 0
        self.busy_s = 0.0

    @property
    def is_leader(self) -> bool:
        return self.rank == 0

    def _settle(self, exc: BaseException | None, what: str) -> None:
        """Step 4: every rank's outcome of the call; end the world unless
        they all agree."""
        try:
            outcomes = mesh_lib.world_gather_object(_outcome(exc, self.rank), self.group)
        except Exception:  # noqa: BLE001 -- a peer is gone
            _end_world(f"{what}: gathering the outcomes failed")
        if len(set(outcomes)) > 1:
            if exc is not None:
                logger.error("mesh controller: %s raised on rank %d", what, self.rank,
                             exc_info=exc)
            _end_world(f"{what} ended differently on the ranks: {outcomes}")

    # -- rank 0 ------------------------------------------------------------

    def proxy(self, role: str) -> "MeshProxy | None":
        """Rank 0's stand-in for the object of ``role`` (None if unset)."""
        obj = self.objects.get(role)
        return None if obj is None else MeshProxy(self, role, obj, {})

    def call(self, proxy: "MeshProxy", method: str, args: tuple, kw: dict):
        """Rank 0: broadcast the call, then run it on the proxied object
        (whose own inner calls, such as ``warmup``'s ``transcribe``, reach
        the object itself: the followers replay only the outer call)."""
        target = proxy._target
        with self._lock:
            if self._stopped:
                raise RuntimeError("the mesh controller has stopped")
            t0 = time.perf_counter()
            if self.mesh.device.type == "cuda":
                torch.cuda.set_device(self.mesh.device)  # a job thread starts on card 0
            audio_arg, rest = (args[0], args[1:]) if args else (None, ())
            kw = dict(kw)
            if method in ("transcribe", "diarize") and isinstance(audio_arg, (str, os.PathLike)):
                # rank 0 reads the file: the followers may not see it
                sr = ingest.TARGET_SR if method == "transcribe" else target.seg_cfg.sample_rate
                audio_arg, kw["sample_rate"] = ingest.load_if_path(audio_arg, sr, target_sr=sr)
            if method == "transcribe_batch":
                sr = kw.get("sample_rate", ingest.TARGET_SR)
                audio_arg = [ingest.load_if_path(a, sr, target_sr=sr)[0] for a in audio_arg]
            header, tensor = _pack(audio_arg)
            header.update(
                op="call", role=proxy._role, method=method, changes=proxy._changes, args=rest,
                kwargs={k: v for k, v in kw.items() if k not in _CALLBACKS},
                bounds=_bounds(target),
            )
            try:
                self._send(header, tensor)
            except Exception:  # noqa: BLE001
                _end_world("broadcasting a call failed")
            held: list[BaseException] = []
            for name in _CALLBACKS:
                if kw.get(name) is not None:
                    kw[name] = _held(kw[name], held)
            call_args = rest if header["audio"] is None else (audio_arg, *rest)
            try:
                out, exc = getattr(target, method)(*call_args, **kw), None
            except BaseException as e:  # noqa: BLE001 -- settled over the world below
                out, exc = None, e
            self._settle(exc, f"{proxy._role}.{method}")
            self.calls += 1
            self.busy_s += time.perf_counter() - t0
        if exc is not None:
            raise exc
        if held:
            raise held[0]
        return out

    def _send(self, header: dict, audio: torch.Tensor | None = None) -> None:
        mesh_lib.broadcast_object(header, self.group)
        if audio is not None:
            mesh_lib.broadcast(audio, self.group)

    def stop(self) -> None:
        """Rank 0: end the followers' loop (idempotent)."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            if self.is_leader:
                self._send({"op": "stop"})

    # -- ranks > 0 ---------------------------------------------------------

    def follow(self) -> None:
        """Ranks > 0: replay rank 0's calls until the stop message."""
        while True:
            header = mesh_lib.broadcast_object(None, self.group)
            if header["op"] == "stop":
                logger.info("mesh follower %d: stop", self.rank)
                return
            tensor = None
            if header["audio"] is not None and header["numel"]:
                tensor = torch.empty(header["numel"], dtype=getattr(torch, header["dtype"]))
                mesh_lib.broadcast(tensor, self.group)
            target = self._target(header["role"], header["changes"])
            if header["bounds"] is not None:
                target.min_speakers, target.max_speakers = header["bounds"]
            audio = _unpack(header, tensor)
            args = header["args"] if header["audio"] is None else (audio, *header["args"])
            what = f"{header['role']}.{header['method']}"
            try:  # the callbacks were left out: they default to None
                getattr(target, header["method"])(*args, **header["kwargs"])
                exc = None
            except BaseException as e:  # noqa: BLE001 -- settled over the world below
                exc = e
            self._settle(exc, what)
            if exc is not None:
                logger.warning("mesh follower %d: %s raised %r on every rank", self.rank,
                               what, exc)

    def _target(self, role: str, changes: dict):
        base = self.objects[role]
        if not changes:
            return base
        key = (role, tuple(sorted(changes.items())))
        if key not in self._replaced:
            if len(self._replaced) >= 8:
                self._replaced.pop(next(iter(self._replaced)))
            self._replaced[key] = dataclasses.replace(base, **changes)
        return self._replaced[key]


def _held(fn, held: list):
    """``fn`` with its first exception kept in ``held`` (and its later calls
    skipped) instead of raised inside the mesh call."""
    def run(*args, **kw):
        if held:
            return None
        try:
            return fn(*args, **kw)
        except Exception as exc:  # noqa: BLE001 -- raised after the call
            held.append(exc)
            return None
    return run


def _bounds(target) -> tuple | None:
    """The Diarizer's speaker bounds (None for a Transcriber)."""
    if hasattr(target, "min_speakers"):
        return (target.min_speakers, target.max_speakers)
    return None


def _pack(audio) -> tuple[dict, torch.Tensor | None]:
    """A call's audio (None, one array, or a list of arrays for
    ``transcribe_batch``) as one flat tensor and the header that cuts it."""
    if audio is None:
        return {"audio": None}, None
    arrays = audio if isinstance(audio, list) else [audio]
    arrays = [np.asarray(a) for a in arrays]
    dtype = np.result_type(*arrays) if arrays else np.float32
    flat = np.concatenate([a.reshape(-1).astype(dtype) for a in arrays]) if arrays else \
        np.zeros(0, dtype)
    header = {"audio": "list" if isinstance(audio, list) else "array",
              "sizes": [a.size for a in arrays], "numel": int(flat.size),
              "dtype": str(torch.from_numpy(flat[:0]).dtype).removeprefix("torch.")}
    return header, torch.from_numpy(np.ascontiguousarray(flat)) if flat.size else None


def _unpack(header: dict, tensor: torch.Tensor | None):
    if header["audio"] is None:
        return None
    flat = np.zeros(0, np.float32) if tensor is None else tensor.numpy()
    parts = np.split(flat, np.cumsum(header["sizes"])[:-1])
    return list(parts) if header["audio"] == "list" else parts[0]


class MeshProxy:
    """Rank 0's stand-in for a Transcriber or Diarizer on the mesh: the
    four calls below go through the controller, every other attribute is
    the object's own.  ``replace(**changes)`` is
    ``dataclasses.replace`` on the object (a ``/v1`` request's options),
    remembered so that the followers rebuild the same object."""

    def __init__(self, controller: Controller, role: str, target, changes: dict):
        object.__setattr__(self, "_controller", controller)
        object.__setattr__(self, "_role", role)
        object.__setattr__(self, "_target", target)
        object.__setattr__(self, "_changes", dict(changes))

    def __getattr__(self, name):
        return getattr(self._target, name)

    def __setattr__(self, name, value):
        setattr(self._target, name, value)

    def replace(self, **changes) -> "MeshProxy":
        target = dataclasses.replace(self._target, **changes)
        return MeshProxy(self._controller, self._role, target, {**self._changes, **changes})

    def transcribe(self, audio, **kw):
        return self._controller.call(self, "transcribe", (audio,), kw)

    def transcribe_batch(self, audios, **kw):
        return self._controller.call(self, "transcribe_batch", (list(audios),), kw)

    def diarize(self, audio, sample_rate: int = 16_000, **kw):
        return self._controller.call(self, "diarize", (audio,), dict(kw, sample_rate=sample_rate))

    def warmup(self, n_chunks: int | None = None):
        return self._controller.call(self, "warmup", (), {"n_chunks": n_chunks})
