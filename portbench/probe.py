"""The benchmark's own spans and call log around the program's layers.

``Probe`` wraps, on one Transcriber instance and at run time, the calls
that cross a layer boundary: the slab cut (``_chunk_slab_pairs``), the
frontend and encoder (``_frontend_encode``), the language vote and the
decode loop (``_run_decode``).  It edits no line of the program.  Each
call appends to the log of the current item (what ``check`` judges), and
the encode and decode calls add to their spans; with ``sync`` (the
traced run) each span ends in a device synchronisation, so that it holds
the device's work.  Calls from other threads land in the log of the item
that thread is working on.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict

import torch


class Probe:
    def __init__(self, tr, sync: bool = False):
        self.tr, self.sync = tr, sync
        self.spans = defaultdict(float)  # seconds by span name
        self.decodes = []  # every DecodeResult, for the steps they ran
        self._tls = threading.local()
        self._lock = threading.Lock()
        for name in ("_chunk_slab_pairs", "_gather_state_rows", "_frontend_encode",
                     "_detect_language_voting", "_detect_languages_batch", "_run_decode",
                     "_collect_slab"):
            setattr(tr, name, getattr(self, name[1:])(getattr(tr, name)))

    # the log of the item the calling thread works on
    def begin(self) -> list:
        self._tls.log = []
        return self._tls.log

    def _log(self, entry) -> None:
        log = getattr(self._tls, "log", None)
        if log is not None:
            log.append(entry)

    def _end(self, name: str, t0: float) -> None:
        if self.sync:
            torch.cuda.synchronize()
        with self._lock:
            self.spans[name] += time.perf_counter() - t0

    def chunk_slab_pairs(self, fn):
        def wrapped(audios, pairs, bucket):
            self._log(("grid", list(pairs), bucket))
            return fn(audios, pairs, bucket)
        return wrapped

    def gather_state_rows(self, fn):
        def wrapped(bank, pairs, bucket):
            self._log(("grid", list(pairs), bucket))
            self._log(("gather", int(bucket)))
            return fn(bank, pairs, bucket)
        return wrapped

    def frontend_encode(self, fn):
        def wrapped(chunks):
            t0 = time.perf_counter()
            out = fn(chunks)
            self._end("encode", t0)
            self._log(("encode", int(chunks.shape[0])))
            return out
        return wrapped

    def detect_language_voting(self, fn):
        def wrapped(*args, **kw):
            lang = fn(*args, **kw)
            self._log(("lang", int(lang)))
            return lang
        return wrapped

    def detect_languages_batch(self, fn):
        def wrapped(*args, **kw):
            langs, bank = fn(*args, **kw)
            self._log(("langs", list(langs)))
            return langs, bank
        return wrapped

    def run_decode(self, fn):
        def wrapped(audio_states, *args, **kw):
            t0 = time.perf_counter()
            res = fn(audio_states, *args, **kw)
            self._end("decode", t0)
            with self._lock:
                self.decodes.append(res)
            lang = self.tr._active_language
            self._log(("decode", res, self.tr.language if lang is None else lang))
            return res
        return wrapped

    def collect_slab(self, fn):
        def wrapped(result, audio_states, n_real, *args, **kw):
            self._log(("collect", int(n_real), result))
            return fn(result, audio_states, n_real, *args, **kw)
        return wrapped

    def reset(self) -> None:
        """Forget what set-up did."""
        self.spans.clear()
        self.decodes.clear()

    def decode_steps(self) -> int:
        """Steps the decode loops ran: each runs until every row has
        emitted EOT, or to the cap."""
        cap = self.tr.max_new_tokens
        return sum(min(cap, int(r.lengths.max()) + 1) for r in self.decodes)
