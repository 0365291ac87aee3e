"""Streaming transcription: feed audio incrementally, collect segments.

The port of the JAX package's ``pipeline/streaming.py``, on the port's
``Transcriber``.  Windows are finalised and decoded as fixed 30 s chunks,
so every window decodes through the same slab shape; latency is bounded
by the window length plus one decode.

    st = StreamingTranscriber(transcriber)            # window mode, or
    st = StreamingTranscriber(transcriber, partial_step_s=2.0)  # low-latency
    for block in microphone():          # arbitrary-size float32 blocks
        for seg in st.feed(block):
            print(seg)                   # finalised {start, end, text}
    for seg in st.flush():               # final partial window
        print(seg)

The buffer holds source-rate samples; windows are cut in the raw
timeline and resampled whole (one contiguous resample a window), so no
filter edge lands at a feed() block boundary and the clock does not
drift by a block's rounding.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from ..ops import frontend

CHUNK = frontend.N_SAMPLES  # 480_000 samples / 30 s
WINDOW_S = 30.0


def _segment_words(segments: list[dict]) -> list[tuple[str, float, float]]:
    """Flatten segments into (word, seg_start, seg_end) triples: words carry
    their source segment's times (caption-grade approximation)."""
    out = []
    for seg in segments:
        for w in seg["text"].split():
            out.append((w, seg["start"], seg["end"]))
    return out


def _common_word_prefix(a: list, b: list) -> int:
    """Length of the longest common WORD-string prefix of two word lists."""
    n = 0
    for (wa, *_), (wb, *_) in zip(a, b):
        if wa != wb:
            break
        n += 1
    return n


@dataclass
class StreamingTranscriber:
    """Window mode by default; partial_step_s > 0 selects low-latency mode.

    Low-latency mode decodes the GROWING window every partial_step_s
    seconds of new audio and emits the longest WORD prefix two consecutive
    decodes agree on (the LocalAgreement policy of streaming ASR systems).
    Agreement spans the whole hypothesis, trailing segment included, and
    compares word strings, not timestamps (Whisper's timestamps jitter by a
    quantum as the padded context grows).  The partial buffer zero-pads to
    the 30 s window.  Window completion re-decodes the full window and
    emits everything past the already-emitted word prefix, so boundary
    resegmentation can briefly duplicate a word but never loses text.
    Emitted times are the source segment's (caption-grade).
    """

    transcriber: Any  # pipeline.transcribe.Transcriber
    sample_rate: int = 16_000
    partial_step_s: float = 0.0  # 0 = window mode
    _buffer: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    _emitted_s: float = 0.0  # global time already finalised (window starts)
    _partial_mark: int = 0  # buffer samples at the last partial decode
    _prev_words: list = field(default_factory=list)
    _emitted_words: list = field(default_factory=list)  # this window's output

    @property
    def _chunk_src(self) -> int:
        """One decode window in source-rate samples."""
        return int(round(WINDOW_S * self.sample_rate))

    def _to_16k(self, samples: np.ndarray) -> np.ndarray:
        if self.sample_rate == 16_000:
            return np.asarray(samples, np.float32)
        return frontend.resample_host(samples, self.sample_rate, device=self.transcriber.device)

    def feed(self, samples: np.ndarray) -> list[dict]:
        """Append audio; return segments as they finalise.

        Eager (not a generator): the block is buffered even when the caller
        ignores the return value, which window mode leaves empty for up to
        30 s.
        """
        self._buffer = np.concatenate([self._buffer, np.asarray(samples, np.float32)])
        out: list[dict] = []
        while len(self._buffer) >= self._chunk_src:
            window = self._buffer[: self._chunk_src]
            self._buffer = self._buffer[self._chunk_src :]
            out.extend(self._decode_window(window))
        if self.partial_step_s > 0 and (
            len(self._buffer) - self._partial_mark
            >= int(self.partial_step_s * self.sample_rate)
        ):
            out.extend(self._partial_decode())
        return out

    def flush(self) -> list[dict]:
        """Decode whatever remains (zero-padded to the window length)."""
        tail = self._buffer
        self._buffer = np.zeros(0, np.float32)
        if len(tail) >= int(0.5 * self.sample_rate):
            return list(self._decode_window(tail))
        # a discarded sub-0.5 s tail still advances the global clock: audio
        # fed after this flush starts at the real stream time
        self._emitted_s += len(tail) / self.sample_rate
        self._reset_window_state()
        return []

    def _reset_window_state(self) -> None:
        self._partial_mark = 0
        self._prev_words = []
        self._emitted_words = []

    def _segments_of(self, audio: np.ndarray) -> list[dict]:
        out = self.transcriber.transcribe(
            self._to_16k(audio), remove_silence=False, sample_rate=16_000
        )
        return out["segments"]

    def _emit_words(self, words: list[tuple[str, float, float]]) -> list[dict]:
        """Group consecutive words sharing a source segment -> one dict."""
        out = []
        i = 0
        while i < len(words):
            j = i
            while j + 1 < len(words) and words[j + 1][1:] == words[i][1:]:
                j += 1
            _, s, e = words[i]
            out.append({
                "start": round(s + self._emitted_s, 3),
                "end": round(e + self._emitted_s, 3),
                "text": " ".join(w for w, *_ in words[i : j + 1]),
            })
            i = j + 1
        return out

    def _partial_decode(self) -> list[dict]:
        """LocalAgreement: emit the word prefix two decodes agree on."""
        self._partial_mark = len(self._buffer)
        cur = _segment_words(self._segments_of(self._buffer))
        agreed = _common_word_prefix(self._prev_words, cur)
        # empty when nothing new is agreed, or when an earlier emission ran
        # ahead of the current agreement (the window finalise resolves it)
        fresh = cur[len(self._emitted_words) : agreed]
        out = self._emit_words(fresh)
        self._emitted_words.extend(fresh)
        self._prev_words = cur
        return out

    def _decode_window(self, window: np.ndarray) -> list[dict]:
        """Finalise a full window: emit everything past the emitted prefix.
        If the full-window decode resegmented and disagrees with what the
        partials emitted, emission restarts at the divergence point:
        duplication is possible there, text loss is not."""
        words = _segment_words(self._segments_of(window))
        agreed = _common_word_prefix(self._emitted_words, words)
        out = self._emit_words(words[agreed:])
        self._emitted_s += len(window) / self.sample_rate
        self._reset_window_state()
        return out
