"""Transcript output writers: txt / srt / vtt / tsv / json.

The reference consumes transcripts programmatically (Notion/Gemini), but
the engine it ships is openai-whisper, whose CLI users rely on the
standard subtitle formats (whisper's --output_format).  These are the
same behavioural contracts re-implemented first-party:

  * srt: 1-indexed cues, `HH:MM:SS,mmm --> HH:MM:SS,mmm`, blank-line
    separated
  * vtt: `WEBVTT` header, `MM:SS.mmm` timestamps (hours only when needed)
  * tsv: integer-millisecond `start\tend\ttext` rows with a header line
  * txt: one segment's text per line

When segments carry per-word timings (``segment["words"]``, from
word_timestamps=True), srt/vtt support openai's word-level options —
``highlight_words`` (a <u>-underlined cue per word), ``max_line_width``,
``max_line_count`` and ``max_words_per_line`` line-wrapping — with the
same cue-splitting rules as whisper/utils.py SubtitlesWriter.

Segments are the pipeline's `{"start": s, "end": s, "text": str}` dicts
(the same schema the fusion stage consumes, reference:
app/services/audio_processor.py:1114-1119).

A copy of the JAX package's ``utils/writers.py``: the PyTorch package
imports nothing of that package.
"""
from __future__ import annotations

import re


def _timestamp(seconds: float, *, always_hours: bool, decimal: str) -> str:
    ms = max(0, round(seconds * 1000.0))
    hours, ms = divmod(ms, 3_600_000)
    minutes, ms = divmod(ms, 60_000)
    secs, ms = divmod(ms, 1000)
    hours_part = f"{hours:02d}:" if always_hours or hours > 0 else ""
    return f"{hours_part}{minutes:02d}:{secs:02d}{decimal}{ms:03d}"


def _iterate_subtitles(
    segments: list[dict],
    max_line_width: int | None,
    max_line_count: int | None,
    max_words_per_line: int | None,
):
    """openai's SubtitlesWriter.iterate_subtitles: group word timings into
    display lines/cues.  Yields lists of word dicts whose "word" text may
    gain a leading newline (line break within one cue)."""
    preserve_segments = max_line_count is None or max_line_width is None
    line_width = max_line_width or 1000
    words_per_line = max_words_per_line or 1000
    line_len = 0
    line_count = 1
    subtitle: list[dict] = []
    last = segments[0]["words"][0]["start"] if segments[0].get("words") else 0.0
    for segment in segments:
        chunk_index = 0
        seg_words = segment.get("words") or []
        while chunk_index < len(seg_words):
            count = min(words_per_line, len(seg_words) - chunk_index)
            for i, original in enumerate(seg_words[chunk_index : chunk_index + count]):
                timing = dict(original)
                long_pause = not preserve_segments and timing["start"] - last > 3.0
                has_room = line_len + len(timing["word"]) <= line_width
                seg_break = i == 0 and subtitle and preserve_segments
                if line_len > 0 and has_room and not long_pause and not seg_break:
                    line_len += len(timing["word"])
                else:
                    timing["word"] = timing["word"].strip()
                    if (
                        subtitle
                        and max_line_count is not None
                        and (long_pause or line_count >= max_line_count)
                    ) or seg_break:
                        yield subtitle
                        subtitle = []
                        line_count = 1
                    elif line_len > 0:
                        line_count += 1
                        timing["word"] = "\n" + timing["word"]
                    line_len = len(timing["word"].strip())
                subtitle.append(timing)
                last = timing["start"]
            chunk_index += count
    if subtitle:
        yield subtitle


def _iterate_cues(
    segments: list[dict],
    *,
    highlight_words: bool = False,
    max_line_width: int | None = None,
    max_line_count: int | None = None,
    max_words_per_line: int | None = None,
):
    """Yield (start_s, end_s, text) display cues.

    Word-timed segments follow openai's SubtitlesWriter.iterate_result;
    plain segments yield one cue each."""
    def _plain_cue(seg):
        return seg["start"], seg["end"], seg["text"].strip().replace("-->", "->")

    def _word_cues(run):
        for subtitle in _iterate_subtitles(
            run, max_line_width, max_line_count, max_words_per_line
        ):
            start, end = subtitle[0]["start"], subtitle[-1]["end"]
            text = "".join(w["word"] for w in subtitle)
            if highlight_words:
                last = start
                all_words = [w["word"] for w in subtitle]
                for i, this_word in enumerate(subtitle):
                    if last != this_word["start"]:
                        yield last, this_word["start"], text
                    yield this_word["start"], this_word["end"], "".join(
                        re.sub(r"^(\s*)(.*)$", r"\1<u>\2</u>", w, flags=re.DOTALL)
                        if j == i
                        else w
                        for j, w in enumerate(all_words)
                    )
                    last = this_word["end"]
            else:
                yield start, end, text

    # word-timed runs get openai's word-cue treatment; a segment whose
    # words list came out empty (the midpoint matcher can miss near window
    # edges) still emits its text as a plain cue instead of vanishing
    if not any(seg.get("words") for seg in segments):
        for seg in segments:
            yield _plain_cue(seg)
        return
    i = 0
    while i < len(segments):
        if segments[i].get("words"):
            j = i
            while j < len(segments) and segments[j].get("words"):
                j += 1
            yield from _word_cues(segments[i:j])
            i = j
        else:
            yield _plain_cue(segments[i])
            i += 1


def to_txt(segments: list[dict], **_unused) -> str:
    return "\n".join(seg["text"].strip() for seg in segments) + "\n"


def to_srt(segments: list[dict], **options) -> str:
    out = []
    for i, (start_s, end_s, text) in enumerate(
        _iterate_cues(segments, **options), start=1
    ):
        start = _timestamp(start_s, always_hours=True, decimal=",")
        end = _timestamp(end_s, always_hours=True, decimal=",")
        out.append(f"{i}\n{start} --> {end}\n{text}\n")
    return "\n".join(out)


def to_vtt(segments: list[dict], **options) -> str:
    out = ["WEBVTT\n"]
    for start_s, end_s, text in _iterate_cues(segments, **options):
        start = _timestamp(start_s, always_hours=False, decimal=".")
        end = _timestamp(end_s, always_hours=False, decimal=".")
        out.append(f"{start} --> {end}\n{text}\n")
    return "\n".join(out)


def to_tsv(segments: list[dict], **_unused) -> str:
    rows = ["start\tend\ttext"]
    for seg in segments:
        rows.append(
            f"{round(seg['start'] * 1000)}\t{round(seg['end'] * 1000)}\t"
            f"{seg['text'].strip()}"
        )
    return "\n".join(rows) + "\n"


FORMATTERS = {"txt": to_txt, "srt": to_srt, "vtt": to_vtt, "tsv": to_tsv}


def format_segments(segments: list[dict], fmt: str, **options) -> str:
    try:
        writer = FORMATTERS[fmt]
    except KeyError:
        raise ValueError(
            f"unknown format {fmt!r}; expected one of {sorted(FORMATTERS)}"
        ) from None
    return writer(segments, **options)
