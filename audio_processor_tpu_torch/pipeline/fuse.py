"""ASR x diarization fusion: a speaker for every transcript segment.

A copy of the JAX package's ``pipeline/fuse.py`` (host numpy): one
vectorised interval-overlap matrix, argmax over turns.  The max-overlap
speaker wins; a segment that overlaps no turn takes the nearest turn's
speaker within ``tolerance_s``, else "SPEAKER_UNKNOWN".
"""
from __future__ import annotations

import numpy as np

UNKNOWN = "SPEAKER_UNKNOWN"


def fuse_segments(
    asr_segments: list[dict],
    diarization_turns: list[dict],
    tolerance_s: float = 1.0,
) -> list[dict]:
    """Merge {"start","end","text"} rows with {"start","end","speaker"} turns.

    Returns [{"speaker", "start", "end", "text"}] — the segment schema the
    reference's downstream (speaker identification, summary, Notion
    transcript) consumes (audio_processor.py:1136-1145).
    """
    if not asr_segments:
        return []
    if not diarization_turns:
        return [
            {"speaker": UNKNOWN, "start": s["start"], "end": s["end"], "text": s["text"]}
            for s in asr_segments
        ]

    seg = np.asarray([[s["start"], s["end"]] for s in asr_segments], np.float64)
    trn = np.asarray([[t["start"], t["end"]] for t in diarization_turns], np.float64)
    speakers = [t["speaker"] for t in diarization_turns]

    # overlap matrix (S, T)
    lo = np.maximum(seg[:, None, 0], trn[None, :, 0])
    hi = np.minimum(seg[:, None, 1], trn[None, :, 1])
    overlap = np.maximum(0.0, hi - lo)

    best = overlap.argmax(axis=1)
    best_overlap = overlap.max(axis=1)

    # no-overlap fallback: distance to nearest turn boundary
    gap_before = trn[None, :, 0] - seg[:, None, 1]  # turn starts after seg ends
    gap_after = seg[:, None, 0] - trn[None, :, 1]  # seg starts after turn ends
    distance = np.maximum(np.maximum(gap_before, gap_after), 0.0)
    nearest = distance.argmin(axis=1)
    nearest_dist = distance.min(axis=1)

    out = []
    for i, s in enumerate(asr_segments):
        if best_overlap[i] > 0.0:
            spk = speakers[best[i]]
        elif nearest_dist[i] <= tolerance_s:
            spk = speakers[nearest[i]]
        else:
            spk = UNKNOWN
        out.append(
            {"speaker": spk, "start": s["start"], "end": s["end"], "text": s["text"]}
        )
    return out


def relabel_speakers(segments: list[dict], speaker_map: dict[str, str]) -> list[dict]:
    """Apply an LLM-provided {SPEAKER_XX: real name} map (reference:
    audio_processor.py:1281-1288), leaving unmapped codes untouched."""
    return [
        {**seg, "speaker": speaker_map.get(seg["speaker"], seg["speaker"])}
        for seg in segments
    ]


def format_transcript(segments: list[dict], with_timestamps: bool = True) -> str:
    """Speaker-attributed transcript text, one line per segment."""
    from ..utils.timestamps import format_timestamp

    lines = []
    for seg in segments:
        if with_timestamps:
            lines.append(
                f"[{format_timestamp(seg['start'])} - {format_timestamp(seg['end'])}] "
                f"{seg['speaker']}: {seg['text']}"
            )
        else:
            lines.append(f"{seg['speaker']}: {seg['text']}")
    return "\n".join(lines)
