"""Quality metrics: WER and DER.

A copy of the JAX package's ``utils/metrics.py`` (numpy and scipy).  WER
is normalise -> Levenshtein over words.  DER follows NIST md-eval on a
frame grid: (false alarm + missed + speaker confusion) / total reference
speech, with an optimal 1:1 speaker mapping (Hungarian assignment over
overlap counts) and a forgiveness collar around reference boundaries.
"""
from __future__ import annotations

import re

import numpy as np


# ---------------------------------------------------------------------------
# WER
# ---------------------------------------------------------------------------

_PUNCT_RE = re.compile(r"[^\w\s']", re.UNICODE)


def normalize_text(text: str) -> list[str]:
    """Lowercase, strip punctuation, collapse whitespace -> word list."""
    return _PUNCT_RE.sub(" ", text.lower()).split()


def word_error_rate(reference: str, hypothesis: str) -> float:
    """Levenshtein word distance / reference length."""
    ref = normalize_text(reference)
    hyp = normalize_text(hypothesis)
    if not ref:
        return 0.0 if not hyp else float("inf")
    # single-row DP
    prev = np.arange(len(hyp) + 1)
    for i, r in enumerate(ref, start=1):
        cur = np.empty(len(hyp) + 1, dtype=np.int64)
        cur[0] = i
        for j, h in enumerate(hyp, start=1):
            cur[j] = min(
                prev[j] + 1,  # deletion
                cur[j - 1] + 1,  # insertion
                prev[j - 1] + (r != h),  # substitution
            )
        prev = cur
    return float(prev[-1]) / len(ref)


# ---------------------------------------------------------------------------
# DER
# ---------------------------------------------------------------------------

def diarization_error_rate(
    reference: list[dict],
    hypothesis: list[dict],
    collar_s: float = 0.25,
    frame_s: float = 0.01,
) -> float:
    """DER between two turn lists [{"start","end","speaker"}].

    Frame-based scoring (10 ms default grid) with an optimal speaker
    mapping and a +-collar around reference boundaries excluded from
    scoring, as in the standard NIST protocol.  For the miss / false-alarm
    / confusion decomposition use diarization_error_rate_detailed.
    """
    return diarization_error_rate_detailed(
        reference, hypothesis, collar_s=collar_s, frame_s=frame_s
    )["der"]


def diarization_error_rate_detailed(
    reference: list[dict],
    hypothesis: list[dict],
    collar_s: float = 0.25,
    frame_s: float = 0.01,
) -> dict:
    """DER plus its NIST decomposition and speaker counts.

    Returns {"der", "miss", "false_alarm", "confusion", "ref_speakers",
    "hyp_speakers"} — each rate normalised by total reference speech time,
    so der == miss + false_alarm + confusion.  A single DER number hides
    HOW a diarizer fails: a high miss means
    turns are being dropped (segmentation/hysteresis), false alarm means
    phantom speech (onset too low / reverb ghosts), confusion means the
    clustering is merging or splitting speakers.
    """
    n_ref_spk = len({t["speaker"] for t in reference})
    n_hyp_spk = len({t["speaker"] for t in hypothesis})

    def _result(der, miss=0.0, fa=0.0, conf=0.0):
        return {
            "der": der, "miss": miss, "false_alarm": fa, "confusion": conf,
            "ref_speakers": n_ref_spk, "hyp_speakers": n_hyp_spk,
        }

    if not reference:
        return _result(
            0.0 if not hypothesis else float("inf"),
            fa=0.0 if not hypothesis else float("inf"),
        )

    end = max(
        [t["end"] for t in reference] + [t["end"] for t in hypothesis] + [0.0]
    )
    n = int(np.ceil(end / frame_s)) + 1

    ref_spk = sorted({t["speaker"] for t in reference})
    hyp_spk = sorted({t["speaker"] for t in hypothesis})
    ref_m = np.zeros((n, max(len(ref_spk), 1)), bool)
    hyp_m = np.zeros((n, max(len(hyp_spk), 1)), bool)
    for t in reference:
        ref_m[int(t["start"] / frame_s) : int(np.ceil(t["end"] / frame_s)),
              ref_spk.index(t["speaker"])] = True
    for t in hypothesis:
        hyp_m[int(t["start"] / frame_s) : int(np.ceil(t["end"] / frame_s)),
              hyp_spk.index(t["speaker"])] = True

    # collar: exclude frames near reference boundaries
    score = np.ones(n, bool)
    c = int(round(collar_s / frame_s))
    if c > 0:
        for t in reference:
            for edge in (t["start"], t["end"]):
                lo = max(0, int(edge / frame_s) - c)
                hi = min(n, int(edge / frame_s) + c)
                score[lo:hi] = False

    ref_m = ref_m[score]
    hyp_m = hyp_m[score]

    # optimal 1:1 speaker mapping by overlap (Hungarian)
    overlap = ref_m.astype(np.int64).T @ hyp_m.astype(np.int64)
    from scipy.optimize import linear_sum_assignment

    ri, hi_ = linear_sum_assignment(-overlap)
    mapped_correct = np.zeros(ref_m.shape[0], np.int64)
    for r, h in zip(ri, hi_):
        mapped_correct += (ref_m[:, r] & hyp_m[:, h]).astype(np.int64)

    n_ref = ref_m.sum(axis=1)
    n_hyp = hyp_m.sum(axis=1)
    total_ref = int(n_ref.sum())
    if total_ref == 0:
        inf = float("inf")
        return _result(0.0 if n_hyp.sum() == 0 else inf,
                       fa=0.0 if n_hyp.sum() == 0 else inf)

    confusion_plus = np.minimum(n_ref, n_hyp) - mapped_correct
    missed = np.maximum(n_ref - n_hyp, 0)
    false_alarm = np.maximum(n_hyp - n_ref, 0)
    miss = int(missed.sum()) / total_ref
    fa = int(false_alarm.sum()) / total_ref
    conf = int(confusion_plus.sum()) / total_ref
    return _result(miss + fa + conf, miss=miss, fa=fa, conf=conf)
