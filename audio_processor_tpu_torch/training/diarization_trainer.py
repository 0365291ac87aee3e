"""Training the recurrence-free segmentation net with the powerset loss.

The port of the JAX package's ``training/diarization_trainer.py``:
pyannote-3.1's permutation-invariant powerset cross-entropy (the
multilabel target is scored under every permutation of the local speaker
slots and each window trains against its best one), an AdamW step, a
synthetic-mixture generator for hermetic training data, the checkpoint
format ``Diarizer.from_tpu_segmentation`` serves, and the onset sweep.

The net is the port's ``TpuSegmentationNet``: its log-mel is kernel A on
the card (``ops/kernels/log_mel.log_mel``).  The audio takes no gradient,
so the kernel needs no backward; the net's parameters take one for the
step only (``train_step.value_and_grad``).
"""
from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np
import torch

from ..models.diarization import segmentation_tpu as seg
from ..models.diarization.checkpoint import (  # noqa: F401  (the checkpoint's readers)
    DECODE_META_KEYS, load_decode_meta, load_onset, load_segmentation_params, synth_voice,
)
from .pytree_io import flatten_tree
from .train_step import AdamState, AdamW, tree_leaves, value_and_grad


# ---------------------------------------------------------------------------
# Powerset target mapping + permutation-invariant loss
# ---------------------------------------------------------------------------

def powerset_lookup(member: np.ndarray) -> np.ndarray:
    """(2^S,) table: binary speaker-activity key -> powerset class index.

    Keys with more simultaneous speakers than any class covers map to the
    class that overlaps them most, so slightly noisy targets can't crash
    training.
    """
    c, s = member.shape
    lut = np.zeros(1 << s, np.int32)
    keys = (member.astype(np.int64) * (1 << np.arange(s))).sum(axis=1)
    valid = {int(k): i for i, k in enumerate(keys)}
    for key in range(1 << s):
        if key in valid:
            lut[key] = valid[key]
        else:
            bits = np.array([(key >> b) & 1 for b in range(s)], np.float32)
            overlap = member @ bits - 0.5 * member.sum(axis=1)
            lut[key] = int(np.argmax(overlap))
    return lut


def permutation_invariant_loss(
    logits: torch.Tensor,  # (B, T, C) powerset logits
    targets: torch.Tensor,  # (B, T, S) 0/1 multilabel speaker activity
    member: torch.Tensor,  # (C, S)
    lut: torch.Tensor,  # (2^S,) from powerset_lookup
) -> torch.Tensor:
    """Mean best-permutation cross-entropy (pyannote's powerset loss).

    The minimum over permutations is ``amin``, which shares the gradient
    equally among tied permutations, as JAX's ``min`` does; ties are the
    rule (two silent slots swap without changing the loss)."""
    s = targets.shape[-1]
    perms = torch.tensor(list(itertools.permutations(range(s))), device=targets.device)  # (P, S)
    weights = (1 << torch.arange(s, device=targets.device)).to(torch.int64)
    logprobs = torch.log_softmax(logits.float(), dim=-1)  # (B, T, C)
    permuted = targets[..., perms].to(torch.int64)  # (B, T, P, S)
    classes = lut.to(targets.device).long()[(permuted * weights).sum(-1)]  # (B, T, P)
    nll = -torch.gather(logprobs, -1, classes)  # (B, T, P)
    losses = nll.mean(dim=1)  # (B, P)
    return torch.amin(losses, dim=1).mean()


# ---------------------------------------------------------------------------
# Train state / step
# ---------------------------------------------------------------------------

class SegTrainState(NamedTuple):
    params: seg.TpuSegmentationNet
    opt_state: AdamState
    step: int


def make_optimizer(lr: float = 3e-4, weight_decay: float = 0.01) -> AdamW:
    return AdamW(lr=lr, weight_decay=weight_decay, max_norm=1.0)


def init_train_state(cfg: seg.TpuSegmentationConfig, generator: torch.Generator,
                     lr: float = 3e-4) -> SegTrainState:
    """Random weights (``segmentation_tpu.init_params``) on the generator's device."""
    net = seg.init_params(cfg, generator)
    return SegTrainState(net, make_optimizer(lr).init(tree_leaves(net)), 0)


def train_step(
    state: SegTrainState,
    cfg: seg.TpuSegmentationConfig,
    audio: torch.Tensor,  # (B, window_samples) float32
    targets: torch.Tensor,  # (B, num_frames, S)
    member: torch.Tensor,
    lut: torch.Tensor,
    lr: float = 3e-4,
) -> tuple[SegTrainState, torch.Tensor]:
    """One AdamW step on the net (updated in place); returns the new state
    and the loss.  lr may change from step to step."""
    net = state.params
    leaves = tree_leaves(net)
    loss, grads = value_and_grad(
        lambda: permutation_invariant_loss(net(audio), targets, member, lut), leaves)
    opt_state = make_optimizer(lr).update(grads, state.opt_state, leaves)
    return SegTrainState(net, opt_state, state.step + 1), loss


# ---------------------------------------------------------------------------
# Synthetic mixtures (hermetic training/eval data)
# ---------------------------------------------------------------------------

def synth_mixture(
    rng: np.random.Generator,
    cfg: seg.TpuSegmentationConfig,
    f0s: tuple[float, ...] = (110.0, 220.0, 400.0),
    overlap_prob: float = 0.2,
    min_turn_s: float = 0.4,
    max_turn_s: float = 1.5,
) -> tuple[np.ndarray, np.ndarray]:
    """One training window: mixed audio + (num_frames, S) activity labels."""
    n = cfg.window_samples
    sr = cfg.sample_rate
    s = cfg.num_speakers
    audio = rng.normal(0, 0.003, n).astype(np.float32)  # noise floor
    labels = np.zeros((cfg.num_frames, s), np.float32)
    frame_s = cfg.frame_step_s

    t_cursor = 0.0
    prev = -1
    while t_cursor < cfg.window_s - min_turn_s:
        spk = int(rng.integers(0, min(s, len(f0s))))
        dur = float(rng.uniform(min_turn_s, max_turn_s))
        start = t_cursor
        if prev >= 0 and spk != prev and rng.random() < overlap_prob:
            start = max(0.0, t_cursor - 0.3)  # overlap the previous turn
        end = min(start + dur, cfg.window_s)
        a, b = int(start * sr), int(end * sr)
        audio[a:b] += synth_voice(rng, f0s[spk], b - a, sr)
        fa, fb = int(start / frame_s), int(np.ceil(end / frame_s))
        labels[fa : min(fb, cfg.num_frames), spk] = 1.0
        prev = spk
        t_cursor = end + float(rng.uniform(0.0, 0.3))
    return audio, labels


def labels_to_turns(labels: np.ndarray, frame_s: float, prefix: str = "SPEAKER") -> list[dict]:
    """(T, S) activity -> [{"start","end","speaker"}] turn list."""
    turns = []
    for s in range(labels.shape[1]):
        active = labels[:, s] > 0.5
        edges = np.flatnonzero(np.diff(np.concatenate([[0], active, [0]])))
        for a, b in zip(edges[::2], edges[1::2]):
            turns.append({"start": float(a * frame_s), "end": float(b * frame_s),
                          "speaker": f"{prefix}_{s:02d}"})
    return turns


# ---------------------------------------------------------------------------
# Checkpoint save/load (served by pipeline.diarize.Diarizer.from_tpu_segmentation)
# ---------------------------------------------------------------------------

def save_params(
    path: str,
    params: seg.TpuSegmentationNet,
    cfg: seg.TpuSegmentationConfig,
    onset: float | None = None,
    decode: dict | None = None,
) -> None:
    """Trained segmentation net + config -> one ``.npz`` (the JAX package's
    format).  ``onset`` (from calibrate_onset) and the ``decode`` knobs of
    ``DECODE_META_KEYS`` ride along as ``meta.*``, so the serving Diarizer
    binarises at the calibrated thresholds."""
    flat = {f"p.{k}": v for k, v in flatten_tree(seg.params_to_jax(params)).items()}
    for field in ("sample_rate", "n_mels", "d_model", "n_head", "n_layer",
                  "num_speakers", "max_simultaneous"):
        flat[f"cfg.{field}"] = np.asarray(getattr(cfg, field))
    flat["cfg.window_s"] = np.asarray(cfg.window_s)
    if onset is not None:
        flat["meta.onset"] = np.asarray(float(onset))
    for k, v in (decode or {}).items():
        if k not in DECODE_META_KEYS:
            raise ValueError(f"unknown decode meta key {k!r}")
        if v is not None:
            flat[f"meta.{k}"] = np.asarray(float(v))
    np.savez(path, **flat)


def load_params(path: str, device="cpu") -> tuple[seg.TpuSegmentationNet, seg.TpuSegmentationConfig]:
    """A checkpoint of ``save_params`` -> (the net on ``device``, config)."""
    tree, cfg = load_segmentation_params(path)
    return seg.params_from_jax(tree, cfg, device), cfg


# ---------------------------------------------------------------------------
# Onset calibration (threshold for pipeline/diarize.Diarizer.onset)
# ---------------------------------------------------------------------------

def calibrate_onset(
    probs: np.ndarray,  # (N, T, S) predicted per-speaker probabilities
    labels: np.ndarray,  # (N, T, S) reference activity
    grid: np.ndarray | None = None,
) -> tuple[float, float]:
    """Sweep binarisation thresholds; return (best_onset, frame_error).

    The loss is permutation-invariant, so each window's predicted slots are
    first aligned to the label slots by a Hungarian match on activation
    overlap; the sweep then scores the aligned frames."""
    from scipy.optimize import linear_sum_assignment

    if probs.shape != labels.shape:
        raise ValueError(
            f"probs {probs.shape} and labels {labels.shape} must agree — "
            "slot alignment is a permutation, not a projection"
        )
    if grid is None:
        grid = np.linspace(0.2, 0.8, 25)
    aligned = np.empty_like(probs)
    ident = np.arange(probs.shape[2], dtype=np.int64)
    for i in range(len(probs)):
        # agreement between predicted slot s and label slot l
        agree = probs[i].T @ labels[i] + (1 - probs[i]).T @ (1 - labels[i])
        rows, cols = linear_sum_assignment(-agree)
        perm = ident.copy()
        perm[cols] = rows
        aligned[i] = probs[i][:, perm]
    best = (0.5, float("inf"))
    for th in grid:
        err = float(np.mean((aligned > th) != (labels > 0.5)))
        if err < best[1]:
            best = (float(th), err)
    return best
