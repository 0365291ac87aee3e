"""Speaker diarization: segmentation -> embeddings -> clustering.

The port of the JAX package's ``pipeline/diarize.py``, pyannote-3.1's
three-stage recipe:

  1. sliding 10 s windows, batched through the segmentation net on the
     device in pow2 slabs of int16 (local speakers per window, powerset
     decoded);
  2. one fixed-length speech crop per (window, local speaker), gathered
     on the host and batched through the ResNet34 embedding net on the
     device;
  3. host-side agglomerative clustering of the embeddings assigns global
     speakers; window-local activations are stitched onto a global frame
     grid (same-window slots of one speaker by max), gated, and binarised
     into turns.

Output turns are {"start", "end", "speaker": "SPEAKER_XX"}.  The host
steps (windowing, crop gather, clustering, stitch, binarise) are the JAX
package's numpy code, copied.  ``device=None`` runs the nets on the card
and raises without one; pass ``device="cpu"`` for the plain PyTorch path.

With ``mesh`` (a ``parallel.mesh.Mesh``; every rank builds the same
Diarizer) each slab is rounded up to the data axis, a data rank runs the
nets on its rows, and the rows are all-gathered before they reach the
host; the model ranks of a data group compute the same rows (as JAX's
``data_sharding`` replicates over the model axis), and every rank returns
the same turns.
"""
from __future__ import annotations

import logging
import math
import os
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..models.diarization import checkpoint as ckpt
from ..models.diarization import clustering as cluster_lib
from ..models.diarization import embedding as emb_lib
from ..models.diarization import segmentation as seg_lib
from ..models.diarization import segmentation_tpu as seg_tpu
from ..ops import frontend
from ..parallel import mesh as mesh_lib
from ..runtime import trace
from ..runtime.device import resolve_device
from . import ingest
from .transcribe import _bucket as _bucket_pow2
from .transcribe import _f32_to_i16

logger = logging.getLogger(__name__)

# the bundled checkpoints: this package's copy of the JAX package's assets
ASSETS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")


@dataclass
class Diarizer:
    """The JAX Diarizer's fields and defaults; ``seg_params`` and
    ``emb_params`` hold the port's nets (``nn.Module``s), which
    ``__post_init__`` moves to ``device``."""

    seg_params: Any
    seg_cfg: Any  # SegmentationConfig or TpuSegmentationConfig
    emb_params: Any
    emb_cfg: emb_lib.EmbeddingConfig
    window_step_s: float = 5.0
    onset: float = 0.5  # binarisation threshold on speaker activation
    # pyannote-3.1 Binarize hysteresis: a region starts when activation
    # crosses `onset` and continues while it stays above `offset`; None =
    # offset == onset
    offset: float | None = None
    # pyannote Binarize min_duration_off: fill within-speaker gaps shorter
    # than this (seconds) before the min-length filter
    min_duration_off: float = 0.0
    # pyannote Binarize min_duration_on: drop final turns shorter than this
    # (composes with min_speech_s, the stricter wins)
    min_duration_on: float = 0.0
    # a cluster that is not the frame's top cluster must clear this higher
    # bar to count as concurrent speech there; None = disabled
    overlap_onset: float | None = None
    min_speech_s: float = 0.4  # ignore local speakers with less speech
    cluster_threshold: float = 0.7
    min_speakers: int = 1
    max_speakers: int | None = None
    # dissolve clusters owning fewer crops than this (pyannote-3.1's
    # min_cluster_size) or fewer than min_cluster_frac of all crops
    min_cluster_size: int = 0
    min_cluster_frac: float = 0.0
    max_batch: int = 128
    # parallel.mesh.Mesh: slabs split over its data axis; the device is
    # the mesh's
    mesh: Any = None
    seg_fn: Any = None  # segment_windows impl; default the PyanNet's
    # pyannote-3.1 argmax powerset decode (to_multilabel) instead of the
    # marginal soft decode: the parity mode for converted checkpoints
    hard_decode: bool = False
    # provenance flags: False = random weights (a test/bench mode)
    seg_trained: bool = False
    emb_trained: bool = False
    # "trained", "converted" (from_npz) or "bundled-synthetic"
    provenance: str = "trained"
    device: Any = None

    def __post_init__(self):
        if self.seg_fn is None:
            self.seg_fn = seg_lib.segment_windows
        if self.mesh is None:
            self.device = resolve_device(self.device)
        elif self.device is None or resolve_device(self.device) == self.mesh.device:
            self.device = self.mesh.device
        else:
            raise ValueError(f"device {self.device} is not the mesh's {self.mesh.device}")
        for net in (self.seg_params, self.emb_params):
            if isinstance(net, torch.nn.Module):
                net.to(self.device)

    @property
    def untrained_parts(self) -> list[str]:
        parts = []
        if not self.seg_trained:
            parts.append("segmentation")
        if not self.emb_trained:
            parts.append("embedding")
        return parts

    @classmethod
    def random_init(cls, seed: int = 0, segmentation: str = "pyannet", **kw) -> "Diarizer":
        """segmentation='pyannet' (checkpoint-compatible SincNet+BiLSTM) or
        'tpu' (the recurrence-free conv+attention net).  kw may carry a
        trained emb_params/emb_cfg; only the nets not supplied get random
        weights (drawn on the CPU from ``seed``, then moved)."""
        gen = torch.Generator().manual_seed(seed)
        if segmentation == "tpu":
            seg_cfg = seg_tpu.TpuSegmentationConfig()
            seg = dict(seg_params=seg_tpu.init_params(seg_cfg, gen), seg_cfg=seg_cfg,
                       seg_fn=seg_tpu.segment_windows)
        else:
            seg_cfg = seg_lib.SegmentationConfig()
            seg = dict(seg_params=seg_lib.init_params(seg_cfg, gen), seg_cfg=seg_cfg)
        if "emb_params" not in kw:
            emb_cfg = kw.setdefault("emb_cfg", emb_lib.EmbeddingConfig())
            kw["emb_params"] = emb_lib.init_params(emb_cfg, gen)
        else:
            kw.setdefault("emb_trained", True)  # caller-supplied = trained
        return cls(**seg, **kw)

    @classmethod
    def from_tpu_segmentation(cls, seg_path: str, emb_seed: int = 0, **kw) -> "Diarizer":
        """Serve a trained TPU-first segmentation checkpoint (with its
        calibrated onset and decode knobs); embeddings stay random unless
        kw supplies them."""
        tree, seg_cfg = ckpt.load_segmentation_params(seg_path)
        onset = ckpt.load_onset(seg_path)
        if onset is not None:
            kw.setdefault("onset", onset)
        for k, v in ckpt.load_decode_meta(seg_path).items():
            kw.setdefault(k, v)
        if "emb_params" in kw:
            kw.setdefault("emb_trained", True)
            kw.setdefault("emb_cfg", emb_lib.EmbeddingConfig())
        else:
            # random params from the cfg the instance will serve
            emb_cfg = kw.setdefault("emb_cfg", emb_lib.EmbeddingConfig())
            kw["emb_params"] = emb_lib.init_params(
                emb_cfg, torch.Generator().manual_seed(emb_seed))
        return cls(
            seg_params=seg_tpu.params_from_jax(tree, seg_cfg),
            seg_cfg=seg_cfg,
            seg_fn=seg_tpu.segment_windows,
            seg_trained=True,
            **kw,
        )

    BUNDLED_SEG = "diarizer_seg.npz"
    BUNDLED_EMB = "diarizer_emb.npz"

    @classmethod
    def bundled(cls, **kw) -> "Diarizer | None":
        """The repo's synthetic-pretrained diarizer (provenance
        "bundled-synthetic"), or None when its assets are absent.  A caller
        who brings an embedding net keeps the class's AHC threshold: the
        bundled one was calibrated for the bundled embedding space."""
        seg_path = os.path.join(ASSETS_DIR, cls.BUNDLED_SEG)
        emb_path = os.path.join(ASSETS_DIR, cls.BUNDLED_EMB)
        if not (os.path.exists(seg_path) and os.path.exists(emb_path)):
            return None
        if "emb_params" in kw:
            kw.setdefault("emb_trained", True)
        else:
            tree, emb_cfg = ckpt.load_embedding_params(emb_path)
            kw["emb_params"] = emb_lib.params_from_jax(tree, emb_cfg)
            kw.setdefault("emb_cfg", emb_cfg)
            thr = ckpt.load_cluster_threshold(emb_path)
            if thr is not None:
                kw.setdefault("cluster_threshold", thr)
        kw.setdefault("provenance", "bundled-synthetic")
        return cls.from_tpu_segmentation(seg_path, **kw)

    @classmethod
    def from_npz(cls, path: str, **kw) -> "Diarizer":
        """Converted pyannote/ResNet weights (the JAX package's
        ``save_diarizer_params`` pack), decoded by argmax as pyannote-3.1
        does."""
        seg_tree, emb_tree = ckpt.load_diarizer_params(path)
        seg_cfg = seg_lib.SegmentationConfig()
        if "emb_params" not in kw:  # a trained override wins
            kw["emb_params"] = emb_lib.params_from_jax(emb_tree, kw.get("emb_cfg", emb_lib.EmbeddingConfig()))
        kw.setdefault("emb_cfg", emb_lib.EmbeddingConfig())
        kw.setdefault("provenance", "converted")
        kw.setdefault("hard_decode", True)
        return cls(
            seg_params=seg_lib.params_from_jax(seg_tree, seg_cfg),
            seg_cfg=seg_cfg,
            seg_trained=True,
            emb_trained=True,
            **kw,
        )

    # ------------------------------------------------------------------

    def _windows(self, audio: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Uniform-stride windows as a zero-copy strided view (the audio
        zero-pads up to the last grid-aligned window); window starts in s."""
        w = self.seg_cfg.window_samples
        step = int(self.window_step_s * self.seg_cfg.sample_rate)
        n = len(audio)
        n_win = 1 + max(0, -(-(n - w) // step))
        padded_len = (n_win - 1) * step + w
        audio = np.asarray(audio, np.float32)
        audio_pad = np.pad(audio, (0, padded_len - n)) if padded_len > n else audio
        out = np.lib.stride_tricks.sliding_window_view(audio_pad, w)[::step]
        starts = np.arange(n_win, dtype=np.int64) * step
        return out, starts.astype(np.float64) / self.seg_cfg.sample_rate

    @staticmethod
    def _to_i16(x: np.ndarray) -> np.ndarray:
        """Audio goes host->device as int16 (half the bytes); the nets see
        the rounded samples, as in the JAX package."""
        return _f32_to_i16(x)

    def _batched(self, arrays: np.ndarray, fn) -> np.ndarray:
        """Run fn over rows in pow2-padded int16 slabs on the device (one
        bucketing policy for both nets); the real rows come back to the
        host.  On a mesh a slab is rounded up to the data axis, this data
        rank runs its rows, and the rows of every data rank are gathered."""
        outs = []
        for i in range(0, len(arrays), self.max_batch):
            slab = arrays[i : i + self.max_batch]
            b = mesh_lib.round_up_batch(_bucket_pow2(len(slab), self.max_batch), self.mesh)
            padded = np.zeros((b, arrays.shape[1]), np.int16)
            padded[: len(slab)] = self._to_i16(slab)
            if self.mesh is not None:
                padded = np.ascontiguousarray(padded[self.mesh.local_rows(b)])
            out = mesh_lib.all_gather(fn(torch.from_numpy(padded).to(self.device)), self.mesh)
            outs.append(out.cpu().numpy()[: len(slab)])
        return np.concatenate(outs, axis=0)

    def _segment_all(self, windows: np.ndarray) -> np.ndarray:
        """(B, W) -> (B, F, n_spk) activations, batched in pow2 slabs."""
        if self.hard_decode:
            return self._batched(
                windows, lambda x: self.seg_fn(self.seg_params, self.seg_cfg, x, hard=True)
            )
        return self._batched(windows, lambda x: self.seg_fn(self.seg_params, self.seg_cfg, x))

    def _embed_all(self, crops: np.ndarray) -> np.ndarray:
        return self._batched(
            crops, lambda x: emb_lib.embed_crops(self.emb_params, self.emb_cfg, x),
        )

    # ------------------------------------------------------------------

    def diarize(
        self,
        audio: "np.ndarray | str | os.PathLike",
        sample_rate: int = 16_000,
        *,
        num_speakers: int | None = None,
        min_speakers: int | None = None,
        max_speakers: int | None = None,
        return_embeddings: bool = False,
    ) -> list[dict] | tuple[list[dict], "np.ndarray | None"]:
        """Mono float32 audio (or a path) -> speaker turns.

        Call-time speaker-count constraints as pyannote's pipeline takes
        them: ``num_speakers`` pins the count (best effort), min/max bound
        it, unset values fall back to the instance's.
        ``return_embeddings=True`` returns ``(turns, centroids)``: one
        L2-normalised centroid row per SPEAKER_XX (None without speech).
        """
        if num_speakers is not None:
            if min_speakers is not None or max_speakers is not None:
                raise ValueError("num_speakers is exclusive with min/max_speakers")
            min_spk = max_spk = num_speakers
        else:
            min_spk = self.min_speakers if min_speakers is None else min_speakers
            max_spk = self.max_speakers if max_speakers is None else max_speakers
            if max_spk is not None and min_spk is not None and min_spk > max_spk:
                raise ValueError(f"min_speakers ({min_spk}) > max_speakers ({max_spk})")
        # a path decodes after the argument checks: invalid calls fail first
        sr = self.seg_cfg.sample_rate
        audio, sample_rate = ingest.load_if_path(audio, sample_rate, target_sr=sr)
        if sample_rate != sr:
            audio = frontend.resample_host(audio, sample_rate, sr, device=self.device)
        duration = len(audio) / sr
        if duration < 0.5:
            return ([], None) if return_embeddings else []

        windows, starts_s = self._windows(audio)
        probs = self._segment_all(windows)  # (B, F, S)
        n_win, n_frames, n_spk = probs.shape
        fs = self.seg_cfg.frame_step_s

        # --- one speech crop per active (window, local speaker): only the
        # first ceil(crop_len / step) active frames of a pair can reach the
        # crop, so the gather is a bounded (N, need, step) fancy index,
        # chunked to bound its scratch memory
        with trace.span("diarize.crop_gather"):
            crop_len = self.emb_cfg.crop_samples
            active = probs > self.onset
            min_frames = int(self.min_speech_s / fs)
            step = int(fs * sr)
            n_act_all = active.sum(axis=1)  # (W, S)
            ew, es = np.nonzero(n_act_all >= max(min_frames, 1))  # row-major
            if len(ew) == 0:
                return ([], None) if return_embeddings else []
            owners = list(zip(ew.tolist(), es.tolist()))
            need = min(-(-crop_len // step), n_frames)
            audio_pad = np.pad(audio, (0, n_frames * step))
            crops = np.empty((len(ew), crop_len), np.float32)
            chunk = 256  # (256, need, step) float32 scratch, ~50 MB at 3 s crops
            for lo in range(0, len(ew), chunk):
                w_idx, s_idx = ew[lo : lo + chunk], es[lo : lo + chunk]
                act = active[w_idx, :, s_idx]  # (n, F)
                # first `need` active frame numbers per pair (stable argsort)
                order = np.argsort(~act, axis=1, kind="stable")[:, :need]
                base = (starts_s[w_idx] * sr).astype(np.int64)
                sample_idx = (
                    base[:, None, None]
                    + order[:, :, None] * step
                    + np.arange(step)[None, None, :]
                )
                flat = audio_pad[sample_idx].reshape(len(w_idx), need * step)
                # wrap-pad pairs with less speech than crop_len
                valid = np.minimum(n_act_all[w_idx, s_idx] * step, need * step)
                col = np.arange(crop_len)[None, :] % np.maximum(valid[:, None], 1)
                crops[lo : lo + chunk] = np.take_along_axis(flat, col, axis=1)

        embeddings = self._embed_all(crops)
        # min_cluster_frac scales the dissolution size with the meeting
        mcs = max(
            self.min_cluster_size,
            int(np.ceil(self.min_cluster_frac * len(embeddings)))
            if self.min_cluster_frac > 0 else 0,
        )
        labels = cluster_lib.agglomerative_cluster(
            embeddings,
            threshold=self.cluster_threshold,
            min_clusters=min_spk,
            max_clusters=max_spk,
            min_cluster_size=mcs,
        )
        n_clusters = int(labels.max()) + 1

        # --- stitch window-local activations onto a global frame grid;
        # same-window slots of one cluster combine by max first
        per_window: dict[tuple[int, int], np.ndarray] = {}
        for (w, s), lab in zip(owners, labels):
            key = (w, int(lab))
            cur = per_window.get(key)
            per_window[key] = probs[w, :, s] if cur is None else np.maximum(cur, probs[w, :, s])
        total_frames = int(math.ceil(duration / fs)) + 1
        acc = np.zeros((total_frames, n_clusters), np.float64)
        cnt = np.zeros((total_frames, n_clusters), np.float64)
        for (w, lab), p in per_window.items():
            f0 = int(round(starts_s[w] / fs))
            f1 = min(f0 + n_frames, total_frames)
            acc[f0:f1, lab] += p[: f1 - f0]
            cnt[f0:f1, lab] += 1.0
        mean = np.divide(acc, cnt, out=np.zeros_like(acc), where=cnt > 0)

        if self.overlap_onset is not None and n_clusters > 1:
            mean = _overlap_gate(mean, self.overlap_onset)

        # --- frames -> turns (hysteresis + gap-fill + min-length)
        offset = self.onset if self.offset is None else self.offset
        min_gap = int(round(self.min_duration_off / fs))
        min_len_s = max(self.min_speech_s, self.min_duration_on)
        turns = []
        for c in range(n_clusters):
            for f0, f1 in _binarize(mean[:, c], self.onset, offset, min_gap):
                start, end = f0 * fs, f1 * fs
                if end - start < min_len_s:
                    continue
                turns.append({
                    "start": round(float(start), 3),
                    "end": round(float(min(end, duration)), 3),
                    "speaker": f"SPEAKER_{c:02d}",
                })
        turns.sort(key=lambda t: (t["start"], t["speaker"]))
        if return_embeddings:
            cents = np.stack([embeddings[labels == c].mean(axis=0) for c in range(n_clusters)])
            cents /= np.maximum(np.linalg.norm(cents, axis=1, keepdims=True), 1e-9)
            return turns, cents
        return turns


def _runs(mask: np.ndarray):
    """Yield (start, end) index pairs of contiguous True runs."""
    idx = np.flatnonzero(mask)
    if idx.size == 0:
        return
    splits = np.flatnonzero(np.diff(idx) > 1)
    starts = np.concatenate([[idx[0]], idx[splits + 1]])
    ends = np.concatenate([idx[splits], [idx[-1]]]) + 1
    yield from zip(starts, ends)


def _overlap_gate(mean: np.ndarray, overlap_onset: float) -> np.ndarray:
    """Zero the per-frame activations of clusters that are neither the
    frame's top cluster nor above ``overlap_onset``.  (F, C) -> (F, C)."""
    top = mean.argmax(axis=1)
    not_top = np.ones_like(mean, bool)
    not_top[np.arange(len(mean)), top] = False
    return np.where(not_top & (mean <= overlap_onset), 0.0, mean)


def _binarize(track: np.ndarray, onset: float, offset: float, min_gap: int):
    """pyannote-3.1 Binarize on one activation track: a region turns on at
    an ``onset`` up-crossing and stays on until the track falls below
    ``offset``; runs separated by fewer than ``min_gap`` frames merge.
    Yields index pairs."""
    ext = track > min(offset, onset)
    core = track > onset
    runs = []
    for f0, f1 in _runs(ext):
        on = np.flatnonzero(core[f0:f1])
        if on.size:  # start at the onset crossing, not the offset one
            runs.append((f0 + int(on[0]), f1))
    if min_gap > 0 and len(runs) > 1:
        merged = [runs[0]]
        for f0, f1 in runs[1:]:
            if f0 - merged[-1][1] < min_gap:
                merged[-1] = (merged[-1][0], f1)
            else:
                merged.append((f0, f1))
        runs = merged
    yield from runs
