"""Readers of the diarizer's ``.npz`` checkpoints, and the synthetic voice.

The readers live here, beside the nets that serve them (the port's
``training/`` and ``models/diarization/convert.py`` write the same files and
import them from here), each a copy of its JAX origin with numpy leaves in
place of jax arrays:

- ``flatten_tree`` / ``unflatten_tree``: ``training/pytree_io``'s (dotted
  keys, integer-keyed dicts back to lists; ``sep="/"`` gives the converted
  pack's keys);
- ``load_segmentation_params``, ``load_onset``, ``load_decode_meta``:
  ``training/diarization_trainer.load_params``, ``load_onset``,
  ``load_decode_meta`` (the TPU-first segmentation net and its calibrated
  decode knobs, ``meta.*``);
- ``load_embedding_params``, ``load_cluster_threshold``:
  ``training/embedding_trainer.load_params``, ``load_cluster_threshold``;
- ``load_diarizer_params``: ``models/diarization/convert.load_diarizer_params``
  (the ``seg/`` + ``emb/`` pack of converted pyannote/ResNet weights,
  ``/``-joined keys);
- ``synth_voice``: ``training/diarization_trainer.synth_voice``, the
  harmonic "voice" the bundled nets were trained on, which the tests and
  ``chip_smoke.py`` build meetings from.

The trees come back as numpy arrays in the JAX layouts; each net's
``params_from_jax`` turns one into the port's module.
"""
from __future__ import annotations

import numpy as np
import torch

from .embedding import EmbeddingConfig
from .segmentation_tpu import TpuSegmentationConfig

DECODE_META_KEYS = (
    "offset", "min_duration_on", "min_duration_off", "overlap_onset",
    "min_cluster_size", "min_cluster_frac",
)


def _listify(node):
    """Dicts whose keys are all integers were lists before saving."""
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        return [_listify(node[str(i)]) for i in range(len(node))]
    return {k: _listify(v) for k, v in node.items()}


def _unflatten(flat: dict[str, np.ndarray], sep: str):
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        parts = key.split(sep)
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.asarray(value)
    return _listify(tree)


def flatten_tree(tree, prefix: str = "", sep: str = ".") -> dict[str, np.ndarray]:
    """Nested dicts and lists -> {``sep``-joined key: numpy array}; tensors
    come to the host and bf16 is widened to float32 (``np.savez`` has no
    bfloat16)."""
    items = tree.items() if isinstance(tree, dict) else ((str(i), v) for i, v in enumerate(tree))
    flat: dict[str, np.ndarray] = {}
    for k, v in items:
        key = f"{prefix}{sep}{k}" if prefix else str(k)
        if isinstance(v, (dict, list, tuple)):
            flat.update(flatten_tree(v, key, sep))
        elif isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            flat[key] = (v.float() if v.dtype == torch.bfloat16 else v).numpy().copy()
        else:
            a = np.asarray(v)
            flat[key] = a.astype(np.float32) if a.dtype.name == "bfloat16" else a
    return flat


def unflatten_tree(flat: dict[str, np.ndarray]):
    """Dotted keys -> nested dicts and lists (the trainers' checkpoints)."""
    return _unflatten(flat, ".")


def _read(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load_segmentation_params(path: str) -> tuple[dict, TpuSegmentationConfig]:
    """A TPU-first segmentation checkpoint -> (params tree, config)."""
    data = _read(path)
    cfg = TpuSegmentationConfig(
        sample_rate=int(data["cfg.sample_rate"]),
        window_s=float(data["cfg.window_s"]),
        n_mels=int(data["cfg.n_mels"]),
        d_model=int(data["cfg.d_model"]),
        n_head=int(data["cfg.n_head"]),
        n_layer=int(data["cfg.n_layer"]),
        num_speakers=int(data["cfg.num_speakers"]),
        max_simultaneous=int(data["cfg.max_simultaneous"]),
    )
    return unflatten_tree({k[2:]: v for k, v in data.items() if k.startswith("p.")}), cfg


def load_onset(path: str) -> float | None:
    """The calibrated binarisation threshold, if the checkpoint has one."""
    with np.load(path) as data:
        if "meta.onset" in data.files:
            return float(data["meta.onset"])
    return None


def load_decode_meta(path: str) -> dict:
    """The calibrated Binarize and clustering knobs the checkpoint holds
    (absent keys are left out, so the Diarizer's defaults apply)."""
    out = {}
    with np.load(path) as data:
        for k in DECODE_META_KEYS:
            if f"meta.{k}" in data.files:
                v = float(data[f"meta.{k}"])
                out[k] = int(v) if k == "min_cluster_size" else v
    return out


def load_embedding_params(path: str) -> tuple[dict, EmbeddingConfig]:
    """A speaker-embedding checkpoint -> (params tree, config)."""
    data = _read(path)
    cfg = EmbeddingConfig(
        n_mels=int(data["cfg.n_mels"]),
        base_channels=int(data["cfg.base_channels"]),
        blocks=tuple(int(b) for b in data["cfg.blocks"]),
        embed_dim=int(data["cfg.embed_dim"]),
        crop_s=float(data["cfg.crop_s"]),
        sample_rate=int(data["cfg.sample_rate"]),
    )
    return unflatten_tree({k[2:]: v for k, v in data.items() if k.startswith("p.")}), cfg


def load_cluster_threshold(path: str) -> float | None:
    """The calibrated AHC cut, if the checkpoint has one."""
    with np.load(path) as data:
        if "meta.cluster_threshold" in data.files:
            return float(data["meta.cluster_threshold"])
    return None


def load_diarizer_params(path: str) -> tuple[dict, dict]:
    """A converted pack -> (PyanNet params tree, embedding params tree)."""
    data = _read(path)
    seg = {k[4:]: v for k, v in data.items() if k.startswith("seg/")}
    emb = {k[4:]: v for k, v in data.items() if k.startswith("emb/")}
    return _unflatten(seg, "/"), _unflatten(emb, "/")


def synth_voice(rng: np.random.Generator, f0: float, n: int, sr: int) -> np.ndarray:
    """A crude but spectrally distinct 'voice': a harmonic stack with pitch
    wobble and syllabic amplitude modulation."""
    t = np.arange(n) / sr
    wobble = 1.0 + 0.02 * np.sin(2 * np.pi * rng.uniform(2, 5) * t)
    x = np.zeros(n)
    for h, amp in ((1, 1.0), (2, 0.6), (3, 0.4), (4, 0.25)):
        x += amp * np.sin(2 * np.pi * f0 * h * wobble * t + rng.uniform(0, 6.28))
    syllable = 0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(3, 7) * t) ** 2
    return (x * syllable * 0.25).astype(np.float32)
