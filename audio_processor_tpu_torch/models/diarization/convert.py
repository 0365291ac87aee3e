"""Checkpoint conversion for the diarization nets.

The port of the JAX package's ``models/diarization/convert.py``:

* pyannote ``segmentation-3.0``-family PyanNet state dicts -> the
  segmentation params (pyannote.audio's module names: sincnet.wav_norm1d,
  sincnet.conv1d.{0,1,2}, sincnet.norm1d.{0,1,2}, lstm.weight_*_l{k}
  [_reverse], linear.{0,1}, classifier; torch's LSTM gate order (i,f,g,o)
  is the net's);
* WeSpeaker-style ResNet34 speaker-embedding state dicts -> the embedding
  params (torchvision block names: conv1/bn1, layer{1..4}.{i}.conv{1,2}/
  bn{1,2}/downsample.{0,1}, and a final embedding linear whose key is
  found among ``_EMBED_LINEAR_CANDIDATES``).

Both take {name: tensor or array} mappings and return the JAX layout's
tree of float32 numpy arrays, as the JAX converters do;
``segmentation.params_from_jax`` and ``embedding.params_from_jax`` build
the port's nets from it.  ``save_diarizer_params`` writes the ``seg/`` +
``emb/`` pack that ``Diarizer.from_npz`` serves.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .checkpoint import flatten_tree
from .checkpoint import load_diarizer_params  # noqa: F401  (the pack's reader)
from .embedding import EmbeddingConfig
from .segmentation import SegmentationConfig


def _t(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _strip_prefixes(sd: Mapping[str, Any]) -> dict[str, Any]:
    """Drop common wrapper prefixes (model., module.)."""
    out = {}
    for k, v in sd.items():
        for pre in ("model.", "module."):
            if k.startswith(pre):
                k = k[len(pre):]
        out[k] = v
    return out


# ---------------------------------------------------------------------------
# PyanNet segmentation
# ---------------------------------------------------------------------------

def from_pyannet_state_dict(
    sd: Mapping[str, Any], cfg: SegmentationConfig | None = None
) -> tuple[dict, SegmentationConfig]:
    sd = _strip_prefixes(sd)
    cfg = cfg or SegmentationConfig()

    def ln(prefix):
        return {"scale": _t(sd[f"{prefix}.weight"]), "bias": _t(sd[f"{prefix}.bias"])}

    def linear(prefix):
        return {"w": _t(sd[f"{prefix}.weight"]).T, "b": _t(sd[f"{prefix}.bias"])}

    def conv(prefix):
        # torch conv1d (out, in, k) -> the JAX layout's (k, in, out)
        return {"w": _t(sd[f"{prefix}.weight"]).transpose(2, 1, 0), "b": _t(sd[f"{prefix}.bias"])}

    def direction(k, suffix):
        return {
            "wi": _t(sd[f"lstm.weight_ih_l{k}{suffix}"]).T,
            "wh": _t(sd[f"lstm.weight_hh_l{k}{suffix}"]).T,
            "bi": _t(sd[f"lstm.bias_ih_l{k}{suffix}"]),
            "bh": _t(sd[f"lstm.bias_hh_l{k}{suffix}"]),
        }

    params = {
        "wav_norm": ln("sincnet.wav_norm1d"),
        "sinc": {
            "low_hz": _t(sd["sincnet.conv1d.0.low_hz_"]).reshape(-1),
            "band_hz": _t(sd["sincnet.conv1d.0.band_hz_"]).reshape(-1),
        },
        "norm0": ln("sincnet.norm1d.0"),
        "conv1": conv("sincnet.conv1d.1"),
        "norm1": ln("sincnet.norm1d.1"),
        "conv2": conv("sincnet.conv1d.2"),
        "norm2": ln("sincnet.norm1d.2"),
        "lstm": [{"fwd": direction(k, ""), "bwd": direction(k, "_reverse")}
                 for k in range(cfg.lstm_layers)],
        "linear1": linear("linear.0"),
        "linear2": linear("linear.1"),
        "classifier": linear("classifier"),
    }
    return params, cfg


# ---------------------------------------------------------------------------
# ResNet34 speaker embedding
# ---------------------------------------------------------------------------

_EMBED_LINEAR_CANDIDATES = ("seg_1", "embedding", "fc", "embed", "bottleneck")


def from_resnet_state_dict(
    sd: Mapping[str, Any], cfg: EmbeddingConfig | None = None
) -> tuple[dict, EmbeddingConfig]:
    sd = _strip_prefixes(sd)
    cfg = cfg or EmbeddingConfig()

    def conv(name):
        # torch conv2d (out, in, kh, kw) -> the JAX layout's (kh, kw, in, out)
        return _t(sd[f"{name}.weight"]).transpose(2, 3, 1, 0)

    def bn(name):
        return {
            "scale": _t(sd[f"{name}.weight"]),
            "bias": _t(sd[f"{name}.bias"]),
            "mean": _t(sd[f"{name}.running_mean"]),
            "var": _t(sd[f"{name}.running_var"]),
        }

    stages = []
    for si, n_blocks in enumerate(cfg.blocks, start=1):
        stage = []
        for bi in range(n_blocks):
            base = f"layer{si}.{bi}"
            block = {
                "conv1": conv(f"{base}.conv1"),
                "bn1": bn(f"{base}.bn1"),
                "conv2": conv(f"{base}.conv2"),
                "bn2": bn(f"{base}.bn2"),
            }
            if f"{base}.downsample.0.weight" in sd:
                block["down_conv"] = conv(f"{base}.downsample.0")
                block["down_bn"] = bn(f"{base}.downsample.1")
            stage.append(block)
        stages.append(stage)

    embed_key = next((c for c in _EMBED_LINEAR_CANDIDATES if f"{c}.weight" in sd), None)
    if embed_key is None:
        raise KeyError(f"no embedding linear found; tried {_EMBED_LINEAR_CANDIDATES}")
    w = _t(sd[f"{embed_key}.weight"])
    params = {
        "stem_conv": conv("conv1"),
        "stem_bn": bn("bn1"),
        "stages": stages,
        "fc": {
            "w": w.T,
            "b": (_t(sd[f"{embed_key}.bias"]) if f"{embed_key}.bias" in sd
                  else np.zeros(w.shape[0], np.float32)),
        },
    }
    return params, cfg


# ---------------------------------------------------------------------------
# The seg/ + emb/ pack (read by checkpoint.load_diarizer_params)
# ---------------------------------------------------------------------------

def save_diarizer_params(path: str, seg_params: dict, emb_params: dict) -> None:
    """Segmentation and embedding trees (the converters' JAX layout) -> one
    ``.npz`` with ``/``-joined keys under ``seg/`` and ``emb/``."""
    flat = {f"seg/{k}": v for k, v in flatten_tree(seg_params, sep="/").items()}
    flat.update({f"emb/{k}": v for k, v in flatten_tree(emb_params, sep="/").items()})
    np.savez(path, **flat)
