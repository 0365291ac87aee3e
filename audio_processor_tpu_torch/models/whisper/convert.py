"""Checkpoint I/O for the port: the JAX package's ``.npz`` format, and
carrying a JAX parameter tree across.

The ``.npz`` written by the JAX package's ``convert.save_params`` holds
``__config__`` (ten int64 dims), optionally ``__alignment_heads__`` and
``__tokenizer__`` (tiktoken rank-file bytes), and one array per parameter
under its ``/``-joined tree path, with layer parameters stacked.  Reading
it needs numpy only.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ...runtime.device import resolve_device
from .config import WhisperConfig
from .model import Params

_SIDECAR_KEYS = ("__config__", "__alignment_heads__", "__tokenizer__")
# conv stem: JAX stores (width, C_in, C_out) for lax.conv's HIO layout;
# conv1d wants (C_out, C_in, width)
_CONV_KEYS = ("encoder/conv1/w", "encoder/conv2/w")


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    out: dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _unflatten(flat: Mapping[str, Any]) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _to_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes arrays from a bf16 JAX tree
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def params_from_jax(
    tree: Mapping[str, Any], device: "str | torch.device | None" = None
) -> Params:
    """The JAX package's parameter tree (leaves as numpy arrays, e.g.
    after ``jax.tree.map(np.asarray, params)``) -> the port's parameters.

    Every leaf keeps its layout (linears stay (d_in, d_out), layers stay
    stacked) except the conv stem, which is transposed for ``conv1d``.
    Both packages then compute the same function.
    """
    dev = resolve_device(device)
    flat = _flatten(tree)
    out = {}
    for key, a in flat.items():
        a = np.asarray(a)
        if key in _CONV_KEYS:
            a = a.transpose(2, 1, 0)
        out[key] = _to_tensor(a, dev)
    return _unflatten(out)


def load_params(
    path: str, device: "str | torch.device | None" = None
) -> tuple[Params, WhisperConfig]:
    """Read a converted ``.npz`` -> (port parameters on ``device``, config)."""
    with np.load(path) as z:
        meta = z["__config__"]
        heads = None
        if "__alignment_heads__" in z.files:
            heads = tuple(
                (int(l), int(h)) for l, h in z["__alignment_heads__"]
            )
        flat = {k: z[k] for k in z.files if k not in _SIDECAR_KEYS}
    cfg = WhisperConfig(
        name="loaded",
        n_mels=int(meta[0]), n_audio_ctx=int(meta[1]), n_audio_state=int(meta[2]),
        n_audio_head=int(meta[3]), n_audio_layer=int(meta[4]), n_vocab=int(meta[5]),
        n_text_ctx=int(meta[6]), n_text_state=int(meta[7]), n_text_head=int(meta[8]),
        n_text_layer=int(meta[9]),
        alignment_heads=heads,
    )
    return params_from_jax(_unflatten(flat), device), cfg


def load_tokenizer(path: str):
    """The BPETokenizer embedded in a converted .npz, or None if the
    checkpoint skipped vocab embedding."""
    from .tokenizer import BPETokenizer

    with np.load(path) as z:
        if "__tokenizer__" not in z.files:
            return None
        data = z["__tokenizer__"].tobytes()
    return BPETokenizer.from_tiktoken_bytes(data)
