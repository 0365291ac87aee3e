"""Checkpoint conversion and I/O for the port: openai-whisper ``.pt`` and
HuggingFace checkpoints in, the JAX package's ``.npz`` format in and out.

The ``.npz`` (``save_params``; the JAX package's ``convert.save_params``
writes the same) holds ``__config__`` (ten int64 dims), optionally
``__alignment_heads__`` and ``__tokenizer__`` (tiktoken rank-file bytes),
and one float32 array per parameter under its ``/``-joined tree path, with
layer parameters stacked and the conv stem in JAX's (width, C_in, C_out)
layout.  Reading and writing it needs numpy only.

The converters map a checkpoint's names onto the JAX tree (the JAX
package's ``from_hf_state_dict`` / ``from_openai_state_dict``, leaf for
leaf) and return the port's parameters (``params_from_jax``) on the CPU.
The HuggingFace path reads ``model.safetensors`` with its own reader
(``read_safetensors``), so it needs no ``safetensors`` package and no
``torch.load``.
"""
from __future__ import annotations

from typing import Any, Mapping

import json
import os
import struct

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


def params_to_jax(params: Params) -> dict:
    """The inverse of ``params_from_jax``: the port's parameters -> the JAX
    package's tree of numpy arrays (conv stem back to (width, C_in, C_out),
    bf16 widened to float32, as the JAX savers write it)."""
    out = {}
    for key, t in _flatten(params).items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        a = t.numpy()
        out[key] = np.ascontiguousarray(a.transpose(2, 1, 0)) if key in _CONV_KEYS else a.copy()
    return _unflatten(out)


# ---------------------------------------------------------------------------
# Checkpoint names -> the JAX tree (the JAX package's converters, leaf for leaf)
# ---------------------------------------------------------------------------

def _t(x) -> np.ndarray:
    """A checkpoint tensor or array -> float32 numpy.  numpy has no
    bfloat16, so a torch tensor is upcast before ``.numpy()``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _stack(blocks: list[dict]) -> dict:
    """Per-layer trees -> one tree with a leading layer axis."""
    first = blocks[0]
    if isinstance(first, dict):
        return {k: _stack([b[k] for b in blocks]) for k in first}
    return np.stack(blocks)


def _linear(sd, prefix: str, bias: bool = True) -> dict:
    p = {"w": _t(sd[f"{prefix}.weight"]).T}
    if bias:
        p["b"] = _t(sd[f"{prefix}.bias"])
    return p


def _ln(sd, prefix: str) -> dict:
    return {"scale": _t(sd[f"{prefix}.weight"]), "bias": _t(sd[f"{prefix}.bias"])}


def _attn(sd, prefix: str, names: tuple[str, str, str, str]) -> dict:
    q, k, v, o = names  # Whisper's K projection has no bias
    return {
        "q": _linear(sd, f"{prefix}.{q}"),
        "k": _linear(sd, f"{prefix}.{k}", bias=False),
        "v": _linear(sd, f"{prefix}.{v}"),
        "out": _linear(sd, f"{prefix}.{o}"),
    }


_HF_ATTN = ("q_proj", "k_proj", "v_proj", "out_proj")
_OA_ATTN = ("query", "key", "value", "out")


def _hf_block(sd, prefix: str, cross: bool) -> dict:
    p = {
        "attn_ln": _ln(sd, f"{prefix}.self_attn_layer_norm"),
        "attn": _attn(sd, f"{prefix}.self_attn", _HF_ATTN),
        "mlp_ln": _ln(sd, f"{prefix}.final_layer_norm"),
        "fc1": _linear(sd, f"{prefix}.fc1"),
        "fc2": _linear(sd, f"{prefix}.fc2"),
    }
    if cross:
        p["cross_attn_ln"] = _ln(sd, f"{prefix}.encoder_attn_layer_norm")
        p["cross_attn"] = _attn(sd, f"{prefix}.encoder_attn", _HF_ATTN)
    return p


def _oa_block(sd, prefix: str, cross: bool) -> dict:
    p = {
        "attn_ln": _ln(sd, f"{prefix}.attn_ln"),
        "attn": _attn(sd, f"{prefix}.attn", _OA_ATTN),
        "mlp_ln": _ln(sd, f"{prefix}.mlp_ln"),
        "fc1": _linear(sd, f"{prefix}.mlp.0"),
        "fc2": _linear(sd, f"{prefix}.mlp.2"),
    }
    if cross:
        p["cross_attn_ln"] = _ln(sd, f"{prefix}.cross_attn_ln")
        p["cross_attn"] = _attn(sd, f"{prefix}.cross_attn", _OA_ATTN)
    return p


def _conv(sd, prefix: str) -> dict:
    # torch conv1d weight (out, in, k) -> the JAX tree's (k, in, out)
    return {"w": _t(sd[f"{prefix}.weight"]).transpose(2, 1, 0), "b": _t(sd[f"{prefix}.bias"])}


def _hf_tree(sd: Mapping[str, Any], cfg: WhisperConfig) -> dict:
    """transformers WhisperForConditionalGeneration / WhisperModel names
    -> the JAX package's numpy tree (its ``from_hf_state_dict``)."""
    # tolerate both "model.encoder..." and "encoder..." key roots
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    return {
        "encoder": {
            "conv1": _conv(sd, "encoder.conv1"),
            "conv2": _conv(sd, "encoder.conv2"),
            "pos_emb": _t(sd["encoder.embed_positions.weight"]),
            "blocks": _stack([_hf_block(sd, f"encoder.layers.{i}", False)
                              for i in range(cfg.n_audio_layer)]),
            "ln_post": _ln(sd, "encoder.layer_norm"),
        },
        "decoder": {
            "token_emb": _t(sd["decoder.embed_tokens.weight"]),
            "pos_emb": _t(sd["decoder.embed_positions.weight"]),
            "blocks": _stack([_hf_block(sd, f"decoder.layers.{i}", True)
                              for i in range(cfg.n_text_layer)]),
            "ln": _ln(sd, "decoder.layer_norm"),
        },
    }


def _openai_tree(sd: Mapping[str, Any], cfg: WhisperConfig) -> dict:
    """openai-whisper ``.pt`` names -> the JAX package's numpy tree (its
    ``from_openai_state_dict``)."""
    return {
        "encoder": {
            "conv1": _conv(sd, "encoder.conv1"),
            "conv2": _conv(sd, "encoder.conv2"),
            "pos_emb": _t(sd["encoder.positional_embedding"]),
            "blocks": _stack([_oa_block(sd, f"encoder.blocks.{i}", False)
                              for i in range(cfg.n_audio_layer)]),
            "ln_post": _ln(sd, "encoder.ln_post"),
        },
        "decoder": {
            "token_emb": _t(sd["decoder.token_embedding.weight"]),
            "pos_emb": _t(sd["decoder.positional_embedding"]),
            "blocks": _stack([_oa_block(sd, f"decoder.blocks.{i}", True)
                              for i in range(cfg.n_text_layer)]),
            "ln": _ln(sd, "decoder.ln"),
        },
    }


def from_hf_state_dict(sd: Mapping[str, Any], cfg: WhisperConfig) -> Params:
    """transformers WhisperForConditionalGeneration / WhisperModel state
    dict -> the port's parameters, on the CPU."""
    return params_from_jax(_hf_tree(sd, cfg), "cpu")


def from_openai_state_dict(sd: Mapping[str, Any], cfg: WhisperConfig) -> Params:
    """openai-whisper state dict -> the port's parameters, on the CPU."""
    return params_from_jax(_openai_tree(sd, cfg), "cpu")


def load_openai_checkpoint(
    path: str, alignment_heads: tuple[tuple[int, int], ...] | None = None,
) -> tuple[Params, WhisperConfig]:
    """An openai-whisper ``.pt`` checkpoint (``dims`` + ``model_state_dict``)
    -> (the port's parameters on the CPU, config).

    alignment_heads: the checkpoint's word-timestamp head mask.  The .pt
    file does not carry one (openai-whisper keys its table by model name):
    pass it, or measure one with ``calibrate-alignment-heads``.  The file
    is unpickled (``weights_only=False``, as openai's ``load_model`` does):
    open only checkpoints you trust.
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    dims = ckpt["dims"]
    cfg = WhisperConfig(
        name="converted",
        n_mels=dims["n_mels"],
        n_audio_ctx=dims["n_audio_ctx"],
        n_audio_state=dims["n_audio_state"],
        n_audio_head=dims["n_audio_head"],
        n_audio_layer=dims["n_audio_layer"],
        n_vocab=dims["n_vocab"],
        n_text_ctx=dims["n_text_ctx"],
        n_text_state=dims["n_text_state"],
        n_text_head=dims["n_text_head"],
        n_text_layer=dims["n_text_layer"],
        alignment_heads=alignment_heads,
    )
    return from_openai_state_dict(ckpt["model_state_dict"], cfg), cfg


# the float dtypes Whisper checkpoints are published in; BF16 is widened
# to float32 on read
_SAFETENSORS_DTYPES = {"F32": "<f4", "F16": "<f2"}


def read_safetensors(path: str) -> dict[str, np.ndarray]:
    """One ``.safetensors`` file -> {name: numpy array}.

    The format: an 8-byte little-endian header length, a JSON header
    giving each tensor's dtype, shape and byte offsets into the data that
    follows, then the raw little-endian bytes.  BF16 tensors come back as
    float32 (each 16-bit pattern shifted into the high half: exact)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        lo, hi = info["data_offsets"]
        raw = np.frombuffer(data, np.uint8, hi - lo, lo)
        dtype, shape = info["dtype"], tuple(info["shape"])
        if dtype == "BF16":
            a = (raw.view("<u2").astype(np.uint32) << 16).view(np.float32)
        elif dtype in _SAFETENSORS_DTYPES:
            little = np.dtype(_SAFETENSORS_DTYPES[dtype])
            a = raw.view(little).astype(little.newbyteorder("="))
        else:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {dtype}")
        out[name] = a.reshape(shape)
    return out


def load_hf_checkpoint(path: str):
    """A HuggingFace Whisper checkpoint directory -> (the port's parameters
    on the CPU, config, BPETokenizer or None).

    Reads ``config.json``, the alignment heads of ``generation_config.json``
    when published, ``model.safetensors`` (or the shards a
    ``model.safetensors.index.json`` names) and the ``vocab.json`` /
    ``merges.txt`` pair when present: weights and vocab as one unit."""
    with open(os.path.join(path, "config.json"), encoding="utf-8") as f:
        hc = json.load(f)
    heads = None
    gen_path = os.path.join(path, "generation_config.json")
    if os.path.exists(gen_path):
        with open(gen_path, encoding="utf-8") as f:
            heads = alignment_heads_from_generation_config(json.load(f))
    cfg = WhisperConfig(
        name=os.path.basename(os.path.normpath(path)) or "hf",
        n_mels=int(hc["num_mel_bins"]),
        n_audio_ctx=int(hc["max_source_positions"]),
        n_audio_state=int(hc["d_model"]),
        n_audio_head=int(hc["encoder_attention_heads"]),
        n_audio_layer=int(hc["encoder_layers"]),
        n_vocab=int(hc["vocab_size"]),
        n_text_ctx=int(hc["max_target_positions"]),
        n_text_state=int(hc["d_model"]),
        n_text_head=int(hc["decoder_attention_heads"]),
        n_text_layer=int(hc["decoder_layers"]),
        alignment_heads=heads,
    )
    index_path = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path, encoding="utf-8") as f:
            index = json.load(f)
        sd: dict = {}
        for shard in sorted(set(index["weight_map"].values())):
            sd.update(read_safetensors(os.path.join(path, shard)))
    else:
        sd = read_safetensors(os.path.join(path, "model.safetensors"))
    params = from_hf_state_dict(sd, cfg)

    tokenizer = None
    vocab_path = os.path.join(path, "vocab.json")
    merges_path = os.path.join(path, "merges.txt")
    if os.path.exists(vocab_path) and os.path.exists(merges_path):
        from .tokenizer import BPETokenizer

        tokenizer = BPETokenizer.from_vocab_files(vocab_path, merges_path)
    return params, cfg, tokenizer


def alignment_heads_from_generation_config(gen_config: Mapping[str, Any]):
    """(layer, head) pairs of a HF generation_config.json dict (its
    ``alignment_heads`` field), or None."""
    heads = gen_config.get("alignment_heads")
    if not heads:
        return None
    return tuple((int(l), int(h)) for l, h in heads)


def save_params(path: str, params: Params, cfg: WhisperConfig, tokenizer=None) -> None:
    """Write a servable ``.npz`` of the port's parameters, in the JAX
    package's format.  Pass the checkpoint's BPETokenizer to embed its
    vocab, so serving gets weights and tokenizer as one unit; without it
    loading falls back to the byte tokenizer."""
    flat = _flatten(params_to_jax(params))
    meta = np.array(
        [cfg.n_mels, cfg.n_audio_ctx, cfg.n_audio_state, cfg.n_audio_head,
         cfg.n_audio_layer, cfg.n_vocab, cfg.n_text_ctx, cfg.n_text_state,
         cfg.n_text_head, cfg.n_text_layer],
        dtype=np.int64,
    )
    extra = {}
    if cfg.alignment_heads:
        extra["__alignment_heads__"] = np.asarray(cfg.alignment_heads, np.int64)
    if tokenizer is not None and hasattr(tokenizer, "to_tiktoken_bytes"):
        extra["__tokenizer__"] = np.frombuffer(tokenizer.to_tiktoken_bytes(), dtype=np.uint8)
    np.savez(path, __config__=meta, **extra, **flat)


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
