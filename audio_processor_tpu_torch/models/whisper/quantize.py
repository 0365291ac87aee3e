"""Post-training int8 weight quantization for the decode path.

The port of the JAX package's ``models/whisper/quantize.py``.  The decode
loop re-reads every decoder weight once a token; int8 per-output-channel
weights halve that stream, with the dequant scale (stored (..., 1, out))
folded after the product.  ``model.linear`` reads the quantized form
{"w8", "scale"[, "b"]} as it reads {"w"[, "b"]}, so quantized and float
linears mix in one tree (encoder float, decoder int8).
"""
from __future__ import annotations

from typing import Any

import torch

Params = dict[str, Any]


def quantize_linear(p: dict) -> dict:
    """{"w" (..., in, out) [, "b"]} -> {"w8" int8, "scale" (..., 1, out)
    float32 [, "b"]}, per output channel over the input axis (-2), so flat
    and stacked (L, in, out) weights quantize per layer.  torch.round rounds
    half to even, as jnp.round does."""
    w = p["w"].float()
    amax = w.abs().amax(dim=-2, keepdim=True)  # per output channel
    scale = torch.clamp(amax, min=1e-8) / 127.0
    w8 = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    out = {"w8": w8, "scale": scale}
    if "b" in p:
        out["b"] = p["b"]
    return out


def _is_linear(node: Any) -> bool:
    return isinstance(node, dict) and "w" in node and getattr(node["w"], "ndim", 0) >= 2


def _quantize_tree(node: Any) -> Any:
    if _is_linear(node):
        return quantize_linear(node)
    if isinstance(node, dict):
        return {k: _quantize_tree(v) for k, v in node.items()}
    return node


def quantize_decoder(params: Params) -> Params:
    """int8-quantize every decoder linear (attention and MLP projections);
    embeddings, layer norms and the encoder stay float."""
    out = dict(params)
    dec = dict(params["decoder"])
    dec["blocks"] = _quantize_tree(params["decoder"]["blocks"])
    out["decoder"] = dec
    return out
