"""Whisper encoder and its building blocks, in PyTorch.

The port of the JAX package's ``models/whisper/model.py``.  Parameters are
a nested dict of tensors with the JAX package's keys and layouts (so
``convert.params_from_jax`` carries a JAX tree across unchanged), except
the conv stem, which is stored in ``conv1d``'s (C_out, C_in, width)
layout.  Layer parameters are stacked along a leading layer axis, as in
the JAX tree; ``layer(blocks, l)`` takes views of one layer.

Numerics mirror the JAX functions: layer norm with float32 statistics and
population variance, linear layers as ``x @ W + b`` with ``W`` stored
(d_in, d_out), exact GELU, attention scores softmaxed in float32 (the
plain ``attention`` lives beside the encoder-attention kernel, in
``ops/kernels/encoder_attention.py``), and the conv stem's bias added in
the compute dtype.

Under a (data, model) mesh (``parallel/mesh.py``) each rank holds its
slice of the parameters (``parallel/sharding.py``): attention runs on the
rank's heads and the MLP on its hidden units, and the two row-parallel
products (attention out, fc2) are summed over the model group by
``row_parallel_linear``.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.kernels.encoder_attention import _scores_f32
from ...ops.kernels.encoder_attention import attention_reference as attention
from ...ops.kernels.encoder_attention import fused_self_attention
from ...parallel import mesh as mesh_lib
from .config import WhisperConfig

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# Parameter initialisation (random weights; checkpoints via convert.py)
# ---------------------------------------------------------------------------

def init_params(cfg: WhisperConfig, generator: torch.Generator) -> Params:
    """Random float32 weights with the JAX package's initialiser scales
    (normal / sqrt(d_in) linears, zero biases, unit layer norms, 0.02
    token embedding, zero decoder positions, sinusoidal encoder positions),
    on the generator's device.

    The numbers differ from ``jax.random``'s; tests carry JAX weights
    across with ``convert.params_from_jax`` instead.
    """
    device = generator.device

    def normal(*shape, scale):
        return torch.randn(shape, generator=generator, device=device) * scale

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def ones(*shape):
        return torch.ones(shape, device=device)

    def linear(n, d_in, d_out, bias=True):
        p = {"w": normal(n, d_in, d_out, scale=1.0 / math.sqrt(d_in))}
        if bias:
            p["b"] = zeros(n, d_out)
        return p

    def ln(n, d):
        return {"scale": ones(n, d), "bias": zeros(n, d)}

    def attn(n, d):
        return {
            "q": linear(n, d, d),
            "k": linear(n, d, d, bias=False),  # Whisper: no bias on K
            "v": linear(n, d, d),
            "out": linear(n, d, d),
        }

    def blocks(n, d, cross):
        p = {
            "attn_ln": ln(n, d),
            "attn": attn(n, d),
            "mlp_ln": ln(n, d),
            "fc1": linear(n, d, 4 * d),
            "fc2": linear(n, 4 * d, d),
        }
        if cross:
            p["cross_attn_ln"] = ln(n, d)
            p["cross_attn"] = attn(n, d)
        return p

    d = cfg.n_audio_state
    return {
        "encoder": {
            # conv weights in conv1d layout: (C_out, C_in, width)
            "conv1": {
                "w": normal(d, cfg.n_mels, 3, scale=1.0 / math.sqrt(3 * cfg.n_mels)),
                "b": zeros(d),
            },
            "conv2": {
                "w": normal(d, d, 3, scale=1.0 / math.sqrt(3 * d)),
                "b": zeros(d),
            },
            "blocks": blocks(cfg.n_audio_layer, d, cross=False),
            "ln_post": {"scale": ones(d), "bias": zeros(d)},
            "pos_emb": torch.from_numpy(sinusoids(cfg.n_audio_ctx, d)).to(device),
        },
        "decoder": {
            "token_emb": normal(cfg.n_vocab, cfg.n_text_state, scale=0.02),
            "pos_emb": zeros(cfg.n_text_ctx, cfg.n_text_state),
            "blocks": blocks(cfg.n_text_layer, cfg.n_text_state, cross=True),
            "ln": {"scale": ones(cfg.n_text_state), "bias": zeros(cfg.n_text_state)},
        },
    }


def map_params(fn, tree):
    """Apply ``fn`` to every tensor of a parameter tree."""
    if isinstance(tree, dict):
        return {k: map_params(fn, v) for k, v in tree.items()}
    return fn(tree)


def layer(blocks: Params, l: int) -> Params:
    """Views of layer ``l`` of a stacked block tree (no copy)."""
    return map_params(lambda t: t[l], blocks)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def layer_norm(p, x, eps=1e-5):
    """Layer norm over the last axis.  F.layer_norm keeps its statistics
    (mean, population variance) in float32 for bf16 inputs and rounds the
    output once, as the JAX ``layer_norm`` does; one launch instead of
    eight elementwise passes."""
    d = x.shape[-1]
    return F.layer_norm(x, (d,), p["scale"].to(x.dtype), p["bias"].to(x.dtype), eps)


def linear(p, x):
    """``x @ W + b`` in x's dtype, W stored (d_in, d_out).  The product
    accumulates in float32 inside the GEMM and the bias joins in its
    epilogue before the one rounding to x's dtype (addmm), as the JAX
    ``linear`` does with preferred_element_type=float32.

    int8 weights (``quantize.quantize_linear``: {"w8", "scale"[, "b"]}):
    w8 is cast to x's dtype before the product, which stays float32; the
    per-output-channel scale and then the bias fold into it before the one
    rounding, as in the JAX ``linear``."""
    if "w8" in p:
        x2 = x.reshape(-1, x.shape[-1])
        w = p["w8"].to(x.dtype)
        if x.is_cuda and x.dtype != torch.float32:
            y = torch.mm(x2, w, out_dtype=torch.float32)
        else:  # the exactly upcast operands
            y = torch.mm(x2.float(), w.float())
        y = y * p["scale"].float()
        if "b" in p:
            y = y + p["b"].float()
        return y.to(x.dtype).reshape(*x.shape[:-1], w.shape[-1])
    w = p["w"].to(x.dtype)
    if "b" not in p:
        return torch.matmul(x, w)
    y = torch.addmm(p["b"].to(x.dtype), x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def row_parallel_linear(p, x, mesh):
    """``linear`` whose W rows (d_in) are split over the model axis: each
    rank's partial product, with no bias, is summed over the model group
    in float32; the replicated bias joins once and the sum rounds once to
    x's dtype, as the unsplit addmm does.  Plain ``linear`` when tp == 1."""
    if mesh is None or mesh.tp == 1:
        return linear(p, x)
    x2 = x.reshape(-1, x.shape[-1])
    w = p["w"].to(x.dtype)
    if x.is_cuda and x.dtype != torch.float32:
        part = torch.mm(x2, w, out_dtype=torch.float32)
    else:  # the exactly upcast operands
        part = torch.mm(x2.float(), w.float())
    part = mesh_lib.reduce_from_model(part, mesh)
    if "b" in p:
        part = part + p["b"].float()
    return part.to(x.dtype).reshape(*x.shape[:-1], w.shape[-1])


def local_heads(n_head: int, mesh) -> int:
    """Heads of this model rank (all of them when tp == 1)."""
    lo, hi = mesh_lib.split_bounds(n_head, mesh)
    return hi - lo


def gelu(x):
    return F.gelu(x, approximate="none")


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed sinusoidal positions for the encoder (sin||cos)."""
    assert channels % 2 == 0
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def split_heads(x, n_head):
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head)


def merge_heads(x):
    b, t, h, dh = x.shape
    return x.reshape(b, t, h * dh)


def masked_attention(q, k, v, mask):
    """``attention`` with an additive float32 mask (T, Tk) on the scores
    before the softmax (the JAX ``model.attention`` with ``mask``)."""
    dh = q.shape[-1]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, T, Dh)
    scores = _scores_f32(qh, kh) * (1.0 / math.sqrt(dh))
    probs = torch.softmax(scores + mask, dim=-1).to(q.dtype)
    return torch.matmul(probs, vh).transpose(1, 2).to(q.dtype)


def causal_mask(t: int, device=None) -> torch.Tensor:
    """(t, t) float32: -inf above the diagonal, 0 elsewhere."""
    return torch.triu(torch.full((t, t), float("-inf"), device=device), diagonal=1)


def self_attention(p, x, n_head, mask=None, fused=False, mesh=None):
    """n_head: the heads held here (the rank's under a mesh).  mask: an
    additive (T, T) mask (the teacher-forced decoder's causal one).
    fused=True runs the encoder-attention kernel (the plain version on CPU
    tensors) when there is no mask; the default is the plain matmuls, as
    in JAX."""
    x = mesh_lib.copy_to_model(x, mesh)
    q = split_heads(linear(p["q"], x), n_head)
    k = split_heads(linear(p["k"], x), n_head)
    v = split_heads(linear(p["v"], x), n_head)
    if mask is not None:
        o = masked_attention(q, k, v, mask)
    else:
        o = fused_self_attention(q, k, v) if fused else attention(q, k, v)
    return row_parallel_linear(p["out"], merge_heads(o), mesh)


def mlp(p, x, mesh=None):
    x = mesh_lib.copy_to_model(x, mesh)
    return row_parallel_linear(p["fc2"], gelu(linear(p["fc1"], x)), mesh)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _conv1d(p, x, stride):
    # x: (B, C_in, T); w: (C_out, C_in, width).  The bias is added in the
    # compute dtype: an f32 bias would promote bf16 activations to f32.
    y = F.conv1d(x, p["w"].to(x.dtype), stride=stride, padding=1)
    return y + p["b"].to(x.dtype)[:, None]


def encode(
    params: Params,
    cfg: WhisperConfig,
    mel: torch.Tensor,
    *,
    compute_dtype: torch.dtype = torch.float32,
    fused_attn: bool = False,
    mesh=None,
) -> torch.Tensor:
    """mel (B, n_mels, 3000) -> encoder states (B, 1500, d).  fused_attn
    runs self-attention through the encoder-attention kernel.  mesh: the
    params are this model rank's slices (every rank returns the whole
    states)."""
    p = params["encoder"]
    n_head = local_heads(cfg.n_audio_head, mesh)
    x = mel.to(compute_dtype)  # (B, n_mels, T): conv1d's channel-first layout
    x = gelu(_conv1d(p["conv1"], x, stride=1))
    x = gelu(_conv1d(p["conv2"], x, stride=2))  # (B, d, 1500)
    x = x.transpose(1, 2) + p["pos_emb"].to(x.dtype)
    for l in range(cfg.n_audio_layer):
        bp = layer(p["blocks"], l)
        x = x + self_attention(
            bp["attn"], layer_norm(bp["attn_ln"], x), n_head, fused=fused_attn, mesh=mesh
        )
        x = x + mlp(bp, layer_norm(bp["mlp_ln"], x), mesh)
    return layer_norm(p["ln_post"], x)


# ---------------------------------------------------------------------------
# Decoder (teacher-forced full sequence; the cached step is in decode.py)
# ---------------------------------------------------------------------------

def decode_logits(
    params: Params,
    cfg: WhisperConfig,
    tokens: torch.Tensor,
    audio_states: torch.Tensor,
    *,
    pos_offset: int = 0,
    compute_dtype: torch.dtype = torch.float32,
    mesh=None,
) -> torch.Tensor:
    """Teacher-forced decoder: tokens (B, T), audio (B, 1500, d) -> logits
    (B, T, V) float32, under the causal mask.  mesh: the params are this
    model rank's slices (the sharded train step)."""
    p = params["decoder"]
    n_head = local_heads(cfg.n_text_head, mesh)
    t = tokens.shape[1]
    x = p["token_emb"][tokens].to(compute_dtype)
    x = x + p["pos_emb"][pos_offset : pos_offset + t].to(compute_dtype)
    causal = causal_mask(t, tokens.device)
    audio_states = mesh_lib.copy_to_model(audio_states.to(compute_dtype), mesh)
    for l in range(cfg.n_text_layer):
        bp = layer(p["blocks"], l)
        x = x + self_attention(bp["attn"], layer_norm(bp["attn_ln"], x), n_head, causal, mesh=mesh)
        xa = mesh_lib.copy_to_model(layer_norm(bp["cross_attn_ln"], x), mesh)
        q = split_heads(linear(bp["cross_attn"]["q"], xa), n_head)
        k = split_heads(linear(bp["cross_attn"]["k"], audio_states), n_head)
        v = split_heads(linear(bp["cross_attn"]["v"], audio_states), n_head)
        o = merge_heads(attention(q, k, v))
        x = x + row_parallel_linear(bp["cross_attn"]["out"], o, mesh)
        x = x + mlp(bp, layer_norm(bp["mlp_ln"], x), mesh)
    x = layer_norm(p["ln"], x)
    # the products of x's dtype are exact in float32 (preferred_element_type)
    return torch.matmul(x.float(), p["token_emb"].to(x.dtype).float().T)


def forward(
    params: Params,
    cfg: WhisperConfig,
    mel: torch.Tensor,
    tokens: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Full forward pass: mel + teacher-forced tokens -> logits."""
    audio = encode(params, cfg, mel, compute_dtype=compute_dtype)
    return decode_logits(params, cfg, tokens, audio, compute_dtype=compute_dtype)
