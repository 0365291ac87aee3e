"""Operations and bytes the work needs, from a configuration's shapes,
and the card's published peaks (NVIDIA H100 SXM data sheet, dense, at
700 W).

A kernel B call (the int4 cross-attention, ``csrc/cross_attn_int4.cu``)
reads each valid K and V nibble of its layer once and q, and writes its
output, in float32: the counting of ``chip_smoke.py``'s ``needed()``.
Its operations are float32 FMAs (two products of Tq x 1500 x Dh a head).
The model's FLOPs are two a weight a token, plus attention's two
products, counted for the work that was asked for: real windows, not the
padding rows of a slab.
"""
from __future__ import annotations

import math

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
AUDIO_CTX = 1500
MEL_FRAMES = 3000


def kernel_b_call(rows: int, tq: int, heads: int, head_dim: int,
                  valid: int = AUDIO_CTX) -> tuple[int, int]:
    """(bytes, FLOPs) one call needs."""
    n_bytes = 2 * rows * heads * head_dim * math.ceil(valid / 2) + 2 * 4 * rows * tq * heads * head_dim
    return n_bytes, 4 * rows * tq * heads * head_dim * valid


def kernel_b_bound_s(n_bytes: float, flops: float) -> float:
    """The least time the card could take: bytes at the HBM rate, or
    float32 operations at the non-tensor-core rate, whichever is larger."""
    return max(n_bytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS)


def encoder_flops(cfg: dict) -> int:
    """One 30 s window through the conv stem and the encoder layers."""
    d, m, ff = cfg["d_model"], cfg["num_mel_bins"], cfg["encoder_ffn_dim"]
    t = AUDIO_CTX
    stem = 2 * 3 * m * d * MEL_FRAMES + 2 * 3 * d * d * t
    layer = 2 * t * (4 * d * d + 2 * d * ff) + 2 * 2 * t * t * d
    return stem + cfg["encoder_layers"] * layer


def decoder_flops(cfg: dict, prompt: int, steps: int) -> int:
    """One row's decode: the cross K/V of every layer over the encoder
    states, prompt + steps - 1 decoder positions (the prefill, then one
    forward a step after the first), and the logits of each step."""
    d, ff, n = cfg["d_model"], cfg["decoder_ffn_dim"], cfg["decoder_layers"]
    cross_kv = n * 2 * 2 * AUDIO_CTX * d * d
    total = cross_kv
    for p in range(prompt + steps - 1):
        total += n * (2 * (4 * d * d + 2 * d * d + 2 * d * ff)
                      + 2 * 2 * (p + 1) * d + 2 * 2 * AUDIO_CTX * d)
    return total + steps * 2 * cfg["vocab_size"] * d
