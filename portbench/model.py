"""A configuration file -> the program's Whisper config, and seeded
weights made on the device.

The weights are drawn in one call on the card's generator, in the type
they are served in (bfloat16), and cut into the program's parameter tree
(stacked layers, linears stored (d_in, d_out), the conv stem in conv1d's
layout).  Linears are normal / sqrt(d_in); biases, layer-norm offsets and
the decoder's positions small noise; layer-norm scales 1 + noise; the
token embedding 0.02; the encoder's positions Whisper's fixed sinusoids.
The same tensors go to the program and to the reference.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def whisper_config(cfg: dict):
    """The program's WhisperConfig for a configuration file."""
    from audio_processor_tpu_torch.models.whisper.config import WhisperConfig

    if cfg["encoder_attention_heads"] != cfg["decoder_attention_heads"]:
        raise ValueError("the program's Whisper has one head count for both stacks")
    return WhisperConfig(
        name=cfg["name"], n_mels=cfg["num_mel_bins"], n_audio_ctx=cfg["max_source_positions"],
        n_audio_state=cfg["d_model"], n_audio_head=cfg["encoder_attention_heads"],
        n_audio_layer=cfg["encoder_layers"], n_vocab=cfg["vocab_size"],
        n_text_ctx=cfg["max_target_positions"], n_text_state=cfg["d_model"],
        n_text_head=cfg["decoder_attention_heads"], n_text_layer=cfg["decoder_layers"],
    )


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's encoder positions: sin || cos at geometric timescales."""
    inv = np.exp(-math.log(10000.0) / (channels // 2 - 1) * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1)


def _spec(cfg: dict) -> list[tuple[tuple, tuple, str, float]]:
    """(path, shape, kind, scale) of every drawn leaf."""
    d, ff, m = cfg["d_model"], cfg["encoder_ffn_dim"], cfg["num_mel_bins"]
    out = []

    def lin(path, n, d_in, d_out, bias=True):
        out.append((path + ("w",), (n, d_in, d_out), "normal", 1.0 / math.sqrt(d_in)))
        if bias:
            out.append((path + ("b",), (n, d_out), "normal", 0.02))

    def ln(path, n):
        shape = (n, d) if n else (d,)
        out.append((path + ("scale",), shape, "one_plus", 0.1))
        out.append((path + ("bias",), shape, "normal", 0.02))

    def blocks(root, n, cross):
        for name in ("attn",) + (("cross_attn",) if cross else ()):
            ln(root + (name + "_ln",), n)
            for proj in ("q", "k", "v", "out"):
                lin(root + (name, proj), n, d, d, bias=proj != "k")
        ln(root + ("mlp_ln",), n)
        lin(root + ("fc1",), n, d, ff)
        lin(root + ("fc2",), n, ff, d)

    out.append((("encoder", "conv1", "w"), (d, m, 3), "normal", 1.0 / math.sqrt(3 * m)))
    out.append((("encoder", "conv1", "b"), (d,), "normal", 0.02))
    out.append((("encoder", "conv2", "w"), (d, d, 3), "normal", 1.0 / math.sqrt(3 * d)))
    out.append((("encoder", "conv2", "b"), (d,), "normal", 0.02))
    blocks(("encoder", "blocks"), cfg["encoder_layers"], cross=False)
    ln(("encoder", "ln_post"), 0)
    out.append((("decoder", "token_emb"), (cfg["vocab_size"], d), "normal", 0.02))
    out.append((("decoder", "pos_emb"), (cfg["max_target_positions"], d), "normal", 0.01))
    blocks(("decoder", "blocks"), cfg["decoder_layers"], cross=True)
    ln(("decoder", "ln"), 0)
    return out


def make_params(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The seeded parameter tree, drawn in one call on ``device``."""
    spec = _spec(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(sum(math.prod(s) for _, s, _, _ in spec), generator=gen,
                       device=device, dtype=dtype)
    tree: dict = {}
    off = 0
    for path, shape, kind, scale in spec:
        n = math.prod(shape)
        leaf = flat[off:off + n].view(shape).mul_(scale)
        if kind == "one_plus":
            leaf.add_(1.0)
        off += n
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    tree["encoder"]["pos_emb"] = torch.from_numpy(
        sinusoids(cfg["max_source_positions"], cfg["d_model"])).to(device, dtype)
    return tree


def transcriber(cfg: dict, params: dict, device):
    """The program's Transcriber over ``params``, through its public
    constructor, with the configuration's run options."""
    from audio_processor_tpu_torch.pipeline.transcribe import Transcriber

    from .tokenizer import WordTokenizer

    opts = cfg["run"]
    return Transcriber(
        params=params, cfg=whisper_config(cfg), device=device,
        tokenizer=WordTokenizer(eot=50257), compute_dtype=opts["compute_dtype"],
        cross_kv_bits=opts["cross_kv_bits"], max_new_tokens=cfg["max_new_tokens"],
        enable_fallback=opts["enable_fallback"],
    )
