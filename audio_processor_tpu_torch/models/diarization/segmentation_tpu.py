"""The recurrence-free segmentation net: log-mel frontend, a strided conv
stem and a small pre-LN transformer encoder.

The port of the JAX package's ``models/diarization/segmentation_tpu.py``,
the net of the bundled diarizer.  Its log-mel is kernel A
(``ops/kernels/log_mel.log_mel``) on the card and the plain
``frontend.log_mel_spectrogram`` on the CPU, on whole windows: 10 s
(1,000 mel frames) at the config's published widths, 6 s (600) in the
bundled checkpoint.  The transformer uses the port's Whisper primitives
(``layer_norm``, ``linear``, ``sinusoids``), as the JAX net reuses its
own; attention (T=500, Dh=48 at the published widths) is plain matmuls
and a softmax, as JAX computes it outside Pallas.  The conv stem's GELU is the tanh form
(``jax.nn.gelu``'s default).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.kernels.log_mel import log_mel
from ..whisper.model import layer_norm, linear, sinusoids
from .segmentation import decode_powerset, dequantize

_BLOCK_KEYS = ("ln1", "q", "k", "v", "o", "ln2", "fc1", "fc2")


@dataclass(frozen=True)
class TpuSegmentationConfig:
    sample_rate: int = 16_000
    window_s: float = 10.0
    n_mels: int = 80
    d_model: int = 192
    n_head: int = 4
    n_layer: int = 4
    num_speakers: int = 3
    max_simultaneous: int = 2

    @property
    def window_samples(self) -> int:
        return int(self.window_s * self.sample_rate)

    @property
    def num_classes(self) -> int:
        n, k = self.num_speakers, self.max_simultaneous
        return sum(math.comb(n, r) for r in range(k + 1))

    @property
    def num_frames(self) -> int:
        # mel frames (10 ms) conv-subsampled x2 -> 20 ms segmentation frames
        return int(self.window_s * 100) // 2  # 500 per 10 s window

    @property
    def frame_step_s(self) -> float:
        return 0.02


def _ln(d: int) -> nn.ParameterDict:
    return nn.ParameterDict({"scale": nn.Parameter(torch.ones(d)), "bias": nn.Parameter(torch.zeros(d))})


def _lin(d_in: int, d_out: int) -> nn.ParameterDict:
    return nn.ParameterDict({"w": nn.Parameter(torch.zeros(d_in, d_out)),
                             "b": nn.Parameter(torch.zeros(d_out))})


class TpuSegmentationNet(nn.Module):
    """``forward``: audio (B, window_samples) float32 -> powerset logits
    (B, num_frames, num_classes).  Blocks hold the JAX keys; linears keep
    the JAX (d_in, d_out) layout that ``whisper.model.linear`` takes, the
    conv stem is ``nn.Conv1d``."""

    def __init__(self, cfg: TpuSegmentationConfig = TpuSegmentationConfig()):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.conv1 = nn.Conv1d(cfg.n_mels, d, 3, padding=1)
        self.conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1)
        self.blocks = nn.ModuleList(
            nn.ModuleDict({
                "ln1": _ln(d), "q": _lin(d, d), "k": _lin(d, d), "v": _lin(d, d),
                "o": _lin(d, d), "ln2": _ln(d), "fc1": _lin(d, 4 * d), "fc2": _lin(4 * d, d),
            })
            for _ in range(cfg.n_layer)
        )
        self.ln_out = _ln(d)
        self.classifier = _lin(d, cfg.num_classes)
        self.register_buffer("pos", torch.from_numpy(sinusoids(cfg.num_frames, d)), persistent=False)
        self.requires_grad_(False)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        mel = log_mel(audio.contiguous(), cfg.n_mels)  # (B, n_mels, T_mel)
        x = F.gelu(self.conv1(mel), approximate="tanh")
        x = F.gelu(self.conv2(x), approximate="tanh")  # (B, d, T_mel / 2)
        x = x.transpose(1, 2)[:, : cfg.num_frames] + self.pos
        h = cfg.n_head
        dh = cfg.d_model // h
        for bp in self.blocks:
            xn = layer_norm(bp["ln1"], x)
            b, t, _ = xn.shape
            q = linear(bp["q"], xn).reshape(b, t, h, dh)
            k = linear(bp["k"], xn).reshape(b, t, h, dh)
            v = linear(bp["v"], xn).reshape(b, t, h, dh)
            s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
            a = torch.softmax(s, dim=-1)
            o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(b, t, cfg.d_model)
            x = x + linear(bp["o"], o)
            mlp = F.gelu(linear(bp["fc1"], layer_norm(bp["ln2"], x)), approximate="tanh")
            x = x + linear(bp["fc2"], mlp)
        return linear(self.classifier, layer_norm(self.ln_out, x))


@torch.inference_mode()
def segment_windows(params: TpuSegmentationNet, cfg: TpuSegmentationConfig,
                    audio: torch.Tensor, hard: bool = False) -> torch.Tensor:
    """Same contract as ``segmentation.segment_windows``: (B, F,
    n_speakers); hard=True argmax-decodes the powerset."""
    return decode_powerset(params(dequantize(audio)), cfg, hard)


def init_params(cfg: TpuSegmentationConfig, generator: torch.Generator) -> TpuSegmentationNet:
    """Random weights at the JAX initialiser's scales (normal / sqrt(fan_in),
    zero biases, unit layer norms), on the generator's device."""
    dev = generator.device
    net = TpuSegmentationNet(cfg).to(dev)

    def normal(shape, fan_in):
        return torch.randn(shape, generator=generator, device=dev) / math.sqrt(fan_in)

    with torch.no_grad():
        for conv in (net.conv1, net.conv2):
            conv.weight.copy_(normal(conv.weight.shape, conv.weight.shape[1] * 3))
            conv.bias.zero_()
        for p in [*(bp[k] for bp in net.blocks for k in ("q", "k", "v", "o", "fc1", "fc2")),
                  net.classifier]:
            p["w"].copy_(normal(p["w"].shape, p["w"].shape[0]))
    return net


def params_from_jax(tree: dict[str, Any], cfg: TpuSegmentationConfig = TpuSegmentationConfig(),
                    device="cpu") -> TpuSegmentationNet:
    """The JAX package's params (numpy arrays or anything ``np.asarray``
    takes) -> a ``TpuSegmentationNet`` on ``device``.  The conv stem's
    (3, C_in, C_out) becomes conv1d's (C_out, C_in, 3); the rest keeps the
    JAX layout."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32))

    net = TpuSegmentationNet(cfg)
    with torch.no_grad():
        for name in ("conv1", "conv2"):
            getattr(net, name).weight.copy_(t(tree[name]["w"]).permute(2, 1, 0))
            getattr(net, name).bias.copy_(t(tree[name]["b"]))
        for bp, src in zip(net.blocks, tree["blocks"], strict=True):
            for key in _BLOCK_KEYS:
                for leaf, value in bp[key].items():
                    value.copy_(t(src[key][leaf]))
        for name in ("ln_out", "classifier"):
            for leaf, value in getattr(net, name).items():
                value.copy_(t(tree[name][leaf]))
    return net.to(device)


def params_to_jax(net: TpuSegmentationNet) -> dict[str, Any]:
    """The inverse of ``params_from_jax``: a net -> the JAX package's tree
    of float32 numpy arrays (the conv stem back to (3, C_in, C_out))."""
    def a(t):
        return t.detach().cpu().float().numpy().copy()

    tree: dict[str, Any] = {
        name: {"w": a(getattr(net, name).weight.permute(2, 1, 0)), "b": a(getattr(net, name).bias)}
        for name in ("conv1", "conv2")
    }
    tree["blocks"] = [{key: {leaf: a(v) for leaf, v in bp[key].items()} for key in _BLOCK_KEYS}
                      for bp in net.blocks]
    for name in ("ln_out", "classifier"):
        tree[name] = {leaf: a(v) for leaf, v in getattr(net, name).items()}
    return tree
