"""Sliding-window speaker segmentation: the pyannote-compatible PyanNet.

The port of the JAX package's ``models/diarization/segmentation.py``:
its config, the powerset membership matrix (which the TPU-first net of
``segmentation_tpu.py`` and the Diarizer share) and the PyanNet
topology: a parametric sinc filterbank (stride 10) -> two conv blocks ->
a 4-layer bidirectional LSTM -> 2 linear layers -> a 7-class powerset
head (3 speakers, at most 2 at once).

The JAX package runs the LSTM as ``lax.scan``, outside any Pallas kernel;
here it is ``torch.nn.LSTM`` (cuDNN on the card).  Its gate order
(i, f, g, o) is the JAX cell's; ``params_from_jax`` transposes the
weights into it.  Convs are channel-first (B, C, T); the JAX net keeps
time second (B, T, C).
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class SegmentationConfig:
    sample_rate: int = 16_000
    window_s: float = 10.0
    sinc_filters: int = 80
    sinc_kernel: int = 251
    sinc_stride: int = 10
    conv_channels: int = 60
    conv_kernel: int = 5
    pool: int = 3
    lstm_hidden: int = 128
    lstm_layers: int = 4
    linear_dim: int = 128
    num_speakers: int = 3
    max_simultaneous: int = 2

    @property
    def window_samples(self) -> int:
        return int(self.window_s * self.sample_rate)

    @property
    def num_classes(self) -> int:
        """Powerset size: empty + singles + pairs (3 spk, <=2 active) = 7."""
        n, k = self.num_speakers, self.max_simultaneous
        return sum(math.comb(n, r) for r in range(k + 1))

    @property
    def num_frames(self) -> int:
        n = (self.window_samples - self.sinc_kernel) // self.sinc_stride + 1
        n = n // self.pool
        n = (n - (self.conv_kernel - 1)) // self.pool
        n = (n - (self.conv_kernel - 1)) // self.pool
        return n

    @property
    def frame_step_s(self) -> float:
        return (self.sinc_stride * self.pool**3) / self.sample_rate


def powerset_matrix(cfg) -> np.ndarray:
    """(num_classes, num_speakers) 0/1 matrix: class -> active speakers.

    pyannote's Powerset order: by subset size, then lexicographic —
    [], [0], [1], [2], [01], [02], [12].  ``cfg`` needs only
    ``num_speakers`` and ``max_simultaneous``.
    """
    rows = []
    for size in range(cfg.max_simultaneous + 1):
        for combo in itertools.combinations(range(cfg.num_speakers), size):
            row = np.zeros(cfg.num_speakers, np.float32)
            row[list(combo)] = 1.0
            rows.append(row)
    return np.stack(rows)


def decode_powerset(logits: torch.Tensor, cfg, hard: bool = False) -> torch.Tensor:
    """Powerset logits (B, F, C) -> per-speaker activations (B, F, S).

    Soft: softmaxed classes summed through the membership matrix (the
    probability that each local speaker is active).  hard=True argmax-
    decodes each frame to its class's 0/1 row: pyannote-3.1's
    ``to_multilabel``, the parity path for converted checkpoints."""
    member = torch.from_numpy(powerset_matrix(cfg)).to(logits.device)
    if hard:
        return member[logits.argmax(dim=-1)]
    return torch.softmax(logits, dim=-1) @ member


def dequantize(audio: torch.Tensor) -> torch.Tensor:
    """int16 windows (the host->device wire type) -> float32 in [-1, 1)."""
    if audio.dtype == torch.int16:
        return audio.to(torch.float32) / 32768.0
    return audio.to(torch.float32)


# ---------------------------------------------------------------------------
# The net
# ---------------------------------------------------------------------------

def _affine(n: int) -> nn.ParameterDict:
    return nn.ParameterDict({
        "scale": nn.Parameter(torch.ones(n), requires_grad=False),
        "bias": nn.Parameter(torch.zeros(n), requires_grad=False),
    })


def _mel_init_bands(n_filters: int, sr: int) -> tuple[np.ndarray, np.ndarray]:
    """Mel-spaced (low_hz, band_hz) init for the sinc filters."""
    low_hz, high_hz = 30.0, sr / 2 - 100.0
    mel = np.linspace(2595 * np.log10(1 + low_hz / 700), 2595 * np.log10(1 + high_hz / 700),
                      n_filters + 1)
    hz = 700 * (10 ** (mel / 2595) - 1)
    return hz[:-1].astype(np.float32), np.diff(hz).astype(np.float32)


class PyanNet(nn.Module):
    """SincNet + BiLSTM segmentation net; ``forward``: audio (B,
    window_samples) float32 -> powerset logits (B, num_frames, 7)."""

    def __init__(self, cfg: SegmentationConfig = SegmentationConfig()):
        super().__init__()
        self.cfg = cfg
        c, k = cfg.conv_channels, cfg.conv_kernel
        low, band = _mel_init_bands(cfg.sinc_filters, cfg.sample_rate)
        self.wav_norm = _affine(1)
        self.sinc = nn.ParameterDict({
            "low_hz": nn.Parameter(torch.from_numpy(low), requires_grad=False),
            "band_hz": nn.Parameter(torch.from_numpy(band), requires_grad=False),
        })
        self.norm0 = _affine(cfg.sinc_filters)
        self.conv1 = nn.Conv1d(cfg.sinc_filters, c, k)
        self.norm1 = _affine(c)
        self.conv2 = nn.Conv1d(c, c, k)
        self.norm2 = _affine(c)
        self.lstm = nn.LSTM(c, cfg.lstm_hidden, cfg.lstm_layers, batch_first=True,
                            bidirectional=True)
        self.linear1 = nn.Linear(2 * cfg.lstm_hidden, cfg.linear_dim)
        self.linear2 = nn.Linear(cfg.linear_dim, cfg.linear_dim)
        self.classifier = nn.Linear(cfg.linear_dim, cfg.num_classes)
        self.requires_grad_(False)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = _instance_norm(self.wav_norm, audio[:, None, :])  # (B, 1, T)
        # sinc conv, stride 10, |.|, maxpool 3, instance-norm, leaky-relu
        x = F.conv1d(x, materialize_sinc_filters(self.sinc, cfg), stride=cfg.sinc_stride)
        x = F.max_pool1d(x.abs(), cfg.pool)
        x = F.leaky_relu(_instance_norm(self.norm0, x))
        for conv, norm in ((self.conv1, self.norm1), (self.conv2, self.norm2)):
            x = F.max_pool1d(conv(x), cfg.pool)
            x = F.leaky_relu(_instance_norm(norm, x))
        # 4-layer bidirectional LSTM over frames: [forward, backward] states
        x, _ = self.lstm(x.transpose(1, 2).contiguous())
        x = F.leaky_relu(self.linear1(x))
        x = F.leaky_relu(self.linear2(x))
        return self.classifier(x)


def _instance_norm(p, x, eps=1e-5):
    """InstanceNorm1d over time, per (batch, channel): x (B, C, T)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"][:, None] + p["bias"][:, None]


def materialize_sinc_filters(p, cfg: SegmentationConfig) -> torch.Tensor:
    """Parametric band-pass filters -> (n_filters, 1, kernel) conv1d weights.

    SincConv_fast's construction, as the JAX function builds it
    (``segmentation.py:183``): min_low_hz = min_band_hz = 50, a windowed
    ideal band-pass (sin(2 pi h t) - sin(2 pi l t)) / (pi t) with centre tap
    2 (h - l), peak-normalised, SincNet's mirrored Hamming variant with an
    unwindowed centre tap.
    """
    sr = cfg.sample_rate
    min_low_hz = min_band_hz = 50.0
    low = min_low_hz + p["low_hz"].abs()
    high = torch.clamp(low + min_band_hz + p["band_hz"].abs(), min_low_hz, sr / 2)
    band = high - low
    k = cfg.sinc_kernel
    half = (k - 1) // 2
    dev = low.device
    t = (torch.arange(-half, half + 1, device=dev, dtype=torch.float32) / sr)[:, None]
    n_lin = torch.linspace(0.0, (k / 2) - 1, k // 2, device=dev)
    w_left = 0.54 - 0.46 * torch.cos(2 * math.pi * n_lin / k)
    window = torch.cat([w_left, torch.ones(1, device=dev), w_left.flip(0)])[:, None]
    t_safe = torch.where(t == 0.0, torch.ones_like(t), t)
    num = torch.sin(2 * math.pi * high[None, :] * t) - torch.sin(2 * math.pi * low[None, :] * t)
    filt = num / (math.pi * t_safe)
    filt = torch.where(t == 0.0, 2.0 * band[None, :], filt)
    filt = filt * window / (2.0 * band[None, :])  # (k, n_filters)
    return filt.T[:, None, :].contiguous()


@torch.inference_mode()
def segment_windows(params: PyanNet, cfg: SegmentationConfig, audio: torch.Tensor,
                    hard: bool = False) -> torch.Tensor:
    """Batched forward + powerset decode -> (B, num_frames, num_speakers)
    activations in [0, 1].  int16 input is dequantised on its device."""
    return decode_powerset(params(dequantize(audio)), cfg, hard)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def init_params(cfg: SegmentationConfig, generator: torch.Generator) -> PyanNet:
    """Random weights at the JAX initialiser's scales (normal / sqrt(fan_in)
    convs and linears, uniform +-1/sqrt(H) LSTM weights, zero biases, unit
    norms, mel-spaced sinc bands), on the generator's device."""
    dev = generator.device
    net = PyanNet(cfg).to(dev)

    def normal(shape, fan_in):
        return torch.randn(shape, generator=generator, device=dev) / math.sqrt(fan_in)

    with torch.no_grad():
        for conv in (net.conv1, net.conv2):
            conv.weight.copy_(normal(conv.weight.shape, conv.weight.shape[1] * conv.weight.shape[2]))
            conv.bias.zero_()
        for lin in (net.linear1, net.linear2, net.classifier):
            lin.weight.copy_(normal(lin.weight.shape, lin.weight.shape[1]))
            lin.bias.zero_()
        s = 1.0 / math.sqrt(cfg.lstm_hidden)
        for name, w in net.lstm.named_parameters():
            if name.startswith("weight"):
                w.copy_(torch.rand(w.shape, generator=generator, device=dev) * 2 * s - s)
            else:
                w.zero_()
    return net


def params_from_jax(tree: dict[str, Any], cfg: SegmentationConfig = SegmentationConfig(),
                    device="cpu") -> PyanNet:
    """The JAX package's PyanNet params (numpy arrays or anything
    ``np.asarray`` takes) -> a ``PyanNet`` on ``device``.

    Convs (k, C_in, C_out) become conv1d's (C_out, C_in, k); linears
    (d_in, d_out) become ``nn.Linear``'s (d_out, d_in); each LSTM layer's
    forward and backward cells go to ``weight_*_l{i}`` and
    ``weight_*_l{i}_reverse``: wi (d_in, 4H) and wh (H, 4H) transposed, the
    gate blocks (i, f, g, o) kept in order, bi and bh as torch's two
    biases (the JAX cell adds both)."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32))

    net = PyanNet(cfg)
    with torch.no_grad():
        for name in ("wav_norm", "norm0", "norm1", "norm2"):
            for k in ("scale", "bias"):
                getattr(net, name)[k].copy_(t(tree[name][k]))
        for k in ("low_hz", "band_hz"):
            net.sinc[k].copy_(t(tree["sinc"][k]))
        for name in ("conv1", "conv2"):
            getattr(net, name).weight.copy_(t(tree[name]["w"]).permute(2, 1, 0))
            getattr(net, name).bias.copy_(t(tree[name]["b"]))
        for name in ("linear1", "linear2", "classifier"):
            getattr(net, name).weight.copy_(t(tree[name]["w"]).T)
            getattr(net, name).bias.copy_(t(tree[name]["b"]))
        for i, layer in enumerate(tree["lstm"]):
            for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
                p = layer[direction]
                getattr(net.lstm, f"weight_ih_l{i}{suffix}").copy_(t(p["wi"]).T)
                getattr(net.lstm, f"weight_hh_l{i}{suffix}").copy_(t(p["wh"]).T)
                getattr(net.lstm, f"bias_ih_l{i}{suffix}").copy_(t(p["bi"]))
                getattr(net.lstm, f"bias_hh_l{i}{suffix}").copy_(t(p["bh"]))
    return net.to(device)
