"""Speaker-embedding extractor: ResNet34 + temporal statistics pooling.

The port of the JAX package's ``models/diarization/embedding.py``: 2D
convs over (time, mel) on 80-bin kaldi fbank, channels 32/64/128/256,
blocks 3/4/6/3, inference BatchNorm, statistics pooling and a linear to
256-d, L2-normalised.  Layout is channel-first (B, C, T, M); the JAX net
keeps channels last.

Padding is XLA's "SAME" (``embedding.py:109-112``), written out: total
(ceil(n / s) - 1) * s + k - n a side pair, the smaller half before.  On an
even input a stride-2 3x3 conv pads 0 before and 1 after, which torch's
``padding=1`` does not reproduce (same shape, shifted grid).  Convs and
BatchNorm run in ``compute_dtype`` (bf16 by default, as in JAX);
statistics pooling and ``fc`` stay in float32.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops import fbank as fbank_lib
from .segmentation import dequantize


@dataclass(frozen=True)
class EmbeddingConfig:
    n_mels: int = 80
    base_channels: int = 32
    blocks: tuple[int, ...] = (3, 4, 6, 3)
    embed_dim: int = 256
    crop_s: float = 3.0  # embedding window length
    sample_rate: int = 16_000

    @property
    def crop_samples(self) -> int:
        return int(self.crop_s * self.sample_rate)


def _bn(c: int) -> nn.ParameterDict:
    return nn.ParameterDict({
        "scale": nn.Parameter(torch.ones(c)), "bias": nn.Parameter(torch.zeros(c)),
        "mean": nn.Parameter(torch.zeros(c)), "var": nn.Parameter(torch.ones(c)),
    })


def _conv(cin: int, cout: int, k: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(cout, cin, k, k))


class BasicBlock(nn.Module):
    """Two 3x3 convs with BatchNorm and a residual; a 1x1 projection on the
    residual where the stride or the width changes."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv1, self.bn1 = _conv(cin, cout, 3), _bn(cout)
        self.conv2, self.bn2 = _conv(cout, cout, 3), _bn(cout)
        if stride != 1 or cin != cout:
            self.down_conv, self.down_bn = _conv(cin, cout, 1), _bn(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(batch_norm(self.bn1, conv2d(self.conv1, x, self.stride)))
        out = batch_norm(self.bn2, conv2d(self.conv2, out, 1))
        if hasattr(self, "down_conv"):
            x = batch_norm(self.down_bn, conv2d(self.down_conv, x, self.stride))
        return F.relu(out + x)


class ResNetEmbedding(nn.Module):
    """``forward``: kaldi fbank (B, T, n_mels) -> L2-normalised (B, embed_dim)."""

    def __init__(self, cfg: EmbeddingConfig = EmbeddingConfig()):
        super().__init__()
        self.cfg = cfg
        c = cfg.base_channels
        self.stem_conv, self.stem_bn = _conv(1, c, 3), _bn(c)
        stages, cin = [], c
        for si, n_blocks in enumerate(cfg.blocks):
            cout = c * 2**si
            stage = []
            for bi in range(n_blocks):
                stage.append(BasicBlock(cin, cout, 2 if (si > 0 and bi == 0) else 1))
                cin = cout
            stages.append(nn.ModuleList(stage))
        self.stages = nn.ModuleList(stages)
        # stats pooling width: 2 * channels * ceil(n_mels / 8) (SAME stride 2, x3)
        feat = 2 * cin * -(-cfg.n_mels // 8)
        self.fc = nn.ParameterDict({"w": nn.Parameter(torch.zeros(feat, cfg.embed_dim)),
                                    "b": nn.Parameter(torch.zeros(cfg.embed_dim))})
        self.requires_grad_(False)

    def forward(self, feats: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        # weights and statistics join each op in x's dtype, as JAX casts
        # every float32 leaf to compute_dtype before the convs
        x = feats.to(compute_dtype)[:, None]  # (B, 1, T, M)
        x = F.relu(batch_norm(self.stem_bn, conv2d(self.stem_conv, x, 1)))
        for stage in self.stages:
            for block in stage:
                x = block(x)
        # temporal statistics pooling per (mel band, channel), in float32,
        # flattened mel-major as the JAX net's (B, T, M, C) reshape
        b, c, t, m = x.shape
        flat = x.permute(0, 2, 3, 1).reshape(b, t, m * c).to(torch.float32)
        mean = flat.mean(dim=1)
        std = torch.sqrt(flat.var(dim=1, unbiased=False) + 1e-7)
        emb = torch.cat([mean, std], dim=-1) @ self.fc["w"] + self.fc["b"]
        return emb / torch.clamp(torch.linalg.norm(emb, dim=-1, keepdim=True), min=1e-9)


def batch_norm(p, x, eps=1e-5):
    """Inference BatchNorm over channels of x (B, C, H, W), in x's dtype:
    (x - mean) * rsqrt(var + eps) * scale + bias, the JAX op order."""
    def ch(a):
        return a.to(x.dtype)[:, None, None]

    return (x - ch(p["mean"])) * torch.rsqrt(ch(p["var"]) + eps) * ch(p["scale"]) + ch(p["bias"])


def _same_pad(n: int, k: int, s: int) -> tuple[int, int]:
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv2d(w: torch.Tensor, x: torch.Tensor, stride: int) -> torch.Tensor:
    """XLA "SAME" conv: w (C_out, C_in, kh, kw) in x's dtype, no bias."""
    kh, kw = w.shape[-2:]
    top, bottom = _same_pad(x.shape[-2], kh, stride)
    left, right = _same_pad(x.shape[-1], kw, stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w.to(x.dtype), stride=stride)


@torch.inference_mode()
def embed_crops(params: ResNetEmbedding, cfg: EmbeddingConfig, audio: torch.Tensor,
                compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """audio (B, crop_samples) -> (B, embed_dim), the fbank on audio's
    device.  int16 input is dequantised there."""
    feats = fbank_lib.fbank(dequantize(audio), n_mels=cfg.n_mels)
    return params(feats, compute_dtype)


def init_params(cfg: EmbeddingConfig, generator: torch.Generator) -> ResNetEmbedding:
    """Random weights at the JAX initialiser's scales (convs normal /
    sqrt(kh kw C_in), identity BatchNorm, fc normal / sqrt(fan_in)), on the
    generator's device."""
    dev = generator.device
    net = ResNetEmbedding(cfg).to(dev)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if p.ndim == 4:
                p.copy_(torch.randn(p.shape, generator=generator, device=dev)
                        / math.sqrt(p.shape[1] * p.shape[2] * p.shape[3]))
        net.fc["w"].copy_(torch.randn(net.fc["w"].shape, generator=generator, device=dev)
                          / math.sqrt(net.fc["w"].shape[0]))
    return net


def params_from_jax(tree: dict[str, Any], cfg: EmbeddingConfig = EmbeddingConfig(),
                    device="cpu") -> ResNetEmbedding:
    """The JAX package's params (numpy arrays or anything ``np.asarray``
    takes) -> a ``ResNetEmbedding`` on ``device``.  Conv kernels (kh, kw,
    C_in, C_out) become conv2d's (C_out, C_in, kh, kw)."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32))

    def bn(dst, src):
        for k in ("scale", "bias", "mean", "var"):
            dst[k].copy_(t(src[k]))

    net = ResNetEmbedding(cfg)
    with torch.no_grad():
        net.stem_conv.copy_(t(tree["stem_conv"]).permute(3, 2, 0, 1))
        bn(net.stem_bn, tree["stem_bn"])
        for stage, src_stage in zip(net.stages, tree["stages"], strict=True):
            for block, src in zip(stage, src_stage, strict=True):
                for conv, norm in (("conv1", "bn1"), ("conv2", "bn2"), ("down_conv", "down_bn")):
                    if hasattr(block, conv) != (conv in src):
                        raise ValueError(f"block layout differs from the config at {conv}")
                    if conv in src:
                        getattr(block, conv).copy_(t(src[conv]).permute(3, 2, 0, 1))
                        bn(getattr(block, norm), src[norm])
        net.fc["w"].copy_(t(tree["fc"]["w"]))
        net.fc["b"].copy_(t(tree["fc"]["b"]))
    return net.to(device)


def params_to_jax(net: ResNetEmbedding) -> dict[str, Any]:
    """The inverse of ``params_from_jax``: a net -> the JAX package's tree
    of float32 numpy arrays (conv kernels back to (kh, kw, C_in, C_out))."""
    def a(t):
        return t.detach().cpu().float().numpy().copy()

    def conv(w):
        return a(w.permute(2, 3, 1, 0))

    def bn(p):
        return {k: a(p[k]) for k in ("scale", "bias", "mean", "var")}

    stages = []
    for stage in net.stages:
        blocks = []
        for block in stage:
            b = {"conv1": conv(block.conv1), "bn1": bn(block.bn1),
                 "conv2": conv(block.conv2), "bn2": bn(block.bn2)}
            if hasattr(block, "down_conv"):
                b["down_conv"], b["down_bn"] = conv(block.down_conv), bn(block.down_bn)
            blocks.append(b)
        stages.append(blocks)
    return {"stem_conv": conv(net.stem_conv), "stem_bn": bn(net.stem_bn), "stages": stages,
            "fc": {"w": a(net.fc["w"]), "b": a(net.fc["b"])}}
