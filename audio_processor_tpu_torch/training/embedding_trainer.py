"""Speaker-embedding training: AAM-softmax (ArcFace) on the ResNet.

The port of the JAX package's ``training/embedding_trainer.py``: an
additive angular margin on the target class before a scaled softmax,
over L2-normalised embeddings and a head of speaker prototypes, trained
by AdamW (clip 3.0), with synthetic speakers for hermetic data and the
checkpoint format the serving Diarizer reads.

The features are ``ops/fbank.fbank`` (no gradient) and the net is the
port's ``ResNetEmbedding``, whose convs and BatchNorm run in bf16 by
default, as the JAX forward does.  Its BatchNorm is the inference form
over stored statistics, and those statistics are parameters: the
gradient reaches them and AdamW updates them (undecayed, being 1-D), as
in JAX.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.diarization import embedding as emb
from ..models.diarization.checkpoint import (  # noqa: F401  (the checkpoint's readers)
    load_cluster_threshold, load_embedding_params, synth_voice,
)
from ..ops import fbank as fbank_lib
from .pytree_io import flatten_tree
from .train_step import AdamState, AdamW, tree_leaves, value_and_grad


class EmbTrainState(NamedTuple):
    params: emb.ResNetEmbedding
    head_w: torch.Tensor  # (n_speakers, embed_dim) classification prototypes
    opt_state: AdamState
    step: int


def make_optimizer(lr: float = 1e-3, weight_decay: float = 1e-4) -> AdamW:
    return AdamW(lr=lr, weight_decay=weight_decay, max_norm=3.0)


def init_train_state(cfg: emb.EmbeddingConfig, n_speakers: int, generator: torch.Generator,
                     lr: float = 1e-3) -> EmbTrainState:
    """Random net (``embedding.init_params``) and unit-norm prototypes, on
    the generator's device."""
    net = emb.init_params(cfg, generator)
    head = torch.randn((n_speakers, cfg.embed_dim), generator=generator, device=generator.device)
    head = head / torch.linalg.norm(head, dim=-1, keepdim=True)
    return EmbTrainState(net, head, make_optimizer(lr).init(tree_leaves((net, head))), 0)


def aam_softmax_loss(
    params: emb.ResNetEmbedding,
    head_w: torch.Tensor,
    cfg: emb.EmbeddingConfig,
    audio: torch.Tensor,  # (B, crop_samples) float32
    labels: torch.Tensor,  # (B,) speaker ids
    *,
    margin: float = 0.2,
    scale: float = 30.0,
) -> torch.Tensor:
    """Additive-angular-margin softmax over L2-normalised embeddings."""
    feats = fbank_lib.fbank(audio, n_mels=cfg.n_mels)
    e = params(feats)  # (B, D), unit-norm
    w = head_w / torch.clamp(torch.linalg.norm(head_w, dim=-1, keepdim=True), min=1e-9)
    cos = e @ w.T  # (B, n_speakers) = cos(theta)
    # cos(theta + m) on the target class only
    sin = torch.sqrt(torch.clamp(1.0 - cos**2, 1e-9, 1.0))
    cos_m = cos * math.cos(margin) - sin * math.sin(margin)
    # the easy-margin guard: the margin applies only while cos > 0
    cos_target = torch.where(cos > 0, cos_m, cos)
    onehot = F.one_hot(labels.long(), head_w.shape[0]).float()
    logits = scale * torch.where(onehot > 0, cos_target, cos)
    logprobs = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(onehot * logprobs, dim=-1))


def train_step(
    state: EmbTrainState,
    cfg: emb.EmbeddingConfig,
    audio: torch.Tensor,
    labels: torch.Tensor,
    lr: float = 1e-3,
    margin: float = 0.2,
    scale: float = 30.0,
) -> tuple[EmbTrainState, torch.Tensor]:
    """One AdamW step on the net and the head (updated in place); returns
    the new state and the loss.  lr may change from step to step."""
    leaves = tree_leaves((state.params, state.head_w))
    loss, grads = value_and_grad(
        lambda: aam_softmax_loss(state.params, state.head_w, cfg, audio, labels,
                                 margin=margin, scale=scale), leaves)
    opt_state = make_optimizer(lr).update(grads, state.opt_state, leaves)
    return EmbTrainState(state.params, state.head_w, opt_state, state.step + 1), loss


# ---------------------------------------------------------------------------
# Hermetic synthetic speakers
# ---------------------------------------------------------------------------

def synth_speaker_crop(rng: np.random.Generator, speaker_f0: float,
                       cfg: emb.EmbeddingConfig) -> np.ndarray:
    """One crop of a synthetic 'speaker' (the segmentation trainer's
    harmonic-stack voice, so the two recipes share a notion of speaker)."""
    n = cfg.crop_samples
    x = rng.normal(0, 0.003, n).astype(np.float32)
    x += synth_voice(rng, speaker_f0 * rng.uniform(0.97, 1.03), n, cfg.sample_rate)
    return x


def embedding_separation(params: emb.ResNetEmbedding, cfg: emb.EmbeddingConfig,
                         crops: np.ndarray, labels: np.ndarray) -> float:
    """Mean intra-speaker cosine minus mean inter-speaker cosine, the
    margin AHC clusters on (0.0 when either set of pairs is empty)."""
    device = next(params.parameters()).device
    e = emb.embed_crops(params, cfg, torch.from_numpy(np.asarray(crops)).to(device))
    e = e.float().cpu().numpy()
    sims = e @ e.T
    same = labels[:, None] == labels[None, :]
    off_diag = ~np.eye(len(labels), dtype=bool)
    intra = sims[same & off_diag]
    inter = sims[~same]
    if intra.size == 0 or inter.size == 0:
        return 0.0
    return float(intra.mean() - inter.mean())


# ---------------------------------------------------------------------------
# Serialisation (served with pipeline/diarize.Diarizer(emb_params=...))
# ---------------------------------------------------------------------------

def save_params(path: str, params: emb.ResNetEmbedding, cfg: emb.EmbeddingConfig,
                cluster_threshold: float | None = None) -> None:
    """Trained embedding net + config -> one ``.npz`` (the JAX package's
    format); ``cluster_threshold``, an AHC cut calibrated for this
    embedding space, rides along as ``meta.cluster_threshold``."""
    flat = {f"p.{k}": v for k, v in flatten_tree(emb.params_to_jax(params)).items()}
    for field in ("n_mels", "base_channels", "embed_dim", "sample_rate"):
        flat[f"cfg.{field}"] = np.asarray(getattr(cfg, field))
    flat["cfg.blocks"] = np.asarray(cfg.blocks)
    flat["cfg.crop_s"] = np.asarray(cfg.crop_s)
    if cluster_threshold is not None:
        flat["meta.cluster_threshold"] = np.asarray(float(cluster_threshold))
    np.savez(path, **flat)


def load_params(path: str, device="cpu") -> tuple[emb.ResNetEmbedding, emb.EmbeddingConfig]:
    """A checkpoint of ``save_params`` -> (the net on ``device``, config)."""
    tree, cfg = load_embedding_params(path)
    return emb.params_from_jax(tree, cfg, device), cfg
