"""Tensor-parallel sharding of the Whisper parameters over the model axis.

The port's own copy of the JAX package's ``parallel/sharding.py`` spec
tree, Megatron's layout in the (d_in, d_out) weight convention both
packages use:

  * q, k, v and fc1: column parallel -- d_out split, bias included;
  * attention out and fc2: row parallel -- d_in split, bias replicated
    (the rank's partial products are all-reduced, then the bias is added
    once: ``models/whisper/model.py`` ``row_parallel_linear``);
  * conv stem, embeddings and layer norms: replicated.

Stacked layer parameters carry a leading L axis.  A spec leaf is
``Split(dim, units)``: axis ``dim`` holds ``units`` equal blocks (heads for
attention, hidden units for the MLP) and each model rank keeps a
contiguous run of them (``mesh.split_bounds``); None is replicated.  When the
units divide tp the runs are equal, and each rank's slice is the JAX
``NamedSharding`` shard of the same leaf exactly.  Heads that do not
divide tp split unevenly (whole heads per rank).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.whisper.config import WhisperConfig
from ..models.whisper.model import Params
from .mesh import Mesh, split_bounds


class Split(NamedTuple):
    dim: int  # the axis split over the model ranks
    units: int  # equal blocks along it; each rank keeps a contiguous run


def _attn_spec(heads: int) -> dict:
    return {
        "q": {"w": Split(2, heads), "b": Split(1, heads)},
        "k": {"w": Split(2, heads)},
        "v": {"w": Split(2, heads), "b": Split(1, heads)},
        "out": {"w": Split(1, heads), "b": None},
    }


def _ln_spec() -> dict:
    return {"scale": None, "bias": None}


def _block_spec(heads: int, hidden: int, cross: bool) -> dict:
    spec = {
        "attn_ln": _ln_spec(),
        "attn": _attn_spec(heads),
        "mlp_ln": _ln_spec(),
        "fc1": {"w": Split(2, hidden), "b": Split(1, hidden)},
        "fc2": {"w": Split(1, hidden), "b": None},
    }
    if cross:
        spec["cross_attn_ln"] = _ln_spec()
        spec["cross_attn"] = _attn_spec(heads)
    return spec


def whisper_param_spec(cfg: WhisperConfig) -> dict:
    """Spec tree matching ``models.whisper.model.init_params``."""
    return {
        "encoder": {
            "conv1": {"w": None, "b": None},
            "conv2": {"w": None, "b": None},
            "pos_emb": None,
            "blocks": _block_spec(cfg.n_audio_head, 4 * cfg.n_audio_state, cross=False),
            "ln_post": {"scale": None, "bias": None},
        },
        "decoder": {
            "token_emb": None,
            "pos_emb": None,
            "blocks": _block_spec(cfg.n_text_head, 4 * cfg.n_text_state, cross=True),
            "ln": {"scale": None, "bias": None},
        },
    }


def shard_tensor(t: torch.Tensor, split: Split | None, mesh: Mesh) -> torch.Tensor:
    """This model rank's slice of ``t`` under ``split`` (all of it when
    None or tp == 1), contiguous, on the mesh's device."""
    if split is not None and mesh.tp > 1:
        size = t.shape[split.dim]
        if size % split.units:
            raise ValueError(f"axis {split.dim} of size {size} is not {split.units} equal blocks")
        lo, hi = split_bounds(split.units, mesh)
        width = size // split.units
        t = t.narrow(split.dim, lo * width, (hi - lo) * width)
    return t.contiguous().to(mesh.device)


class ShardedParams(dict):
    """A parameter tree that already holds one model rank's slices:
    ``layout`` is (tp, model_rank) of the mesh it was cut for.  A
    Transcriber rebuilt from it (``dataclasses.replace``) keeps it as it
    is instead of slicing the slices again."""

    def __init__(self, tree: Params, layout: tuple[int, int]):
        super().__init__(tree)
        self.layout = layout


def layout_of(mesh: Mesh) -> tuple[int, int]:
    return (mesh.tp, mesh.model_rank)


def shard_params(params: Params, mesh: Mesh, cfg: WhisperConfig) -> ShardedParams:
    """This rank's parameters: its contiguous slice of every split leaf and
    the replicated leaves whole, on the mesh's device."""
    if isinstance(params, ShardedParams):
        raise ValueError(f"the parameters are already sharded (tp, model rank) = {params.layout}")

    def walk(p, s):
        if isinstance(p, dict):
            return {k: walk(v, s[k]) for k, v in p.items()}
        return shard_tensor(p, s, mesh)

    return ShardedParams(walk(params, whisper_param_spec(cfg)), layout_of(mesh))
