"""Fine-tuning Whisper: the teacher-forced loss, AdamW and the dp x tp step.

The port of the JAX package's ``training/train_step.py``: cross-entropy
over teacher-forced transcripts, in float32, then optax's
``chain(clip_by_global_norm(1.0), adamw(lr, b1=0.9, b2=0.98, eps=1e-6,
weight_decay, mask=ndim >= 2))`` written out in plain torch (``AdamW``).

The decay mask is the JAX one on the port's own leaves: every leaf with
two or more axes decays.  Layer parameters are stacked on a leading layer
axis, so the stacked layer norms and biases, (L, d), decay too; only the
unstacked ``ln_post``/``ln`` and the conv biases do not.

Under a (data, model) mesh every rank runs ``train_step`` on its own data
rank's rows of the batch, with its model rank's slices of the parameters
and both Adam moments (``shard_train_state``): the loss divides by the
mask sum of the whole batch, gradients are summed over the data group,
and the clip's global norm counts each split leaf's squares summed over
the model group and each replicated leaf once.  The model's forward
carries the gradients across the model group
(``parallel/mesh.copy_to_model``, ``reduce_from_model``).

    torchrun --nproc-per-node 4 -m audio_processor_tpu_torch.training.train_step \\
        --device cpu          # one dp2 x tp2 step at the dry-run config
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..models.whisper import model as whisper_model
from ..models.whisper.config import WhisperConfig
from ..parallel import mesh as mesh_lib
from ..parallel import sharding as sharding_lib


class AdamState(NamedTuple):
    count: int  # optax's ScaleByAdamState.count: updates taken
    mu: list  # first moments, one per leaf (``tree_leaves`` order)
    nu: list  # second moments


class TrainState(NamedTuple):
    params: Any
    opt_state: AdamState
    step: int


class Batch(NamedTuple):
    mel: torch.Tensor  # (B, n_mels, T_mel)
    tokens_in: torch.Tensor  # (B, T) decoder input (sot ...)
    tokens_out: torch.Tensor  # (B, T) shifted targets
    loss_mask: torch.Tensor  # (B, T) 1.0 on real tokens


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a parameter tree in a fixed order: dicts by sorted
    key (as ``jax.tree.leaves`` orders them, whatever order the dict was
    built in), lists and tuples in turn, a module's ``parameters()``."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    items = [tree[k] for k in sorted(tree)] if isinstance(tree, dict) else tree
    return [leaf for sub in items for leaf in tree_leaves(sub)]


def _decay_mask(leaves: list[torch.Tensor]) -> list[bool]:
    """Decay the leaves of two or more axes (the JAX mask, ndim >= 2)."""
    return [p.ndim >= 2 for p in leaves]


@dataclass(frozen=True)
class AdamW:
    """optax's ``chain(clip_by_global_norm(max_norm), adamw(...))`` over a
    list of float32 leaves, updated in place.

    The clip scales the gradients by max_norm / norm only when the global
    norm reaches max_norm (``clip_grad_norm_`` would divide by norm + 1e-6
    always).  Adam's bias corrections are float32, as optax's are."""

    lr: float
    weight_decay: float
    max_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.98
    eps: float = 1e-6

    def init(self, leaves: list[torch.Tensor]) -> AdamState:
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        return AdamState(0, zeros, [torch.zeros_like(z) for z in zeros])

    def update(self, grads: list[torch.Tensor], state: AdamState, leaves: list[torch.Tensor],
               g_norm: torch.Tensor | None = None) -> AdamState:
        """One step: ``leaves`` (and the moments) change in place.  g_norm:
        the global gradient norm, when the caller computed it over a mesh."""
        if g_norm is None:
            g_norm = global_norm(grads)
        with torch.no_grad():
            if not bool(g_norm < self.max_norm):
                grads = [g / g_norm * self.max_norm for g in grads]
            count = state.count + 1
            bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(count))
            bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(count))
            for p, g, mu, nu, decay in zip(leaves, grads, state.mu, state.nu, _decay_mask(leaves)):
                mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
                nu.mul_(self.b2).add_(g * g, alpha=1 - self.b2)
                u = (mu / bc1) / ((nu / bc2).sqrt() + self.eps)
                if decay and self.weight_decay:
                    u = u + self.weight_decay * p
                p.add_(u, alpha=-self.lr)
        return AdamState(count, state.mu, state.nu)


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))


def make_optimizer(lr: float = 1e-4, weight_decay: float = 0.01) -> AdamW:
    return AdamW(lr=lr, weight_decay=weight_decay, max_norm=1.0)


def value_and_grad(loss_of: Callable[[], torch.Tensor], leaves: list[torch.Tensor]):
    """(loss, gradients of the loss for ``leaves``): gradients are turned on
    for exactly these leaves, whatever the caller's grad mode."""
    before = [p.requires_grad for p in leaves]
    try:
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            loss = loss_of()
            grads = torch.autograd.grad(loss, leaves)
    finally:
        for p, flag in zip(leaves, before):
            p.requires_grad_(flag)
    return loss.detach(), list(grads)


def init_train_state(cfg: WhisperConfig, generator: torch.Generator, lr: float = 1e-4) -> TrainState:
    """Random params (``model.init_params``) on the generator's device."""
    params = whisper_model.init_params(cfg, generator)
    return TrainState(params, make_optimizer(lr).init(tree_leaves(params)), 0)


def loss_fn(params, cfg: WhisperConfig, batch: Batch, compute_dtype=torch.float32, mesh=None):
    """Mean next-token cross-entropy over the masked positions.  Under a
    mesh ``batch`` is this data rank's rows and the mean is over the whole
    batch's mask: the data ranks' losses sum to it."""
    audio = whisper_model.encode(params, cfg, batch.mel, compute_dtype=compute_dtype, mesh=mesh)
    logits = whisper_model.decode_logits(
        params, cfg, batch.tokens_in, audio, compute_dtype=compute_dtype, mesh=mesh
    ).float()
    logprobs = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logprobs, -1, batch.tokens_out[..., None].long())[..., 0]
    denom = mesh_lib.data_all_reduce(batch.loss_mask.sum().float(), mesh)
    return torch.sum(nll * batch.loss_mask) / torch.clamp(denom, min=1.0)


def _leaf_specs(params, cfg: WhisperConfig) -> list:
    """The Megatron spec of each leaf (``tree_leaves`` order): a
    ``sharding.Split``, or None for a replicated leaf."""
    def walk(p, s):
        if isinstance(p, dict):
            return [x for k in sorted(p) for x in walk(p[k], s[k])]
        return [s]

    return walk(params, sharding_lib.whisper_param_spec(cfg))


def mesh_global_norm(grads, split: list[bool], mesh) -> torch.Tensor:
    """The global norm of gradients held as model-rank slices: the split
    leaves' squares summed over the model axis, the replicated ones once."""
    sq = [torch.sum(g.float() * g.float()) for g in grads]
    zero = torch.zeros((), device=grads[0].device)
    split_sq = sum((q for q, s in zip(sq, split) if s), zero)
    rep_sq = sum((q for q, s in zip(sq, split) if not s), zero)
    return torch.sqrt(mesh_lib.all_reduce(split_sq.clone(), mesh) + rep_sq)


def train_step(state: TrainState, cfg: WhisperConfig, batch: Batch, lr: float = 1e-4,
               mesh=None) -> tuple[TrainState, torch.Tensor]:
    """One AdamW step; returns the new state (its tensors updated in place)
    and the loss of the whole batch.  lr may change from step to step."""
    leaves = tree_leaves(state.params)
    loss, grads = value_and_grad(lambda: loss_fn(state.params, cfg, batch, mesh=mesh), leaves)
    g_norm = None
    if mesh is not None and (mesh.dp > 1 or mesh.tp > 1):
        for g in grads:
            mesh_lib.data_all_reduce(g, mesh)
        loss = mesh_lib.data_all_reduce(loss.clone(), mesh)
        split = [spec is not None for spec in _leaf_specs(state.params, cfg)]
        g_norm = mesh_global_norm(grads, split, mesh)
    opt_state = make_optimizer(lr).update(grads, state.opt_state, leaves, g_norm)
    return TrainState(state.params, opt_state, state.step + 1), loss


def shard_train_state(state: TrainState, mesh, cfg: WhisperConfig) -> TrainState:
    """This rank's train state: its slices of the params and of both Adam
    moments under the Megatron spec, the replicated leaves whole."""
    params = sharding_lib.shard_params(state.params, mesh, cfg)
    specs = _leaf_specs(state.params, cfg)

    def place(moments):
        return [sharding_lib.shard_tensor(m, s, mesh) for m, s in zip(moments, specs, strict=True)]

    opt = state.opt_state
    return TrainState(params, AdamState(opt.count, place(opt.mu), place(opt.nu)), state.step)


# ---------------------------------------------------------------------------
# The dry run: one dp x tp step at a tiny config (the JAX package's
# ``dryrun_multichip`` training half)
# ---------------------------------------------------------------------------

DRYRUN_CONFIG = WhisperConfig(
    name="dryrun", n_mels=80, n_audio_ctx=32, n_audio_state=64, n_audio_head=4,
    n_audio_layer=2, n_vocab=512, n_text_ctx=32, n_text_state=64, n_text_head=4,
    n_text_layer=2,
)


def dryrun_batch(dp: int, seed: int = 0, t: int = 8) -> Batch:
    """The dry run's global batch (2 rows a data rank), on the CPU."""
    cfg = DRYRUN_CONFIG
    rng = np.random.default_rng(seed)
    b = 2 * dp
    return Batch(
        mel=torch.from_numpy(rng.normal(0, 1, (b, cfg.n_mels, 2 * cfg.n_audio_ctx)).astype(np.float32)),
        tokens_in=torch.from_numpy(rng.integers(0, cfg.n_vocab, (b, t))),
        tokens_out=torch.from_numpy(rng.integers(0, cfg.n_vocab, (b, t))),
        loss_mask=torch.ones((b, t), dtype=torch.float32),
    )


def local_batch(batch: Batch, mesh, device) -> Batch:
    """This data rank's rows of a global batch, on ``device``."""
    rows = slice(None) if mesh is None else mesh.local_rows(len(batch.mel))
    return Batch(*(x[rows].to(device) for x in batch))


def dryrun_multichip(world: int, model_parallel: int | None = None, device=None,
                     seed: int = 0) -> tuple[float, TrainState]:
    """One dp x tp train step over the ranks of the default process group
    (``world`` of them; tp = 2 when it divides, else 1).  Every rank calls
    it; returns (the whole batch's loss, this rank's new state)."""
    import torch.distributed as dist

    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != world:
        raise ValueError(f"dryrun_multichip({world}) needs a world of {world} ranks, found {have}")
    tp = model_parallel or (2 if world % 2 == 0 else 1)
    mesh = mesh_lib.make_mesh(tp, device)
    cfg = DRYRUN_CONFIG
    state = init_train_state(cfg, torch.Generator().manual_seed(seed))
    state = shard_train_state(state, mesh, cfg)
    batch = local_batch(dryrun_batch(mesh.dp, seed), mesh, mesh.device)
    state, loss = train_step(state, cfg, batch, mesh=mesh)
    loss = float(loss)
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    return loss, state


def main(argv: list[str] | None = None) -> None:
    from ..parallel import multihost

    ap = argparse.ArgumentParser(description="one dp x tp train step at the dry-run config")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--model-parallel", type=int, default=None)
    args = ap.parse_args(argv)
    multihost.initialize(device=args.device)
    try:
        import torch.distributed as dist

        world = dist.get_world_size() if dist.is_initialized() else 1
        loss, state = dryrun_multichip(world, args.model_parallel, args.device)
        if not dist.is_initialized() or dist.get_rank() == 0:
            print(f"dryrun_multichip train ok: world={world} loss={loss:.6f}")
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main()
