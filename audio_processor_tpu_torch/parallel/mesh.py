"""The (data, model) mesh on ``torch.distributed``: one process per rank.

The port of the JAX package's ``parallel/mesh.py``.  JAX builds one
``Mesh`` over every device from a single controller; here every rank is a
process of its own (the SPMD idiom of ``torchrun``) and holds a ``Mesh``
that says where it sits:

  * "data"  -- each slab's 30 s windows are split over the data ranks;
  * "model" -- attention heads and the MLP hidden units are split over the
               model ranks, Megatron-style (``parallel/sharding.py``).

Ranks are laid out as JAX lays out its device grid: rank = data_rank * tp
+ model_rank, so a model group is tp consecutive ranks.  Without an
initialised process group the mesh is 1x1 and every collective is the
identity, so every code path stays mesh-aware without special cases.

The collectives live here, and nothing else in the port calls
``torch.distributed``: ``all_reduce`` over the model group (the
row-parallel products), ``model_all_gather`` over it (each rank's heads of
the alignment pass's cross-attention, in head order), ``all_gather`` over
the data group (each data rank's decode results and diarizer rows),
``all_gather_object`` over it (each data rank's word lists),
``data_all_reduce`` (the training step's gradients, loss and mask sums),
and over the world, on the mesh controller's own gloo group
(``control_group``, ``parallel/controller.py``): ``broadcast`` /
``broadcast_object`` from rank 0 (its calls) and ``world_gather_object``
(how each rank's replay of a call ended).  The mesh's collectives take
CUDA tensors under NCCL and under gloo (which lets several ranks share one
card).

Under autograd (the sharded train step) the model's two model-group
crossings are Megatron's pair of functions: ``copy_to_model`` (identity
forward, all-reduced gradient) at the input of each column-parallel
product, and ``reduce_from_model`` (the all-reduce forward, identity
backward) in each row-parallel product.  On a tensor that needs no
gradient both are exactly the serving path's ops.
"""
from __future__ import annotations

import datetime
import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from ..runtime.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, model) mesh."""

    dp: int
    tp: int
    data_rank: int
    model_rank: int
    device: torch.device
    model_group: Any = None  # process group of this rank's model axis (tp > 1)
    data_group: Any = None  # process group of this rank's data axis (dp > 1)

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.dp, MODEL_AXIS: self.tp}

    def local_rows(self, n: int) -> slice:
        """This data rank's rows of an n-row batch (n divisible by dp)."""
        if n % self.dp:
            raise ValueError(f"a batch of {n} does not split over {self.dp} data ranks")
        per = n // self.dp
        return slice(self.data_rank * per, (self.data_rank + 1) * per)


def make_mesh(model_parallel: int = 1, device=None) -> Mesh:
    """The (data, model) mesh over every rank of the default process group.

    model_parallel must divide the world size; the rest is data parallel.
    With no process group this is the 1x1 mesh.  Every rank must call it
    (the groups are made collectively).  ``device``: this rank's device,
    by default its card (``resolve_device``).
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} must divide {world} ranks")
    tp, dp = model_parallel, world // model_parallel
    model_group = data_group = None
    # new_group is collective: every rank makes every group, in one order
    if tp > 1:
        for d in range(dp):
            g = dist.new_group([d * tp + m for m in range(tp)])
            if rank // tp == d:
                model_group = g
    if dp > 1:
        for m in range(tp):
            g = dist.new_group([d * tp + m for d in range(dp)])
            if rank % tp == m:
                data_group = g
    return Mesh(dp, tp, rank // tp, rank % tp, resolve_device(device), model_group, data_group)


def split_bounds(units: int, mesh: Mesh | None) -> tuple[int, int]:
    """This model rank's contiguous run [lo, hi) of ``units`` equal blocks
    (heads, hidden units): equal runs when tp divides units, whole blocks
    either way; all of them when tp == 1."""
    if mesh is None or mesh.tp == 1:
        return 0, units
    return mesh.model_rank * units // mesh.tp, (mesh.model_rank + 1) * units // mesh.tp


def round_up_batch(n: int, mesh: Mesh | None) -> int:
    """Smallest batch >= n that divides evenly over the data axis."""
    d = 1 if mesh is None else mesh.dp
    return int(math.ceil(n / d) * d)


def all_reduce(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Sum of x over the model axis (in place; x itself when tp == 1)."""
    if mesh is None or mesh.tp == 1:
        return x
    dist.all_reduce(x, group=mesh.model_group)
    return x


def all_gather(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """x of every data rank, concatenated along axis 0 in data-rank order
    (x itself when dp == 1).  Every data rank passes the same shape."""
    if mesh is None or mesh.dp == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.dp)]
    dist.all_gather(parts, x, group=mesh.data_group)
    return torch.cat(parts, dim=0)


def model_all_gather(x: torch.Tensor, mesh: Mesh | None, dim: int, units: int) -> torch.Tensor:
    """x of every model rank, concatenated along ``dim`` in model-rank order
    (x itself when tp == 1): each rank holds its run of ``units`` blocks
    (``split_bounds``), so the result holds all of them in order, e.g. every
    head of a layer.  Runs of unequal length are padded for the gather and
    cut back."""
    if mesh is None or mesh.tp == 1:
        return x
    sizes = [(r + 1) * units // mesh.tp - r * units // mesh.tp for r in range(mesh.tp)]
    block = x.shape[dim] // sizes[mesh.model_rank]
    pad = max(sizes) * block - x.shape[dim]
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim=dim)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.tp)]
    dist.all_gather(parts, x, group=mesh.model_group)
    return torch.cat([p.narrow(dim, 0, n * block) for p, n in zip(parts, sizes)], dim=dim)


def all_gather_object(obj: Any, mesh: Mesh | None) -> list:
    """``obj`` (picklable) of every data rank, in data-rank order ([obj]
    when dp == 1)."""
    if mesh is None or mesh.dp == 1:
        return [obj]
    out: list = [None] * mesh.dp
    dist.all_gather_object(out, obj, group=mesh.data_group)
    return out


def control_group(timeout_s: float):
    """A gloo group over the whole world whose collectives wait up to
    ``timeout_s`` (None without a process group).  Every rank must call it,
    in the same order as the mesh's groups."""
    if not (dist.is_initialized() and dist.get_world_size() > 1):
        return None
    return dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=timeout_s))


def broadcast(x: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s x on every rank of ``group`` (in place; x itself when
    group is None).  Every rank passes a tensor of that shape."""
    if group is not None:
        dist.broadcast(x, src, group=group)
    return x


def broadcast_object(obj: Any, group, src: int = 0) -> Any:
    """Rank ``src``'s picklable ``obj`` on every rank of ``group`` (obj
    itself when group is None); the other ranks pass anything."""
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src, group=group)
    return box[0]


def world_gather_object(obj: Any, group) -> list:
    """``obj`` (picklable) of every rank of ``group``, in rank order ([obj]
    when group is None)."""
    if group is None:
        return [obj]
    out: list = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def data_all_reduce(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Sum of x over the data axis (in place; x itself when dp == 1)."""
    if mesh is None or mesh.dp == 1:
        return x
    dist.all_reduce(x, group=mesh.data_group)
    return x


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(), ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x.clone(), mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """x, whose gradient is summed over the model axis: each model rank's
    heads or hidden units contribute part of it.  x itself without a
    gradient or when tp == 1."""
    if mesh is None or mesh.tp == 1 or not x.requires_grad:
        return x
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """``all_reduce`` over the model axis; under autograd its gradient
    passes through unchanged (every model rank holds the whole sum)."""
    if mesh is None or mesh.tp == 1:
        return x
    if not x.requires_grad:
        return all_reduce(x, mesh)
    return _ReduceFromModel.apply(x, mesh)
