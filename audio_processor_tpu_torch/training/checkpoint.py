"""Training checkpoint and resume: a train state as one ``.npz``.

The JAX package saves its train state with orbax, falling back to an
``.npz`` keyed by a JAX treedef string; neither exists here, so this is
the port's own format, and it does not read the JAX package's files.

Every field of a train state (``TrainState``, ``SegTrainState``,
``EmbTrainState``) is stored by its leaves in ``train_step.tree_leaves``
order: ``<field>.<i>`` for the parameters (and the embedding head), both
Adam moments as ``opt_state.mu.<i>`` / ``opt_state.nu.<i>``, the Adam count
as ``opt_state.count`` and ``step``.  bf16 leaves are widened to float32.
The file is written beside its target and moved into place
(``os.replace``), so a crash never leaves half a checkpoint.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from .train_step import AdamState, tree_leaves


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def save_train_state(path: str, state: Any) -> None:
    """Write ``state`` atomically to ``path`` (``.npz`` added if missing)."""
    flat: dict[str, np.ndarray] = {}
    for field, value in zip(state._fields, state):
        if isinstance(value, AdamState):
            flat["opt_state.count"] = np.asarray(value.count, np.int64)
            for name in ("mu", "nu"):
                for i, t in enumerate(getattr(value, name)):
                    flat[f"opt_state.{name}.{i}"] = _array(t)
        elif field == "step":
            flat["step"] = np.asarray(int(value), np.int64)
        else:
            for i, t in enumerate(tree_leaves(value)):
                flat[f"{field}.{i}"] = _array(t)
    target = _npz_path(path)
    tmp = target + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, target)


def restore_train_state(path: str, template: Any) -> Any:
    """The state saved at ``path``, in ``template``'s structure: its tensors
    are overwritten in place (each keeps its dtype and device) and the
    counts replaced."""
    with np.load(_npz_path(path)) as z:
        data = {k: z[k] for k in z.files}

    def fill(tensors: list[torch.Tensor], prefix: str) -> None:
        n = sum(1 for k in data if k.rsplit(".", 1)[0] == prefix)
        if n != len(tensors):
            raise ValueError(f"{path}: {prefix} holds {n} leaves, the template {len(tensors)}")
        with torch.no_grad():
            for i, t in enumerate(tensors):
                src = torch.from_numpy(data[f"{prefix}.{i}"])
                if src.shape != t.shape:
                    raise ValueError(f"{path}: {prefix}.{i} is {tuple(src.shape)}, "
                                     f"the template {tuple(t.shape)}")
                t.copy_(src)

    values = []
    for field, value in zip(template._fields, template):
        if isinstance(value, AdamState):
            fill(value.mu, "opt_state.mu")
            fill(value.nu, "opt_state.nu")
            value = AdamState(int(data["opt_state.count"]), value.mu, value.nu)
        elif field == "step":
            value = int(data["step"])
        else:
            fill(tree_leaves(value), field)
        values.append(value)
    return type(template)(*values)
