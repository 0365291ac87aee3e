"""Multi-process bring-up on ``torch.distributed``, and the host-aware mesh.

The port of the JAX package's ``parallel/multihost.py``:

  * every rank is one process; ``initialize()`` joins them into one
    process group (the coordinator is rank 0's address);
  * ``make_multihost_mesh()`` lays the (data, model) mesh out so that a
    model group never crosses a host: its collectives run after every
    row-parallel product and belong on NVLink, while the data axis, which
    carries one all-gather of decode results per slab, may span hosts.

Bring-up check, on every host (coordinator first):

    APTPU_COORDINATOR=host0:8476 APTPU_NUM_PROCESSES=2 APTPU_PROCESS_ID=0 \\
        python -m audio_processor_tpu_torch.parallel.multihost --check

or under ``torchrun``, whose ``RANK``/``WORLD_SIZE``/``MASTER_ADDR`` are read
when no ``APTPU_*`` topology is given:

    torchrun --nproc-per-node 2 -m audio_processor_tpu_torch.parallel.multihost --check

Env (APTPU_* all or none):
    APTPU_COORDINATOR     rank 0's host:port
    APTPU_NUM_PROCESSES   world size
    APTPU_PROCESS_ID      this process's rank
    LOCAL_RANK            this process's card on its host (torchrun sets it)
    LOCAL_WORLD_SIZE      processes on this host (torchrun sets it)
    APTPU_DIST_TIMEOUT_S  how long a collective waits for the other ranks
                          before it fails (default 600): a rank that died
                          ends the world instead of hanging it
"""
from __future__ import annotations

import datetime
import logging
import os

import torch
import torch.distributed as dist

from . import mesh as mesh_lib

logger = logging.getLogger(__name__)

_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device: str | None = None,
    backend: str | None = None,
) -> bool:
    """Join the process group.  Returns True when distributed.

    Arguments fall back to the APTPU_* env vars, then to torchrun's env
    (the counterpart of ``jax.distributed.initialize()`` with no arguments).
    With none of them this is a no-op returning False.  Safe to call twice.
    The backend is NCCL on the card and gloo with ``device="cpu"`` or no
    card, unless ``backend`` names one (gloo lets several ranks share a
    card, which NCCL refuses).  On the card this rank's card is
    ``LOCAL_RANK``, else the rank modulo the cards (``set_device``), so a
    bare "cuda" names it from then on.  A collective fails after
    ``APTPU_DIST_TIMEOUT_S`` seconds.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator = coordinator or os.environ.get("APTPU_COORDINATOR")
    num_str = os.environ.get("APTPU_NUM_PROCESSES")
    if num_processes is None and num_str:
        num_processes = int(num_str)
    pid_str = os.environ.get("APTPU_PROCESS_ID")
    if process_id is None and pid_str:
        process_id = int(pid_str)

    if coordinator is None and num_processes is None:
        if not all(v in os.environ for v in _TORCHRUN_VARS):
            logger.info("no multi-process environment detected: single-process serving")
            return False
        init_method = "env://"
        num_processes, process_id = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        # an explicit topology must be complete: a lone APTPU_COORDINATOR
        # would otherwise fail later with an opaque error
        missing = [
            name for name, val in (
                ("APTPU_COORDINATOR", coordinator),
                ("APTPU_NUM_PROCESSES", num_processes),
                ("APTPU_PROCESS_ID", process_id),
            ) if val is None
        ]
        if missing:
            raise ValueError(
                "explicit multihost topology is incomplete: set "
                + ", ".join(missing)
                + " (or unset APTPU_COORDINATOR/APTPU_NUM_PROCESSES entirely "
                "for torchrun's environment)"
            )
        init_method = f"tcp://{coordinator}"
    on_card = device != "cpu" and torch.cuda.is_available()
    if on_card:
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local else process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend or ("nccl" if on_card else "gloo"), init_method=init_method,
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=float(os.environ.get("APTPU_DIST_TIMEOUT_S", "600"))),
    )
    logger.info("torch.distributed up: rank %d/%d (%s)", process_id, num_processes,
                dist.get_backend())
    return True


def shutdown() -> None:
    """Leave the process group (a no-op when single-process)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_multihost_mesh(model_parallel: int = 1, device=None) -> mesh_lib.Mesh:
    """(data, model) mesh over every rank, with each model group on one
    host: model_parallel must divide the processes of a host
    (``LOCAL_WORLD_SIZE``, or the whole world when it is unset).  Ranks are
    numbered host by host (torchrun's rule), so tp consecutive ranks share
    a host."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if model_parallel > n_local or n_local % model_parallel:
        raise ValueError(
            f"model_parallel={model_parallel} must divide the {n_local} processes "
            "of a host: tensor-parallel groups must stay on one host"
        )
    return mesh_lib.make_mesh(model_parallel, device=device)


def check(device: str | None = None) -> dict:
    """Every rank's one, summed over the model axis and gathered over the
    data axis, must count the world.  Returns a summary (also logged)."""
    distributed = initialize(device=device)
    mesh = make_multihost_mesh(device=device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    ones = torch.ones(1, device=mesh.device)
    got = float(mesh_lib.all_gather(mesh_lib.all_reduce(ones, mesh), mesh).sum())
    summary = {
        "distributed": distributed,
        "rank": dist.get_rank() if dist.is_initialized() else 0,
        "world_size": world,
        "backend": dist.get_backend() if dist.is_initialized() else None,
        "device": str(mesh.device),
        "mesh": mesh.shape,
        "sum_expected": float(world),
        "sum_got": got,
        "ok": got == float(world),
    }
    logger.info("multihost check: %s", summary)
    if not summary["ok"]:
        raise RuntimeError(f"collective saw {got} ranks, expected {world}")
    return summary


if __name__ == "__main__":
    import argparse
    import json

    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--check", action="store_true", help="run the bring-up check")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu (gloo)")
    args = ap.parse_args()
    if args.check:
        print(json.dumps(check(args.device)))
        shutdown()
