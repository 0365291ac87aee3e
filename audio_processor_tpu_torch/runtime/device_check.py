"""Fail-fast liveness probe of the card.

A card that stopped answering (a wedged context, a lost device) blocks
the first device operation forever: the first symptom would be a server
that hangs in model init with no log line and no exit code.
``probe_device()`` runs one scalar add on the device and reads it back,
inside a watchdog thread, and turns that hang into a bounded startup
error.  ``build_services`` calls it once, before any parameter is made on
the device.

The port of the JAX package's ``runtime/device_check.py``: the same
deadline (``APTPU_DEVICE_INIT_TIMEOUT_S``) and error, on a CUDA device.
"""
from __future__ import annotations

import logging
import os
import threading

import torch

from .device import resolve_device

logger = logging.getLogger(__name__)

# 0 or a negative value disables the watchdog
DEFAULT_TIMEOUT_S = 300.0


class DeviceUnresponsiveError(RuntimeError):
    """The device did not answer a trivial operation in time."""


def _default_probe(device=None) -> str:
    """One scalar add on ``device`` (None: the card), read back by
    ``.item()``; returns "gpu" or "cpu".  Raises RuntimeError when there is
    no card and the CPU was not asked for."""
    dev = resolve_device(device)
    (torch.ones((), device=dev) + 1).item()
    return "gpu" if dev.type == "cuda" else dev.type


def probe_device(timeout_s: float | None = None, _probe=None, device=None) -> str:
    """Run one trivial op on ``device`` under a deadline.

    Returns the platform name ("gpu", or "cpu" when the CPU was asked
    for).  Raises DeviceUnresponsiveError if the op does not complete
    within ``timeout_s`` (default APTPU_DEVICE_INIT_TIMEOUT_S, else 300 s;
    0 or negative disables the watchdog), and RuntimeError when there is
    no card and ``device`` is not the CPU.

    The hung thread cannot be cancelled: it is left as a daemon and the
    caller is expected to treat the error as fatal.
    """
    if timeout_s is None:
        timeout_s = float(os.environ.get("APTPU_DEVICE_INIT_TIMEOUT_S", DEFAULT_TIMEOUT_S))
    probe = _probe or (lambda: _default_probe(device))
    if timeout_s <= 0:
        return probe()

    result: dict = {}

    def run():
        try:
            result["platform"] = probe()
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            result["error"] = exc

    t = threading.Thread(target=run, name="aptpu-device-probe", daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise DeviceUnresponsiveError(
            f"the device did not answer a trivial op within {timeout_s:.0f} s — "
            "check the card (nvidia-smi), deploy on the CPU with APTPU_DEVICE=cpu, "
            "or raise/disable this check with APTPU_DEVICE_INIT_TIMEOUT_S."
        )
    if "error" in result:
        raise result["error"]
    platform = result.get("platform", "unknown")
    logger.info("device probe ok: platform=%s", platform)
    return platform
