"""Time the bundled diarizer's build stage by stage.

Runs ``tools/make_bundled_diarizer.main`` with the arguments it is given
(at the tool's defaults: 3,000 segmentation and 2,400 embedding steps,
the three calibration sweeps, the held-out gates, and the save into
``--out-dir`` when they pass), times each stage (the two trainers, the
three sweeps, ``validate``) and counts kernel A's launches in each, then
prints one JSON line: the card's name and power limit, the stage walls
and launches, the peak device memory and the outcome (``saved``, or the
gates' failure message).  Exit status 1 when a gate failed.

    python -m audio_processor_tpu_torch.benchmarks.bundled_build --out-dir built/ \\
        [--json build.json] [any make_bundled_diarizer flag]
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import time

import torch

from ..ops.kernels.log_mel import log_mel
from ..tools import make_bundled_diarizer as tool

STAGES = ("train_segmentation", "train_embedding", "calibrate_threshold", "calibrate_binarize",
          "calibrate_mcf", "validate")


def _card() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    if shutil.which("nvidia-smi") is None:
        return "no nvidia-smi"
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True)
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 else "no nvidia-smi"


def timed_build(tool_argv: list[str]) -> dict:
    """The tool's ``main(tool_argv)`` with each stage timed; the record."""
    walls, launches = {}, {}
    originals = {name: getattr(tool, name) for name in STAGES}

    def timed(name, fn):
        def run(*args, **kw):
            log_mel.launches = 0
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                walls[name] = time.perf_counter() - t0
                launches[name] = log_mel.launches
                print(f"stage {name}: {walls[name]:.1f} s, kernel A {launches[name]}", flush=True)
        return run

    record = {"card": _card(), "argv": tool_argv}
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        for name, fn in originals.items():
            setattr(tool, name, timed(name, fn))
        tool.main(tool_argv)
        record["outcome"] = "saved"
    except SystemExit as e:
        if not isinstance(e.code, str):
            raise  # argparse's exits; a failed gate's carries its message
        record["outcome"] = e.code
    finally:
        for name, fn in originals.items():
            setattr(tool, name, fn)
    record.update(walls_s=walls, log_mel_launches=launches, total_s=time.perf_counter() - t0,
                  peak_gb=torch.cuda.max_memory_allocated() / 1e9 if torch.cuda.is_available()
                  else None)
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the record to this file")
    args, tool_argv = ap.parse_known_args(argv)
    record = timed_build(tool_argv)
    print(json.dumps(record), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1)
    return 0 if record["outcome"] == "saved" else 1


if __name__ == "__main__":
    raise SystemExit(main())
