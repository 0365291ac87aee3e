"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``portbench/configs/<name>.json``) and a traffic mix
(``portbench/traffic/<mix>.json``), whose ``driver`` names the code that
sets the program up and offers the load (``portbench/drivers/``).  Each
metric is read by ``portbench/metrics/<metric>.py``, each cell's
correctness limits are ``portbench/limits/<cell>.json``.  With
``--trace 0`` the run prints the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, from spans that end in a device sync
and one more item under the profiler.  The last line of standard output
is one JSON object.  The run needs the card: without one it exits 2 and
prints no result.
"""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _process_age_s() -> float | None:
    """Seconds since this process started, from /proc."""
    try:
        start_ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


_AGE0 = _process_age_s()
_T0 = time.perf_counter() - (_AGE0 or 0.0)

if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "audio_processor_tpu")


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


def main(argv=None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from portbench import harness

    cache = ROOT / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    try:
        out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                               t0=_T0)
    except harness.NoCard as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    bad = forbidden_loaded()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
