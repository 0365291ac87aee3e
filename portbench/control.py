"""The control of ``correct``, and the program's own readings, on seeds
of one cell, in one process.

    python3 portbench/control.py --workload <cell> --seconds <s> --seeds <n> ...

For each seed the cell runs as the benchmark runs it (a short window),
and the reference judges the sampled transcript twice: the program's
served tokens (the numbers ``correct`` compares) and, at each position,
the token that the reference run at float8 (``reference.whisper
.Precision("fp8")``, one step below the configuration's bfloat16) puts
first (``control_logit_gap``).  ``correct`` is the control's: its gap
judged against the cell's limit in the program's place, so a control
that separates reads false.  One JSON line a seed.  The benchmark's own
runs never run this.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    import argparse

    from portbench import harness

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = harness.run_cell(ROOT, args.workload, seed, args.seconds, False, t0=t0,
                               control=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": out["correct"],
                          "seconds": time.perf_counter() - t0, **out["control"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
