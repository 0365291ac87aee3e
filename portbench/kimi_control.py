"""The Kimi-Linear cell's ``correct`` and its float8 control on many seeds,
at a third of ``control.py``'s cost.

    python3 portbench/kimi_control.py --seeds <n> [<n> ...] [--gaps <file.jsonl>] [--until <t>]

``control.py`` runs the whole cell for each seed: the set-up's two
batches, a window of at least one batch of four recordings, then the
check.  The check judges one recording, so here each seed draws the
cell's weights, draws the window's first batch and, from the seed as the
check draws it, one recording of it, and serves that recording alone
through the job's stages 5-7 (``MeetingProcessor.write_up`` over the
program's ``LocalLLMClient``: its speaker task, then its summary and notes
forked from one prefilled transcript).  ``kimi_check.judge`` then reads
the program's rows and the float8 control's, and each side's ``correct``
is its readings against the cell's limits.  One JSON line a seed on
standard output; with ``--gaps``, every token's gap on both sides, one
line a seed, in that file; with ``--until`` (seconds since the epoch), no
seed starts after that time.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELL = "kimilinear.allday_backlog4"


def one_seed(files: dict, seed: int, device) -> dict:
    import numpy as np
    import torch
    from audio_processor_tpu_torch.pipeline.meeting import MeetingProcessor
    from audio_processor_tpu_torch.runtime.job_engine import JobContext, JobEngine

    from portbench import kimi_check, kimi_model
    from portbench.drivers import notes_loop

    t0 = time.perf_counter()
    cfg, mix = files["cfg"], files["mix"]
    client, weights = kimi_model.client(cfg, seed, device)
    meetings = notes_loop.batch(mix, notes_loop.item_seed(seed, 0))
    rng = np.random.default_rng(notes_loop.item_seed(seed, -3))
    m = meetings[int(rng.integers(len(meetings)))]
    engine = client.engine
    generate, calls = engine.generate, []

    def logged(groups, caps):
        outs = generate(groups, caps)
        calls.append((groups, outs))
        return outs

    engine.generate = logged
    jobs = JobEngine(max_workers=1)
    jobs.create_job(f"seed{seed}")
    ctx = JobContext(jobs, f"seed{seed}")
    t1 = time.perf_counter()
    try:
        MeetingProcessor(transcriber=None, gemini=client).write_up(ctx, [m])
    finally:
        ctx.end_stage()
    (gens,) = notes_loop.rows(calls)
    t2 = time.perf_counter()
    del engine.generate  # the logger holds the engine: let it go with the seed
    engine._sessions.clear()
    engine._buffers.clear()
    torch.cuda.empty_cache()
    r = kimi_check.judge(weights, cfg, gens, device, control=True, gaps=True)
    lim = files["limits"]
    prog = {k: r[f"program_{k}"] for k in lim}
    return {"seed": seed, "minutes": m["duration_s"] / 60,
            "prompt_tokens": {t: len(p) for t, (p, _) in gens.items()},
            "correct": all(prog[k] <= v for k, v in lim.items()),
            "control_correct": all(r[k] <= v for k, v in lim.items()),
            "setup_s": t1 - t0, "serve_s": t2 - t1, **r}


def main(argv=None) -> int:
    import argparse
    import os

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--gaps", type=Path)
    p.add_argument("--until", type=float, default=float("inf"))
    args = p.parse_args(argv)
    cache = ROOT / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("kimi_control: needs the card", file=sys.stderr)
        return 2
    files = harness.cell_files(ROOT, CELL)
    for seed in args.seeds:
        if time.time() >= args.until:
            break
        out = one_seed(files, seed, torch.device("cuda"))
        gaps = {k: out.pop(k) for k in ("gaps", "program_gaps")}
        print(json.dumps(out), flush=True)
        if args.gaps:
            with args.gaps.open("a") as f:
                f.write(json.dumps({"seed": seed, **gaps}) + "\n")
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
