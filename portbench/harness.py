"""One run of one cell, driven by the data files.

The cell's configuration, traffic mix, metrics and limits are found by
their names in ``BENCHMARK.json``; the traffic mix names its driver.  A
driver module has a ``Run(cfg, mix, seed, device, sync)`` whose set-up
ends before the first timed item, with ``window(seconds)``, ``work()``,
``traced_item()`` and ``check(control)``.  A metric module has
``value(ctx)``, which returns a number, or None where it finds nothing to
read.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from . import counts
from . import trace as trace_lib


class NoCard(RuntimeError):
    pass


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def cell_files(root: Path, workload: str) -> dict:
    """Everything the cell names, by name."""
    bench = load_json(root / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"portbench: no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = load_json(root / conf["file"])
    mix = load_json(root / "portbench" / "traffic" / f"{cell['traffic']}.json")

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return {"cell": cell, "cfg": cfg, "mix": mix,
            "end_to_end": mine(bench["end_to_end"]), "per_layer": mine(bench["per_layer"]),
            "limits": load_json(root / "portbench" / "limits" / f"{workload}.json")}


def metric_reader(root: Path, name: str):
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.value


def driver(mix: dict):
    return importlib.import_module(f"portbench.drivers.{mix['driver']}")


def device_for(cell: dict, device):
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device is available: the benchmark measures the card")
    if torch.cuda.device_count() < cell["chips"]:
        raise NoCard(f"the cell needs {cell['chips']} cards, {torch.cuda.device_count()} found")
    return torch.device("cuda", 0)


def breakdown(tr: dict) -> dict:
    ops = sorted(tr["kernels"].items(), key=lambda kv: -kv[1][0])[:10]
    gaps = sorted(tr["idle_by_host_op"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v[0]] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


def run_cell(root: Path, workload: str, seed: int, seconds: float, traced: bool, *,
             t0: float, device=None, control: bool = False, files: dict | None = None) -> dict:
    """``files``: the cell's files as ``cell_files`` returns them (tests
    pass a small cell of their own)."""
    f = files or cell_files(root, workload)
    dev = device_for(f["cell"], device)
    on_card = dev.type == "cuda"
    run = driver(f["mix"]).Run(f["cfg"], f["mix"], seed, dev, sync=traced and on_card)
    setup_s = time.perf_counter() - t0
    run.window(seconds)
    ctx = {"cfg": f["cfg"], "mix": f["mix"], "setup_s": setup_s, "work": run.work(),
           "run": run, "trace": None, "kernel_b_calls": []}
    if traced and on_card:
        from audio_processor_tpu_torch.models.whisper import decode as decode_lib

        with trace_lib.record_calls(decode_lib, "cross_attention_int4_stacked") as calls:
            ctx["trace"] = trace_lib.profile(run.traced_item)
        with_host = trace_lib.profile(run.traced_item, host=True)
        ctx["trace"]["idle_by_host_op"] = with_host["idle_by_host_op"]
        print(f"portbench: traced item wall {ctx['trace']['window_s']:.3f} s (card only), "
              f"{with_host['window_s']:.3f} s (host ops too); the window's items "
              f"{ctx['work']['items_s'] / max(len(run.items), 1):.3f} s on average",
              file=sys.stderr)
        ctx["kernel_b_calls"] = [counts.kernel_b_call(q.shape[0], q.shape[1], q.shape[2],
                                                      q.shape[3], kw["valid_len"])
                                 for (q, *_), kw in calls]
    dev_info = {"platform": "gpu" if on_card else dev.type,
                "kind": torch.cuda.get_device_name(dev) if on_card else dev.type, "count": 1,
                "memory_peak_bytes": torch.cuda.max_memory_allocated(dev) if on_card else 0}
    if ctx["trace"] is not None:
        dev_info.update(busy_s=ctx["trace"]["busy_s"], window_s=ctx["trace"]["window_s"])
    metrics = {}
    for m in (f["per_layer"] if traced else f["end_to_end"]):
        v = metric_reader(root, m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if on_card:
        torch.cuda.empty_cache()
    readings = run.check(control=control)
    nums = readings
    if control:  # the control's reading judged in the program's place
        nums = dict(readings, max_logit_gap=readings["control_logit_gap"])
    limits = f["limits"]
    correct = all(name in nums and nums[name] <= lim for name, lim in limits.items())
    out = {"correct": bool(correct and run.items), "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": dev_info}
    if ctx["trace"] is not None:
        out["breakdown"] = breakdown(ctx["trace"])
    if control:
        out["control"] = readings
    out["checks"] = {name: {"value": nums.get(name), "limit": lim} for name, lim in limits.items()}
    return out
