"""The per-layer metrics that read the program's own spans, on a small cell
on the CPU: each reads a number in a ``--trace 1`` run, the decode steps
the program counts are the steps the probe counts, and each reads None
where nothing ran or where the program keeps no trace."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402
from portbench.tests.small import small_cell  # noqa: E402

SEED = 2**33 + 41
UNITS = {"decode.issue_ms_per_step": "ms", "decode.wait_ms_per_step": "ms",
         "encode.issue_ms_per_window": "ms", "transcriber.self_ms_per_window": "ms",
         "decode.rows_per_window": "rows/window"}
NAMES = tuple(UNITS)


@pytest.fixture(scope="module")
def run():
    f = small_cell(ROOT)
    r = harness.driver(f["mix"]).Run(f["cfg"], f["mix"], SEED, torch.device("cpu"), sync=False)
    r.window(0.1)
    return r


def test_each_reads_a_number_in_a_traced_run():
    out = harness.run_cell(ROOT, "small", SEED, 0.1, True, t0=0.0, device="cpu",
                           files=small_cell(ROOT))
    assert out["correct"] is True
    for name in NAMES:
        m = out["metrics"][name]
        assert m["unit"] == UNITS[name] and m["value"] >= 0, name
    assert out["metrics"]["decode.issue_ms_per_step"]["value"] > 0
    assert out["metrics"]["decode.rows_per_window"]["value"] >= 1


def test_program_steps_equal_the_probes(run):
    work = run.work()
    trs = [it["result"]["trace"] for it in run.items]
    assert trs and work["decode_steps"] > 0
    assert sum(t["counters"]["decode.steps"] for t in trs) == work["decode_steps"]
    assert sum(t["counters"]["transcribe.windows"] for t in trs) == work["windows"]
    ctx = {"run": run, "work": work}
    issue = harness.metric_reader(ROOT, "decode.issue_ms_per_step")(ctx)
    wait = harness.metric_reader(ROOT, "decode.wait_ms_per_step")(ctx)
    step_s = sum(t["spans"]["decode.step"]["total_s"] for t in trs)
    assert issue + wait == pytest.approx(1e3 * step_s / work["decode_steps"])
    rows = harness.metric_reader(ROOT, "decode.rows_per_window")(ctx)
    assert rows == sum(t["counters"]["decode.rows"] for t in trs) / work["windows"] >= 1


def test_none_where_nothing_ran_or_no_trace(run):
    class Empty:
        items: list = []

    class Untraced:  # the program as it was before it kept a trace
        items = [dict(it, result={k: v for k, v in it["result"].items() if k != "trace"})
                 for it in run.items]

    for name in NAMES:
        read = harness.metric_reader(ROOT, name)
        assert read({}) is None, name
        assert read({"run": Empty()}) is None, name
        assert read({"run": Untraced()}) is None, name
        assert read({"run": run}) is not None, name
