"""The harness on the CPU: the files it finds by name, the seeded
generators, the result's schema, the refusal without a card, and the
import rules of the benchmark's sources."""
from __future__ import annotations

import ast
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import audio, harness, run  # noqa: E402
from portbench.tests.small import small_cell  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
READERS = sorted(p.stem for p in (ROOT / "portbench" / "metrics").glob("*.py"))
JAX_NAMES = {"jax", "jaxlib", "flax", "audio_processor_tpu"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    f = harness.cell_files(ROOT, cell)
    assert f["cfg"]["name"] == f["cell"]["config"]
    assert harness.driver(f["mix"]).Run
    assert set(f["limits"]) == {"max_logit_gap", "windows_mismatched", "segments_mismatched"}
    names = {m["name"] for m in f["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2 and f["per_layer"]


def test_every_metric_has_a_reader():
    assert set(METRICS) <= set(READERS)


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_where_nothing_ran(name):
    value = harness.metric_reader(ROOT, name)
    ctx = {"work": {"windows": 0, "decode_steps": 0, "wall_s": 0.0, "flops": 0},
           "trace": None, "kernel_b_calls": [], "setup_s": 1.0}
    assert value(ctx) is None or name == "setup_s"


def test_config_files_hold_the_published_widths():
    for conf in BENCH["configs"]:
        cfg = json.loads((ROOT / conf["file"]).read_text())
        assert cfg["name"] == conf["name"] and cfg["reduced"] == conf["reduced"] == []
    medium = json.loads((ROOT / "portbench/configs/whisper-medium.json").read_text())
    assert (medium["d_model"], medium["encoder_layers"], medium["decoder_layers"],
            medium["encoder_attention_heads"], medium["num_mel_bins"],
            medium["vocab_size"]) == (1024, 24, 24, 16, 80, 51865)
    turbo = json.loads((ROOT / "portbench/configs/whisper-large-v3-turbo.json").read_text())
    assert (turbo["d_model"], turbo["encoder_layers"], turbo["decoder_layers"],
            turbo["encoder_attention_heads"], turbo["num_mel_bins"],
            turbo["vocab_size"]) == (1280, 32, 4, 20, 128, 51866)


def test_meetings_repeat_by_seed():
    mix = dict(json.loads((ROOT / "portbench/traffic/meeting_30min.json").read_text()),
               meeting_s=12.0)
    a = audio.meeting(mix, 2**40 + 7, torch.device("cpu"))
    b = audio.meeting(mix, 2**40 + 7, torch.device("cpu"))
    c = audio.meeting(mix, 2**40 + 8, torch.device("cpu"))
    assert a.dtype == np.float32 and len(a) == 12 * 16_000
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    plan = audio.meeting_plan(np.random.default_rng(3), dict(mix, meeting_s=1800.0))
    turns = np.array([(s, e) for s, e, *_ in plan["turns"]])
    assert np.all((turns[:, 1] - turns[:, 0] >= 1.2 - 1e-9) & (turns[:, 1] - turns[:, 0] <= 2.0))
    gaps = turns[1:, 0] - turns[:-1, 1]
    assert gaps.min() >= 0.3 - 1e-9 and gaps.max() <= 0.6 + 1e-9


def test_result_schema_on_a_small_cell():
    out = harness.run_cell(ROOT, "small", 2**33 + 5, 0.1, False, t0=0.0, device="cpu",
                           files=small_cell(ROOT))
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["attempted"] >= 1 and out["failed"] == 0
    assert {"audio_rtfx", "setup_s"} <= set(out["metrics"])
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def test_no_card_exits_without_a_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", str(2**31 + 11), "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "no CUDA device" in out.err


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "portbench").rglob("*.py"))
    assert files
    for f in files:
        assert not (_imports(f) & JAX_NAMES), f
    for f in sorted((ROOT / "portbench" / "reference").rglob("*.py")):
        assert "audio_processor_tpu_torch" not in _imports(f), f


def test_forbidden_loaded_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "audio_processor_tpu_torch_fake", object())
    assert "audio_processor_tpu" not in run.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "audio_processor_tpu", object())
    assert run.forbidden_loaded() == ["audio_processor_tpu"]
