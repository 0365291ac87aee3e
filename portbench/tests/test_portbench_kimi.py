"""The Kimi-Linear cell's driver on the CPU at a tiny size: the files it is
found by, a short window through the program's ``LocalLLMClient`` and
``Engine``, the reference's judgement, the counts the metrics read."""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness, kimi_counts, kimi_model  # noqa: E402

CELL = "kimilinear.allday_backlog4"
TINY = dict(hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
            num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, vocab_size=512,
            num_experts=4, experts_published=8, experts_held=[0, 4], num_experts_per_token=2,
            linear_attn_config=dict(full_attn_layers=[3], kda_layers=[1, 2, 4], head_dim=16,
                                    num_heads=2, short_conv_kernel_size=4))


def small_cell() -> dict:
    f = harness.cell_files(ROOT, CELL)
    f["cfg"] = dict(f["cfg"], **TINY, run=dict(f["cfg"]["run"], dtype="float32",
                                               bos_token_id=500, eos_token_id=501,
                                               speaker_tokens=3, summary_tokens=5,
                                               notes_tokens=7))
    f["mix"] = dict(f["mix"], minutes=[1, 2], meetings=2, pool=1)
    # float32 on both sides: the program's gaps read ~1e-5 at these widths
    f["limits"] = dict(f["limits"], max_logit_gap=1e-3)
    assert f["limits"]["wide_gap_share"] == 0.15
    return f


def test_the_cell_is_found_by_name_and_holds_the_published_widths():
    f = harness.cell_files(ROOT, CELL)
    cfg = f["cfg"]
    assert harness.driver(f["mix"]).Run and set(f["limits"]) == {"wide_gap_share"}
    assert (cfg["hidden_size"], cfg["moe_intermediate_size"], cfg["num_experts"],
            cfg["experts_published"], cfg["num_hidden_layers"], cfg["vocab_size"]) == (
        2304, 1024, 128, 256, 27, 163840)
    assert {m["name"] for m in f["per_layer"]} >= {"kda.prefill_roofline",
                                                   "kda.decode_roofline", "kimi.decode_roofline"}
    assert round(kimi_counts.held_picks(cfg), 3) == 4.0
    held = sum(s[0] * s[1] if len(s) == 2 else s[0] for _, s, _, _ in
               kimi_model.published_spec(cfg) if len(s) <= 2)
    assert round(2 * held / 1e9, 1) == 51.1  # bf16 bytes of this card's share


def test_a_short_window_on_the_cpu_is_correct_and_counted():
    t0 = time.perf_counter()
    out = harness.run_cell(ROOT, CELL, 3_000_000_026, 0.5, False, t0=t0, device="cpu",
                           files=small_cell())
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert out["checks"]["max_logit_gap"]["value"] <= 1e-3
    assert out["checks"]["wide_gap_share"]["value"] == 0.0
    json.dumps(out)


def test_the_control_is_read_in_the_programs_place_one_recording_a_seed():
    """``kimi_control``'s seed: one recording served alone, then judged
    with the control: the plain readings are the float8 control's (so the
    harness's ``correct`` is the control's), the program's stay behind
    ``program_``, each token's gap on both sides."""
    import torch

    from portbench import kimi_control

    out = kimi_control.one_seed(small_cell(), 3_000_000_027, torch.device("cpu"))
    n = out["generated_tokens"]
    assert n == len(out["gaps"]) == len(out["program_gaps"]) > 0
    assert out["correct"] and out["program_max_logit_gap"] <= 1e-3
    assert out["control_logit_gap"] == out["max_logit_gap"] == max(out["gaps"])
    assert abs(out["mean_logit_gap"] - sum(out["gaps"]) / n) < 1e-6
    assert set(out["prompt_tokens"]) == {"speakers", "summary", "notes"}
