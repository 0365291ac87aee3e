"""``correct`` on a small cell on the CPU: true for the program as it is,
false with the timed path broken underneath, once for each fault a
one-card transcription can have (a token altered where it is produced,
half of a slab's rows left out, a decode step that returns its state
unchanged; there is no exchange between cards to leave out), and the
counts of operations and bytes checked by hand for both configurations."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from audio_processor_tpu_torch.models.whisper import decode as port_decode  # noqa: E402
from audio_processor_tpu_torch.models.whisper import model as port_model  # noqa: E402
from portbench import counts, harness  # noqa: E402
from portbench.tests.small import small_cell  # noqa: E402

SEED = 2**32 + 17


def _run(monkeypatch=None, fault=None, cell=small_cell, seconds=0.1):
    if fault is not None:
        fault(monkeypatch)
    return harness.run_cell(ROOT, "small", SEED, seconds, False, t0=0.0, device="cpu",
                            files=cell(ROOT))


def alter_token(mp):
    """One served token of each decode replaced, where it is produced."""
    orig = port_decode.greedy_decode

    def bad(*a, **k):
        r = orig(*a, **k)
        t = r.tokens.clone()
        t[0, 6] = (t[0, 6] + 7919) % 50257
        return r._replace(tokens=t)

    mp.setattr(port_decode, "greedy_decode", bad)


def drop_half_rows(mp):
    """The encoder leaves out the second half of each slab's rows."""
    orig = port_model.encode

    def bad(*a, **k):
        s = orig(*a, **k).clone()
        s[s.shape[0] // 2:] = 0
        return s

    mp.setattr(port_model, "encode", bad)


def stale_step(mp):
    """Every decode step after the prefill returns the prefill's logits:
    its state unchanged."""
    orig = port_decode.decoder_forward_cached
    held = {}

    def bad(params, cfg, tokens, cache, pos, **k):
        logits, cache = orig(params, cfg, tokens, cache, pos, **k)
        if k.get("logit_positions"):  # a decode's prefill
            held["logits"] = logits[:, -1:]
        elif k.get("unembed") is not None:  # one of its steps
            return held["logits"], cache
        return logits, cache

    mp.setattr(port_decode, "decoder_forward_cached", bad)


def test_sound_run_is_correct():
    out = _run()
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("fault", [alter_token, drop_half_rows, stale_step])
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    out = _run(monkeypatch, fault)
    assert out["correct"] is False, out["checks"]


def test_control_in_the_programs_place_is_not_correct():
    """The control (the reference with every product's inputs in float8)
    is judged in the program's place and comes out not correct, reading
    at least three times what the program reads on the same run.  (Its
    reading at the cell's own size is taken on the card:
    ``portbench/control.py``.)"""
    program = _run()
    out = harness.run_cell(ROOT, "small", SEED, 0.1, False, t0=0.0, device="cpu",
                           files=small_cell(ROOT), control=True)
    assert out["correct"] is False, out["checks"]
    gap = out["checks"]["max_logit_gap"]
    assert gap["value"] == out["control"]["control_logit_gap"] > gap["limit"]
    assert gap["value"] >= 3 * program["checks"]["max_logit_gap"]["value"]
    assert out["control"]["control_mean_gap"] > 10 * out["control"]["mean_logit_gap"]


CFGS = {p.stem: json.loads(p.read_text()) for p in (ROOT / "portbench" / "configs").glob("*.json")}


def test_encoder_flops_by_hand():
    # medium: stem 2*3*80*1024*3000 + 2*3*1024*1024*1500 = 10,911,744,000;
    # a layer 3000*(4*1024^2 + 2*1024*4096) + 4*1500^2*1024 = 46,964,736,000
    assert counts.encoder_flops(CFGS["whisper-medium"]) == 10_911_744_000 + 24 * 46_964_736_000
    # turbo: stem 2*3*128*1280*3000 + 2*3*1280^2*1500 = 17,694,720,000;
    # a layer 3000*(4*1280^2 + 2*1280*5120) + 4*1500^2*1280 = 70,502,400,000
    assert counts.encoder_flops(CFGS["whisper-large-v3-turbo"]) == (
        17_694_720_000 + 32 * 70_502_400_000)


def test_decoder_flops_by_hand():
    # medium, a 3-token prompt and one step: cross K/V 24*4*1500*1024^2;
    # three positions of 24*(2*(4+2)*1024^2 + 2*2*1024*4096 + 4*(p+1)*1024
    # + 4*1500*1024); one unembedding 2*51865*1024
    assert counts.decoder_flops(CFGS["whisper-medium"], 3, 1) == (
        150_994_944_000 + 2_556_887_040 + 106_219_520)
    # turbo, the same: cross K/V 4*4*1500*1280^2 = 39,321,600,000; positions
    # 4*(2*(6*1280^2 + 2*1280*5120) + 4*(p+1)*1280 + 4*1500*1280), p = 0..2,
    # = 4*3*(45,875,200 + 7,680,000) + 4*4*1280*(1+2+3) = 642,785,280;
    # unembedding 2*51866*1280 = 132,776,960
    assert counts.decoder_flops(CFGS["whisper-large-v3-turbo"], 3, 1) == (
        39_321_600_000 + 642_785_280 + 132_776_960)


def test_kernel_b_counts_by_hand():
    # medium slab: 48 rows, 16 heads of 64, 1,500 valid positions: K and V
    # nibbles 2*48*16*64*750, q and out 2*4*48*16*64 bytes; 4*48*16*64*1500 FLOPs
    assert counts.kernel_b_call(48, 1, 16, 64) == (73_728_000 + 393_216, 294_912_000)
    # turbo: 20 heads of 64
    assert counts.kernel_b_call(48, 1, 20, 64) == (92_160_000 + 491_520, 368_640_000)
    n_bytes, flops = counts.kernel_b_call(48, 1, 16, 64)
    assert counts.kernel_b_bound_s(n_bytes, flops) == pytest.approx(74_121_216 / 3.35e12)
