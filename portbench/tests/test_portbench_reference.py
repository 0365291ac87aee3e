"""The plain reference against the program at whisper tiny's widths on
the CPU, piece by piece, and the control against the reference.

The program runs here in float32 (its plain PyTorch path), so the two
agree to float32 rounding; on the card the program runs bfloat16 and the
check's limits hold it there."""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from audio_processor_tpu_torch.models.whisper import decode as port_decode  # noqa: E402
from audio_processor_tpu_torch.models.whisper import model as port_model  # noqa: E402
from audio_processor_tpu_torch.ops import frontend as port_frontend  # noqa: E402
from portbench import audio, model  # noqa: E402
from portbench.reference import rules  # noqa: E402
from portbench.reference import transcript as tx  # noqa: E402
from portbench.reference import whisper as ref  # noqa: E402
from portbench.tests.small import small_cell  # noqa: E402
from portbench.tokenizer import WordTokenizer  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tiny():
    f = small_cell(ROOT)
    cfg = f["cfg"]
    params = port_model.map_params(lambda t: t.float(), model.make_params(cfg, 2**35 + 1, CPU))
    mix = dict(f["mix"], meeting_s=64.0)
    return cfg, params, audio.meeting(mix, 2**35 + 2, CPU)


def test_trim_and_time_map_match_the_program(tiny):
    _, _, a = tiny
    want, w_int = port_frontend.trim_silence_host(a)
    got, g_int = tx.trim(a)
    assert np.array_equal(want, got) and w_int == g_int
    paused = a.copy()
    paused[16_000 * 20: 16_000 * 26] = 0.0
    want, w_int = port_frontend.trim_silence_host(paused)
    got, g_int = tx.trim(paused)
    assert len(g_int) == 2 and np.array_equal(want, got) and w_int == g_int


def test_log_mel_matches_the_program(tiny):
    cfg, _, a = tiny
    x = torch.from_numpy(tx.to_i16(a[: 2 * tx.WINDOW].reshape(2, -1)).astype(np.float32) / 32768.0)
    want = port_frontend.log_mel_spectrogram(x, cfg["num_mel_bins"])
    got = ref.log_mel(x, cfg["num_mel_bins"])
    assert (want - got).abs().max().item() < 2e-4


def test_encoder_and_decoder_match_the_program(tiny):
    cfg, params, a = tiny
    wcfg = model.whisper_config(cfg)
    x = torch.from_numpy(tx.to_i16(a[:tx.WINDOW]).astype(np.float32)[None] / 32768.0)
    mel = ref.log_mel(x, cfg["num_mel_bins"])
    prec = ref.Precision("f32")
    states = ref.encode(params, cfg, mel, prec)
    want = port_model.encode(params, wcfg, mel)
    assert (states - want).abs().max().item() < 1e-3 * want.abs().max().item()
    toks = torch.tensor([[50258, 50259, 50359, 50364, 300, 400, 50400]])
    kv = ref.cross_kv(params, cfg, states, prec, int4=False)
    got = ref.decode_logits(params, cfg, toks, kv, prec)
    want = port_model.decode_logits(params, wcfg, toks, states)
    assert (got - want).abs().max().item() < 1e-3


def test_int4_cache_matches_the_program():
    x = torch.randn(2, 1500, 4, 16)
    q, scale = port_decode._quantize_kv(x[None], bits=4)
    want = (q.float() * scale)[0].reshape(2, 1500, 64)
    got = ref.int4_roundtrip(x.reshape(2, 1500, 64))
    assert torch.equal(want, got)


def test_special_tokens_and_suppress_set_match_the_program(tiny):
    cfg, _, _ = tiny
    for vocab in (51865, 51866):
        st = ref.special_tokens(vocab)
        port = port_decode.SpecialTokens.for_config(
            model.whisper_config(dict(cfg, vocab_size=vocab)))
        for k in ("eot", "sot", "lang_begin", "transcribe", "no_speech", "no_timestamps",
                  "timestamp_begin"):
            assert st[k] == getattr(port, k)
        assert st["n_lang"] == port.num_languages
        tok = WordTokenizer(st["eot"])
        mask = port_decode.build_suppress_mask(tok, port)
        assert sorted(np.flatnonzero(mask)) == ref.suppressed_ids(st, tok.encode)


def test_rules_gap_is_zero_for_greedy_choices():
    st = ref.special_tokens(51865)
    g = torch.Generator().manual_seed(4)
    logits = torch.randn(20, 51865, generator=g)
    supp = torch.zeros(51865, dtype=torch.bool)
    served = []
    for i in range(20):
        allowed = rules.allowed_logits(logits[: i + 1], served + [0], st, supp, 32)
        served.append(int(rules.first_choices(allowed[i:i + 1], st)[0]))
    allowed = rules.allowed_logits(logits, served, st, supp, 32)
    assert float(rules.token_gaps(allowed, served, st).max()) == 0.0
    assert served[0] >= st["timestamp_begin"]
    worse = list(served)
    worse[5] = int(allowed[5].argsort()[-40])
    assert float(rules.token_gaps(rules.allowed_logits(logits, worse, st, supp, 32),
                                  worse, st)[5]) > 0.0


def test_control_departs_from_the_reference(tiny):
    cfg, params, a = tiny
    x = torch.from_numpy(tx.to_i16(a[:tx.WINDOW]).astype(np.float32)[None] / 32768.0)
    mel = ref.log_mel(x, cfg["num_mel_bins"])
    f32 = ref.encode(params, cfg, mel, ref.Precision("f32"))
    fp8 = ref.encode(params, cfg, mel, ref.Precision("fp8"))
    rel = ((fp8 - f32).norm() / f32.norm()).item()
    assert 1e-3 < rel < 0.5
