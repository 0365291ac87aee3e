"""The Transcriber's slab plan and its cap on the card, on the CPU.

``slab_plan`` is held to the rule it replaces (``min(_bucket(n), cap)``
rows a slab, every slab that size); the cap on a card is computed with the
card's properties monkeypatched and turbo's weights as one meta tensor;
and a recording cut into several slabs transcribes as in one.
"""
import copy
import types

import numpy as np
import pytest
import torch

from audio_processor_tpu_torch.integrations.local_llm import LocalLLMClient
from audio_processor_tpu_torch.models.whisper import decode as decode_lib
from audio_processor_tpu_torch.models.whisper.config import get_config
from audio_processor_tpu_torch.pipeline import transcribe
from audio_processor_tpu_torch.pipeline.transcribe import (
    Transcriber, _bucket, card_slab_cap, detect_bytes, row_bytes, slab_plan, slab_rows,
)
from audio_processor_tpu_torch.runtime.device import set_full_fp32
from audio_processor_tpu_torch.runtime.services import size_slabs

set_full_fp32()

# parameters of model.init_params
PARAMS = {"large-v3-turbo": 808_878_080, "medium": 763_857_920, "large-v3": 1_543_490_560}
GB = 10**9
SHAPES = {1, 2, 4} | {8 * i for i in range(1, 17)}


def _power_of_two_rule(n: int, cap: int) -> tuple[int, int]:
    """(slabs, rows) of the rule the plan replaces."""
    rows = min(_bucket(n), cap)
    k = -(-n // rows)
    return k, k * rows


@pytest.mark.parametrize("cap", [48, 128])
def test_plan_never_exceeds_the_power_of_two_rule(cap):
    for n in range(1, 513):
        plan = slab_plan(n, cap)
        k, rows = _power_of_two_rule(n, cap)
        assert len(plan) <= k and sum(r for _, _, r in plan) <= rows, n
        lo_next = 0
        for lo, real, r in plan:
            assert lo == lo_next and 1 <= real <= r <= cap and r in SHAPES, (n, plan)
            lo_next = lo + real
        assert lo_next == n
        # every slab but the last is all windows
        assert all(real == r for _, real, r in plan[:-1])


@pytest.mark.parametrize("multiple", [2, 4])
def test_plan_rows_divide_over_the_data_axis(multiple):
    for cap in (9, 25, 48, 128):
        for n in range(1, 300):
            plan = slab_plan(n, cap, multiple)
            k, rows = len(plan), sum(r for _, _, r in plan)
            s = -(-min(_bucket(n), cap) // multiple) * multiple
            assert k <= -(-n // s) and rows <= -(-n // s) * s, (cap, n)
            assert all(r % multiple == 0 for _, _, r in plan)


@pytest.mark.parametrize("n,plan", [
    (57, [(0, 57, 64)]), (58, [(0, 58, 64)]), (59, [(0, 59, 64)]), (60, [(0, 60, 64)]),
    (65, [(0, 65, 72)]), (129, [(0, 72, 72), (72, 57, 64)]),
    (240, [(0, 120, 120), (120, 120, 120)]),
])
def test_plan_of_long_recordings_at_the_card_cap(n, plan):
    assert slab_plan(n, 128) == plan


def test_slab_rows_below_and_from_eight():
    assert [slab_rows(n) for n in range(1, 10)] == [1, 2, 4, 4, 8, 8, 8, 8, 16]
    assert [slab_rows(n) for n in (17, 24, 25, 60, 128)] == [24, 24, 32, 64, 128]


def test_row_bytes_at_turbos_widths():
    """17.9 MB kept and 42.2 MB passing a row at bf16 with the int4 cross
    cache (the docstring's sums); an unquantized cross cache or float32
    compute costs more, an int8 self cache less."""
    cfg = get_config("large-v3-turbo")
    kept, passing = row_bytes(cfg, "bfloat16")
    assert kept == pytest.approx(17.87e6, rel=1e-3)
    assert passing == pytest.approx(42.24e6, rel=1e-3)
    assert sum(row_bytes(cfg, "bfloat16", quantize_cross_kv=False)) > kept + passing
    assert sum(row_bytes(cfg, "float32")) > kept + passing
    assert sum(row_bytes(cfg, "bfloat16", quantize_self_kv=True)) < kept + passing


@pytest.fixture
def on_card(monkeypatch):
    """make(model, total_bytes, decodes=1, reserved_bytes=0, **attributes):
    a tiny CPU Transcriber made to look like ``model`` on a card of
    ``total_bytes`` (its config, a CUDA device, its bf16 weights as one
    meta tensor), sized by ``card_slab_cap``; returns (max_chunk_batch,
    _slab_cap, the Transcriber)."""
    base = Transcriber.random_init("test", device="cpu", compute_dtype="float32",
                                   max_new_tokens=4)
    props = {}
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(total_memory=props["total"]))

    def make(model, total, decodes=1, reserved_bytes=0, **attributes):
        props["total"] = total
        tr = copy.copy(base)
        tr.device, tr.cfg = torch.device("cuda", 0), get_config(model)
        tr.params = {"w": torch.empty(PARAMS[model], dtype=torch.bfloat16, device="meta")}
        tr.compute_dtype = "bfloat16"
        for k, v in attributes.items():
            setattr(tr, k, v)
        tr.max_chunk_batch = tr.card_slab_cap(decodes, reserved_bytes)
        return tr.max_chunk_batch, tr._slab_cap, tr

    return make


def test_card_cap_from_the_card_and_the_widths(on_card):
    full, _, tr = on_card("large-v3-turbo", 80 * GB)
    assert full == 128 and tr.weight_bytes() == 2 * PARAMS["large-v3-turbo"]
    small, _, _ = on_card("large-v3-turbo", 16 * GB)
    assert 8 <= small < full
    beam, _, _ = on_card("large-v3-turbo", 16 * GB, beam_size=5)
    assert beam < small and beam in SHAPES
    _, sampled, _ = on_card("large-v3-turbo", 80 * GB, temperature=0.5, best_of=5)
    assert sampled == full // 5
    busy, _, _ = on_card("large-v3-turbo", 16 * GB, decodes=8)
    assert busy < small
    # the card's total memory only: the same card gives the same cap
    assert on_card("large-v3-turbo", 16 * GB)[0] == small


@pytest.mark.parametrize("model,alone,served,beside_llm", [
    ("large-v3-turbo", 128, 128, 88), ("medium", 128, 104, 24), ("large-v3", 112, 56, 8),
])
def test_card_cap_for_the_service(on_card, model, alone, served, beside_llm):
    """An H100 80GB (85.0e9 bytes): alone; with the service's 2 /v1 slots
    and 3 job workers decoding at once; and beside DeepSeek-V2-Lite's
    measured peak.  The wide models beside the notes model come out under
    the 48 rows of the rule this replaces, which could overfill the card."""
    card = 85_000_000_000
    assert on_card(model, card)[0] == alone
    assert on_card(model, card, decodes=5)[0] == served
    llm = LocalLLMClient.card_bytes("deepseek-v2-lite")
    assert on_card(model, card, decodes=5, reserved_bytes=llm)[0] == beside_llm


def test_card_cap_is_the_rule_of_its_inputs():
    usable = 80 * GB * (1 - transcribe.CARD_HEADROOM)
    assert card_slab_cap(80 * GB, 2 * GB, 100 * 10**6) == 128
    fit = int((usable - 2 * GB) // (10**9))
    assert card_slab_cap(80 * GB, 2 * GB, 10**9) == fit // 8 * 8
    # dp data ranks each hold a slab's 1/dp
    assert card_slab_cap(80 * GB, 2 * GB, 10**9, dp=2) == min(128, 2 * fit) // 8 * 8
    assert card_slab_cap(80 * GB, usable, 10**6) == 1  # nothing fits: one window a slab
    assert card_slab_cap(80 * GB, usable - 5 * 10**6, 10**6) == 4


def test_detect_bytes_are_a_float32_cross_cache_of_detect_rows():
    """A language detection's float32 cross cache of every decoder layer
    for ``DETECT_ROWS`` rows, and their float32 states: 2.41 GB at medium's
    widths, 3.99 at large-v3's."""
    assert detect_bytes(get_config("medium")) == pytest.approx(2.408e9, rel=1e-3)
    assert detect_bytes(get_config("large-v3")) == pytest.approx(3.994e9, rel=1e-3)
    cfg = get_config("medium")
    assert detect_bytes(cfg) == decode_lib.DETECT_ROWS * 4 * cfg.n_audio_ctx * (
        cfg.n_text_layer * 2 * cfg.n_text_state + cfg.n_audio_state)


def test_llm_card_bytes_are_its_weights_and_its_work():
    assert LocalLLMClient.card_bytes("deepseek-v2-lite") == pytest.approx(
        2 * 15_706_484_224 + 12 * 10**9)


def test_cpu_mesh_and_explicit_caps(on_card, monkeypatch):
    tr = Transcriber.random_init("test", device="cpu", compute_dtype="float32",
                                 max_new_tokens=4)
    assert tr.max_chunk_batch == transcribe.SLAB_ROWS and tr.card_slab_cap() is None
    # a mesh's card sizes each rank's share of the slab
    one, _, _ = on_card("large-v3-turbo", 16 * GB)
    two, _, _ = on_card("large-v3-turbo", 16 * GB, mesh=types.SimpleNamespace(dp=2))
    assert two == min(128, 2 * one)
    monkeypatch.setattr(Transcriber, "card_slab_cap", lambda self, *a: 96)
    assert Transcriber(params=tr.params, cfg=tr.cfg, device="cpu").max_chunk_batch == 96
    assert Transcriber(params=tr.params, cfg=tr.cfg, device="cpu",
                       max_chunk_batch=7).max_chunk_batch == 7


def test_services_size_the_slabs_for_what_shares_the_card(on_card):
    """``size_slabs`` sizes each Transcriber beside the other's weights and
    the reserved bytes; on the CPU the caps stay."""
    _, _, turbo = on_card("large-v3-turbo", 40 * GB)
    _, _, medium = on_card("medium", 40 * GB)
    size_slabs([turbo, medium], 5, 6 * GB)
    assert turbo.max_chunk_batch == turbo.card_slab_cap(5, 6 * GB + medium.weight_bytes())
    assert medium.max_chunk_batch == medium.card_slab_cap(5, 6 * GB + turbo.weight_bytes())
    assert 1 < medium.max_chunk_batch < on_card("medium", 40 * GB, decodes=5)[0]
    cpu = Transcriber.random_init("test", device="cpu", compute_dtype="float32",
                                  max_new_tokens=4, max_chunk_batch=6)
    size_slabs([cpu], 5, GB)
    assert cpu.max_chunk_batch == 6


class LetterTokenizer:
    def encode(self, text):
        return list(text.encode("utf-8"))

    def decode(self, ids):
        return "".join(chr(97 + int(i) % 26) for i in ids)


def _audio(seconds: float, seed: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16_000)) / 16_000
    sig = np.sin(2 * np.pi * (140 + 40 * np.sin(2 * np.pi * 0.3 * t)) * t)
    return (0.3 * sig * (np.sin(2 * np.pi * 0.9 * t) > -0.3)
            + rng.normal(0, 0.01, len(t))).astype(np.float32)


@pytest.mark.parametrize("options", [
    {}, dict(word_timestamps=True),
    dict(condition_on_previous_text=True, condition_group_size=2, word_timestamps=True),
], ids=["plain", "words", "conditioned_words"])
def test_small_cap_transcribes_as_one_slab(options):
    """Five windows in slabs of 2, 2 and 1 give the tokens, segments and
    words of one slab of 8, and ``transcribe.slabs`` counts the plan."""
    base = Transcriber.random_init("test", device="cpu", compute_dtype="float32",
                                   max_new_tokens=8, tokenizer=LetterTokenizer(),
                                   no_speech_threshold=None, **options)
    params, cfg = base.params, base.cfg
    kw = dict(device="cpu", compute_dtype="float32", max_new_tokens=8,
              tokenizer=LetterTokenizer(), no_speech_threshold=None, enable_fallback=False,
              **options)
    audio = _audio(141.0)  # 5 windows
    outs = {}
    for cap in (2, 128):
        tr = Transcriber(params=params, cfg=cfg, max_chunk_batch=cap, **kw)
        outs[cap] = tr.transcribe(audio, remove_silence=False)
    small, one = outs[2], outs[128]
    assert [(s["start"], s["end"], s["text"], s["tokens"]) for s in small["segments"]] == \
        [(s["start"], s["end"], s["text"], s["tokens"]) for s in one["segments"]]
    assert small["segments"], "the letter tokenizer must give segments"
    if options.get("word_timestamps"):
        assert small["words"] == one["words"] and small["words"]
    cond = options.get("condition_on_previous_text")
    # conditioned: round r decodes window r of each group of 2 in slabs of
    # its own (round 0: windows 0, 2, 4 in 2 + 1 at cap 2; round 1: 1, 3)
    assert small["trace"]["counters"]["transcribe.slabs"] == 3
    assert one["trace"]["counters"]["transcribe.slabs"] == (2 if cond else 1)


def test_batch_counts_its_slabs():
    tr = Transcriber.random_init("test", device="cpu", compute_dtype="float32",
                                 max_new_tokens=4, max_chunk_batch=2)
    outs = tr.transcribe_batch([_audio(61.0), _audio(35.0, seed=4)], remove_silence=False)
    # 3 + 2 windows of one language: slabs of 2, 2 and 1
    assert outs[0]["trace"]["counters"]["transcribe.slabs"] == 3
