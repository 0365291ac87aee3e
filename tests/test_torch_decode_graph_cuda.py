"""Greedy decode replayed as CUDA graphs, on the card: a random model of
large-v3-turbo's decoder widths (d 1280, 20 heads, 4 layers, the full
vocabulary) at bf16 with the int4 cross cache, so kernel B runs between
the graphs.

The replayed decode gives the same tokens and summed logprobs as the same
session run eagerly, at B = 48 and B = 2; every kernel B launch still
goes through its wrapper (4 a decoder forward, the prefill's included);
``decode.graph_steps`` counts the replayed steps, in a Transcriber's
``result["trace"]`` too; two threads decoding one shape at once each get
the answer one decode alone gets; and so does a decode that finds every
kept session of its shape busy, which runs a session of its own eagerly.

CUDA graphs and kernel B have no CPU mode, so every test here is marked
``cuda`` and skips without a card (the CPU half is
``tests/test_torch_decode_graph.py``):

    python -m pytest --noconftest -m cuda tests/test_torch_decode_graph_cuda.py
"""
import threading

import numpy as np
import pytest
import torch

from audio_processor_tpu_torch.models.whisper import decode, model
from audio_processor_tpu_torch.models.whisper.config import WhisperConfig
from audio_processor_tpu_torch.ops.kernels import decode_attention as da
from audio_processor_tpu_torch.runtime import trace
from audio_processor_tpu_torch.runtime.device import set_full_fp32

pytestmark = pytest.mark.cuda

CFG = WhisperConfig(name="turbo-decoder", n_mels=128, n_audio_ctx=1500, n_audio_state=1280,
                    n_audio_head=20, n_audio_layer=1, n_vocab=51866, n_text_ctx=448,
                    n_text_state=1280, n_text_head=20, n_text_layer=4)
ST = decode.SpecialTokens.for_config(CFG)
SOT = tuple(ST.sot_sequence(language=0))
MAX_NEW = 48


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and kernel B have no CPU mode")
    set_full_fp32()
    return torch.device("cuda")


def params_on(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    params = model.init_params(CFG, g)
    # biases, norms and positions drawn too, so every row of them matters
    params["decoder"] = model.map_params(
        lambda t: t + 0.02 * torch.randn(t.shape, generator=g, device=dev) if t.dim() < 3 else t,
        params["decoder"])
    return model.map_params(lambda t: t.to(torch.bfloat16), params)


def states_on(dev, b, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(b, CFG.n_audio_ctx, CFG.n_audio_state, generator=g,
                       device=dev).to(torch.bfloat16)


def suppress_on(dev):
    mask = torch.zeros(CFG.n_vocab, dtype=torch.bool, device=dev)
    mask[[220, 1000, ST.no_speech]] = True
    return mask


def greedy(params, states, suppress):
    with trace.request() as rec:
        res = decode.greedy_decode(params, CFG, states, sot_sequence=SOT, max_new_tokens=MAX_NEW,
                                   dtype_name="bfloat16", quantize_cross_kv=True, kv_bits=4,
                                   suppress_mask=suppress)
    torch.cuda.synchronize()
    return res, rec.counters


def eager_session(params, states, suppress):
    """A session with nothing captured: every step runs eagerly."""
    b, dev = states.shape[0], states.device
    sess = decode._DecodeSession(
        params, CFG, b, CFG.n_audio_ctx, len(SOT), MAX_NEW, torch.bfloat16,
        quantize_cross_kv=True, kernel_layout=True, bits=4, quantize_self_kv=False,
        use_timestamps=True, suppress=True, prompted=False, mesh=None, device=dev)
    return sess.decode(params, states, torch.tensor(SOT, device=dev)[None].repeat(b, 1), None,
                       sot_len=len(SOT), last_init=torch.full((b,), SOT[-1], device=dev),
                       penult_init=torch.full((b,), SOT[0], device=dev), suppress_mask=suppress,
                       space_blank_id=None, max_initial_ts_index=50)


def same(a, b) -> bool:
    return all(torch.equal(getattr(a, n), getattr(b, n))
               for n in ("tokens", "lengths", "sum_logprob", "no_speech_prob"))


@pytest.mark.parametrize("b", [48, 2])
def test_replayed_decode_equals_the_eager_session(dev, b):
    """The graphs replay the step the session runs eagerly: tokens,
    lengths and summed logprobs equal, the first decode (which captures)
    and the next alike."""
    params, states, suppress = params_on(dev), states_on(dev, b), suppress_on(dev)
    want = eager_session(params, states, suppress)
    first, c1 = greedy(params, states, suppress)
    again, c2 = greedy(params, states, suppress)
    assert c1["decode.graph_steps"] == c2["decode.graph_steps"] == MAX_NEW - 2
    assert same(first, want) and same(again, want)


def test_every_kernel_b_launch_goes_through_its_wrapper(dev, monkeypatch):
    """4 launches of kernel B a decoder forward (the prefill and each step
    after the first), counted by the wrapper, whether the steps were
    replayed or eager; a wrapper put on the module's name sees each."""
    params, states, suppress = params_on(dev), states_on(dev, 8), suppress_on(dev)
    calls = []
    wrapped = decode.cross_attention_int4_stacked

    def spy(q, *a, **kw):
        calls.append((tuple(q.shape), kw["valid_len"]))
        return wrapped(q, *a, **kw)

    for graphs in (True, False):
        if not graphs:
            monkeypatch.setattr(decode, "_graphs_serve", lambda *a: False)
        before, n_calls = da.cross_attention_int4_stacked.launches, len(calls)
        with monkeypatch.context() as m:
            m.setattr(decode, "cross_attention_int4_stacked", spy)
            _, counters = greedy(params, states, suppress)
        steps = counters["decode.steps"]
        assert steps == MAX_NEW
        assert counters.get("decode.graph_steps", 0) == (steps - 2 if graphs else 0)
        assert da.cross_attention_int4_stacked.launches - before == 4 * steps
        assert len(calls) - n_calls == 4 * steps
        assert calls[n_calls] == ((8, len(SOT), 20, 64), CFG.n_audio_ctx)  # the prefill
        assert set(calls[n_calls + 4:]) == {((8, 1, 20, 64), CFG.n_audio_ctx)}


def test_graph_steps_reach_the_transcribers_trace(dev, monkeypatch):
    """A Transcriber's ``result["trace"]`` counts ``decode.graph_steps``,
    one for each step the graphs replayed."""
    from audio_processor_tpu_torch.pipeline.transcribe import Transcriber

    replays = []
    replay = torch.cuda.CUDAGraph.replay
    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay",
                        lambda self: (replays.append(1), replay(self))[1])
    tr = Transcriber(params=params_on(dev), cfg=CFG, max_new_tokens=24, language=0,
                     enable_fallback=False, no_speech_threshold=None)
    t = np.arange(45 * 16_000) / 16_000
    audio = 0.3 * np.sin(2 * np.pi * 220 * t) * (np.sin(2 * np.pi * 0.7 * t) > 0)
    audio = audio.astype(np.float32)
    tr.transcribe(audio)  # the first call makes the session
    replays.clear()
    counters = tr.transcribe(audio)["trace"]["counters"]
    pieces = CFG.n_text_layer + 1
    assert counters["decode.graph_steps"] > 0
    assert counters["decode.graph_steps"] * pieces == len(replays)


def test_two_threads_decoding_one_shape_get_the_lone_answer(dev):
    """Two decodes of one shape at once (the second makes a session of its
    own while the first holds one) each return what one decode alone
    returns."""
    params, states, suppress = params_on(dev), states_on(dev, 16), suppress_on(dev)
    alone, _ = greedy(params, states, suppress)
    got, errors = [None, None], []
    barrier = threading.Barrier(2)

    def worker(i):
        try:
            barrier.wait(timeout=60)
            got[i] = greedy(params, states, suppress)[0]
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert same(got[0], alone) and same(got[1], alone)


def test_a_decode_with_every_kept_session_busy_gets_the_lone_answer(dev, monkeypatch):
    """With ``MAX_SESSIONS`` sessions of its shape held busy, a B = 48
    decode runs a session made for it alone, eagerly (nothing replayed),
    and returns what a lone decode, replayed, returns."""
    params, states, suppress = params_on(dev), states_on(dev, 48), suppress_on(dev)
    alone, c_alone = greedy(params, states, suppress)
    acquire, held = decode._acquire_session, []

    def hold_every_kept_session_then_acquire(key, make):
        held.extend(acquire(key, make) for _ in range(decode.MAX_SESSIONS))
        return acquire(key, make)

    monkeypatch.setattr(decode, "_acquire_session", hold_every_kept_session_then_acquire)
    try:
        got, counters = greedy(params, states, suppress)
    finally:
        for sess in held:
            decode._release_session(sess)
    assert len({id(s) for s in held}) == decode.MAX_SESSIONS
    assert c_alone["decode.graph_steps"] > 0 and "decode.graph_steps" not in counters
    assert same(got, alone)
