"""The decode session, which runs every greedy and sampling decode (and
which the card replays as CUDA graphs), run eagerly on the CPU: its step
of fixed shapes (a device position, an indexed cache write,
self-attention over every slot with the later ones masked) against the
decoder step at an int position over the growing slice, its loop, which
reads the finished flags every ``READBACK_EVERY`` steps, against the same
loop reading them every step, and ``greedy_decode`` and
``prompted_greedy_decode`` against a session built and run directly.

A tiny seeded Whisper with the int4 kernel-layout cross cache (its plain
version on the CPU), in float32 and bfloat16; the EOT row of the token
embedding is scaled so that rows finish early, at different steps.
"""
import pytest
import torch

from audio_processor_tpu_torch.models.whisper import decode, model
from audio_processor_tpu_torch.models.whisper.config import WhisperConfig
from audio_processor_tpu_torch.runtime import trace

CFG = WhisperConfig(name="graph-test", n_mels=80, n_audio_ctx=96, n_audio_state=64,
                    n_audio_head=2, n_audio_layer=1, n_vocab=1024, n_text_ctx=64,
                    n_text_state=64, n_text_head=2, n_text_layer=2)
ST = decode.SpecialTokens.for_config(CFG)
SOT = tuple(ST.sot_sequence())
MAX_NEW = 40
B = 8


def weights(eot_scale: float, dtype=torch.float32):
    params = model.init_params(CFG, torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    dec = params["decoder"]
    dec["pos_emb"] = dec["pos_emb"] + 0.1 * torch.randn(dec["pos_emb"].shape, generator=g)
    dec["token_emb"][ST.eot] *= eot_scale
    return model.map_params(lambda t: t.to(dtype), params)


def states(dtype=torch.float32):
    return torch.randn(B, 96, 64, generator=torch.Generator().manual_seed(3)).to(dtype)


HIST = [[5, 6, 7, 8]] + [[]] * 4 + [[9, 10]] + [[]] * 2  # rows 0 and 5 with a context


def prompt_rows():
    """Left-padded prompts: rows 0 and 5 with a previous-text context."""
    rows, lens = decode.build_prompt_rows(HIST, SOT, ST, 4)
    rows = torch.as_tensor(rows).long()
    return rows, rows.shape[1] - torch.as_tensor(lens).long()


def cache(params, dtype, p_len, quantize_self_kv=False):
    return decode.init_cache(params, CFG, states(dtype), p_len + MAX_NEW, dtype=dtype,
                             quantize_cross_kv=True, kernel_layout=True, kv_bits=4,
                             quantize_self_kv=quantize_self_kv)


@pytest.mark.parametrize("quantize_self_kv", [False, True], ids=["self-float", "self-int8"])
@pytest.mark.parametrize("prompted", [False, True], ids=["sot", "prompted"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_static_step_matches_the_eager_step(dtype, prompted, quantize_self_kv):
    """Ten steps fed the same tokens: the step at a device position over
    the whole cache gives the eager step's argmax, and its logits within
    1e-5 at float32, and writes the same self cache, within 1e-5 there."""
    params = weights(2.0, dtype)
    if prompted:
        prompt, pad = prompt_rows()
    else:
        prompt, pad = torch.tensor(SOT)[None].repeat(B, 1), None
    p_len = prompt.shape[1]
    kw = dict(pos_offset=pad, min_valid=pad, compute_dtype=dtype, kernel_layout=True,
              unembed=params["decoder"]["token_emb"].float())
    eager, static = (cache(params, dtype, p_len, quantize_self_kv) for _ in range(2))
    logits, _ = decode.decoder_forward_cached(params, CFG, prompt, eager, 0, **kw)
    decode.decoder_forward_cached(params, CFG, prompt, static, 0, **kw)
    tok = logits[:, -1].argmax(-1)
    for step in range(10):
        want, _ = decode.decoder_forward_cached(params, CFG, tok[:, None], eager, p_len + step,
                                                **kw)
        got, _ = decode.decoder_forward_cached(params, CFG, tok[:, None], static,
                                               torch.tensor([p_len + step]), **kw)
        assert torch.equal(got.argmax(-1), want.argmax(-1))
        if dtype == torch.float32:
            assert (got - want).abs().max().item() <= 1e-5
        tok = want[:, -1].argmax(-1)
    if dtype == torch.float32 and not quantize_self_kv:
        for name in ("self_k", "self_v"):
            assert (getattr(eager, name) - getattr(static, name)).abs().max().item() <= 1e-5


def session_decode(params, dtype, readback_every, prompted=False):
    """The session's decode on the CPU, reading the finished flags every
    ``readback_every`` steps."""
    if prompted:
        prompt, pad = prompt_rows()
        last, penult = prompt[:, -1], prompt[:, -2]
    else:
        prompt, pad = torch.tensor(SOT)[None].repeat(B, 1), None
        last, penult = torch.full((B,), SOT[-1]), torch.full((B,), SOT[0])
    sess = decode._DecodeSession(
        params, CFG, B, 96, prompt.shape[1], MAX_NEW, dtype, quantize_cross_kv=True,
        kernel_layout=True, bits=4, quantize_self_kv=False, use_timestamps=True, suppress=False,
        prompted=prompted, mesh=None, device=torch.device("cpu"))
    with pytest.MonkeyPatch.context() as mp, trace.request() as rec:
        mp.setattr(decode, "READBACK_EVERY", readback_every)
        res = sess.decode(params, states(dtype), prompt, pad, sot_len=len(SOT), last_init=last,
                          penult_init=penult, suppress_mask=None, space_blank_id=None,
                          max_initial_ts_index=50)
    return res, rec.counters


@pytest.mark.parametrize("eot_scale", [2.0, 3.0], ids=["some-to-the-cap", "all-finish-early"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_readback_every_16_steps_is_bit_equal(dtype, eot_scale):
    """Reading the finished flags every 16 steps gives the tokens, lengths
    and summed logprobs of reading them every step, bit for bit, on a slab
    whose rows finish at different steps; the extra steps run only past the
    last row's EOT, up to the next read."""
    params = weights(eot_scale, dtype)
    every, each = session_decode(params, dtype, 16), session_decode(params, dtype, 1)
    (a, ca), (b, cb) = every, each
    assert len(set(b.lengths.tolist())) >= 3  # rows finish at different steps
    assert (b.lengths < MAX_NEW).any()
    for name in ("tokens", "lengths", "sum_logprob", "no_speech_prob"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    steps_each = int(b.lengths.max()) + 1 if bool((b.lengths < MAX_NEW).all()) else MAX_NEW
    assert cb["decode.steps"] == min(steps_each, MAX_NEW)
    assert ca["decode.steps"] == min(-(-steps_each // 16) * 16, MAX_NEW)
    assert "decode.graph_steps" not in ca  # nothing replayed on the CPU


@pytest.mark.parametrize("prompted", [False, True], ids=["sot", "prompted"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_decode_runs_in_the_session(dtype, prompted):
    """``greedy_decode`` and ``prompted_greedy_decode`` return what a
    session built and run directly returns, bit for bit; nothing is
    replayed on the CPU, and the finished flags are read every
    ``READBACK_EVERY`` steps, so the steps run are a multiple of it or the
    cap."""
    params = weights(3.0, dtype)
    kw = dict(max_new_tokens=MAX_NEW, quantize_cross_kv=True, kv_bits=4,
              dtype_name=str(dtype).removeprefix("torch."))
    with trace.request() as rec:
        if prompted:
            rows, lens = decode.build_prompt_rows(HIST, SOT, ST, 4)
            got = decode.prompted_greedy_decode(params, CFG, states(dtype), rows, lens,
                                                sot_len=len(SOT), **kw)
        else:
            got = decode.greedy_decode(params, CFG, states(dtype), sot_sequence=SOT, **kw)
    want, _ = session_decode(params, dtype, decode.READBACK_EVERY, prompted)
    for name in ("tokens", "lengths", "sum_logprob", "no_speech_prob"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert "decode.graph_steps" not in rec.counters
    steps = rec.counters["decode.steps"]
    assert steps % decode.READBACK_EVERY == 0 or steps == MAX_NEW
    assert rec.spans["decode.wait"][2] == -(-steps // decode.READBACK_EVERY)
