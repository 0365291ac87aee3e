"""The port's decode (cache, logit rules, greedy loop, language detection,
host helpers) against the JAX package's, on the same weights and states.

Greedy decode at T=0 must agree token for token (and in lengths) with
``decode.greedy_decode`` for the int4 kernel-layout, int8 and unquantized
caches.  Floats (no-speech probability, summed logprob) are compared at
1e-5: the two frameworks sum in different orders.  Sampling at T>0 cannot
match jax.random, so it is checked against the rules, the best_of ranking,
seed determinism, the softmax it draws from and the independence of a
row's draws from the other rows instead.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from audio_processor_tpu.models.whisper import decode as jdecode
from audio_processor_tpu.models.whisper.config import WhisperConfig as JConfig
from audio_processor_tpu_torch.models.whisper import convert, decode, model
from audio_processor_tpu_torch.models.whisper.config import WhisperConfig
from audio_processor_tpu_torch.runtime.device import set_full_fp32

set_full_fp32()

DIMS = dict(
    n_mels=80, n_audio_ctx=96, n_audio_state=64, n_audio_head=2,
    n_audio_layer=2, n_vocab=1024, n_text_ctx=64, n_text_state=64,
    n_text_head=2, n_text_layer=2,
)
CFG = WhisperConfig(name="genparity", **DIMS)
JCFG = JConfig(name="genparity", **DIMS)
ST = decode.SpecialTokens.for_config(CFG)
TB = ST.timestamp_begin
MAX_NEW = 24


def jax_tree_from_seed(cfg, seed):
    """A JAX-layout parameter tree of random weights (conv stem in HIO),
    drawn through the port's initialiser; biases and norms randomised."""
    params = model.init_params(cfg, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    out = {}
    for k, t in convert._flatten(params).items():
        a = t.numpy()
        if k in convert._CONV_KEYS:
            a = a.transpose(2, 1, 0)
        if k.endswith(("/b", "/bias")):
            a = rng.normal(0, 0.02, a.shape).astype(np.float32)
        if k.endswith("/scale"):
            a = (1.0 + rng.normal(0, 0.05, a.shape)).astype(np.float32)
        out[k] = jnp.asarray(a)
    return convert._unflatten(out)


@pytest.fixture(scope="module")
def weights():
    jparams = jax_tree_from_seed(CFG, 7)
    return jparams, convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


@pytest.fixture(scope="module")
def states():
    rng = np.random.default_rng(8)
    return rng.normal(0, 1, (3, CFG.n_audio_ctx, CFG.n_audio_state)).astype(np.float32)


@pytest.fixture(scope="module")
def suppress():
    mask = np.zeros(CFG.n_vocab, bool)
    mask[decode.always_suppressed_specials(ST)] = True
    mask[[10, 11, 12]] = True
    return mask


@pytest.mark.parametrize("bits", [4, 8])
def test_init_cache_quantized_equal_jax(weights, states, bits):
    """Same states in: int8/int4 cache bytes exactly equal, scales 1e-6."""
    jparams, params = weights
    kw = dict(quantize_cross_kv=True, kernel_layout=bits == 4, kv_bits=bits)
    jc = jdecode.init_cache(jparams, JCFG, jnp.asarray(states), 5, **kw)
    oc = decode.init_cache(params, CFG, torch.from_numpy(states), 5, **kw)
    assert oc.cross_k.dtype == torch.int8
    assert tuple(oc.cross_k.shape) == jc.cross_k.shape
    assert tuple(oc.cross_v.shape) == jc.cross_v.shape
    np.testing.assert_array_equal(oc.cross_k.numpy(), np.asarray(jc.cross_k))
    np.testing.assert_array_equal(oc.cross_v.numpy(), np.asarray(jc.cross_v))
    np.testing.assert_allclose(oc.cross_k_scale.numpy(), np.asarray(jc.cross_k_scale), atol=1e-6)
    np.testing.assert_allclose(oc.cross_v_scale.numpy(), np.asarray(jc.cross_v_scale), atol=1e-6)
    L_, B_, T_, H_, D_ = jc.self_k.shape  # the port keeps it head-major
    assert tuple(oc.self_k.shape) == (L_, B_, H_, T_, D_)


def test_init_cache_int8_kernel_layout_bytes_equal_jax(weights, states):
    """The int8 kernel layout: K (L, B, H, Dh, Tpad), V (L, B, H, Tpad, Dh),
    zero-padded to a multiple of 128, byte for byte the JAX cache."""
    jparams, params = weights
    kw = dict(quantize_cross_kv=True, kernel_layout=True, kv_bits=8)
    jc = jdecode.init_cache(jparams, JCFG, jnp.asarray(states), 5, **kw)
    oc = decode.init_cache(params, CFG, torch.from_numpy(states), 5, **kw)
    assert tuple(oc.cross_k.shape) == jc.cross_k.shape == (2, 3, 2, 32, 128)
    assert tuple(oc.cross_v.shape) == jc.cross_v.shape == (2, 3, 2, 128, 32)
    np.testing.assert_array_equal(oc.cross_k.numpy(), np.asarray(jc.cross_k))
    np.testing.assert_array_equal(oc.cross_v.numpy(), np.asarray(jc.cross_v))
    np.testing.assert_allclose(oc.cross_k_scale.numpy(), np.asarray(jc.cross_k_scale), atol=1e-6)
    assert not oc.cross_k[..., CFG.n_audio_ctx:].any()


def test_quantize_rounds_half_to_even():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, 7.0]).reshape(1, 1, 5, 1, 1)
    q, scale = decode._quantize_kv(x, bits=4)
    assert scale.item() == 1.0
    assert q.flatten().tolist() == [0, 2, 2, 0, 7]


@pytest.mark.parametrize("step", [0, 1, 2, 5])
def test_apply_logit_rules_equal_jax(suppress, step):
    rng = np.random.default_rng(step)
    b = 6
    logits = rng.normal(0, 3, (b, CFG.n_vocab)).astype(np.float32)
    # states spanning the pairing cases: text/ts last and penultimate tokens
    last = np.array([5, TB + 3, TB + 3, 7, TB + 10, ST.sot])
    penult = np.array([TB + 1, TB + 2, 9, TB, 8, ST.sot])
    max_ts = np.array([TB + 1, TB + 3, TB + 3, TB, TB + 10, TB - 1])
    kw = dict(use_timestamps=True, max_initial_timestamp_index=50, space_blank_id=32)
    ours = decode.apply_logit_rules(
        torch.from_numpy(logits), ST, step=step,
        last_token=torch.from_numpy(last), penultimate_token=torch.from_numpy(penult),
        max_ts_token=torch.from_numpy(max_ts), suppress_mask=torch.from_numpy(suppress), **kw,
    ).numpy()
    ref = np.asarray(jdecode.apply_logit_rules(
        jnp.asarray(logits), jdecode.SpecialTokens.for_config(JCFG), step=jnp.int32(step),
        last_token=jnp.asarray(last), penultimate_token=jnp.asarray(penult),
        max_ts_token=jnp.asarray(max_ts), suppress_mask=jnp.asarray(suppress), **kw,
    ))
    masked_o, masked_r = np.isneginf(ours), np.isneginf(ref)
    np.testing.assert_array_equal(masked_o, masked_r)
    np.testing.assert_array_equal(ours[~masked_o], ref[~masked_r])


def _greedy_pair(weights, states, suppress, **kw):
    jparams, params = weights
    sot = tuple(ST.sot_sequence())
    common = dict(sot_sequence=sot, max_new_tokens=MAX_NEW, space_blank_id=32)
    ref = jdecode.greedy_decode(
        jparams, JCFG, jnp.asarray(states), suppress_mask=jnp.asarray(suppress),
        **common, **kw,
    )
    ours = decode.greedy_decode(
        params, CFG, torch.from_numpy(states), suppress_mask=torch.from_numpy(suppress),
        **common, **kw,
    )
    return ref, ours


CACHES = {
    "int4": dict(quantize_cross_kv=True, kv_bits=4),
    "int8": dict(quantize_cross_kv=True, kv_bits=8),
    "int8-kernel": dict(quantize_cross_kv=True, kv_bits=8, use_pallas_kernel=True),
    "float": {},
}


@pytest.mark.parametrize("cache", ["int4", "int8", "float", "int8-kernel"])
def test_greedy_decode_token_exact(weights, states, suppress, cache):
    kw = CACHES[cache]
    ref, ours = _greedy_pair(weights, states, suppress, **kw)
    np.testing.assert_array_equal(ours.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(ours.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_allclose(ours.no_speech_prob.numpy(), np.asarray(ref.no_speech_prob), atol=1e-5)
    np.testing.assert_allclose(ours.sum_logprob.numpy(), np.asarray(ref.sum_logprob), atol=1e-4)
    assert (ours.lengths > 0).any()


def test_detect_language_equal_jax():
    dims = dict(DIMS, n_vocab=51865, n_audio_ctx=32)
    cfg, jcfg = WhisperConfig(name="ml", **dims), JConfig(name="ml", **dims)
    jparams = jax_tree_from_seed(cfg, 9)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    st = np.random.default_rng(10).normal(0, 1, (3, 32, 64)).astype(np.float32)
    idx, probs = decode.detect_language(params, cfg, torch.from_numpy(st))
    jidx, jprobs = jdecode.detect_language(jparams, jcfg, jnp.asarray(st))
    assert probs.shape == (3, 99)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-5)


ROWS = np.full((6, 12), ST.eot, np.int64)
ROWS[0, :8] = [TB, 5, 6, TB + 50, TB + 50, 7, 8, TB + 100]          # two closed
ROWS[1, :7] = [TB, 5, 6, TB + 50, TB + 60, 7, 8]                    # trailing text
ROWS[2, :4] = [5, 6, 7, 8]                                          # no timestamps
ROWS[3, :6] = [TB + 10, 5, TB + 700, TB + 700, 6, 7]                # rewind late
ROWS[4, :5] = [TB, 9, TB + 40, TB + 45, TB + 45]                    # ts-ts ending
ROWS[5, :0] = []                                                    # empty


def _text(ids):
    return "".join(chr(97 + int(i) % 26) for i in ids)


def test_tokens_to_segments_equal_jax():
    jst = jdecode.SpecialTokens.for_config(JCFG)
    offsets = np.arange(6) * 30.0
    durs = np.array([30.0, 30.0, 12.5, 30.0, 30.0, 3.0])
    meta = [{"temperature": 0.0, "avg_logprob": -float(i)} for i in range(6)]
    ours = decode.tokens_to_segments(ROWS, ST, offsets, _text, chunk_durations_s=durs, row_meta=meta)
    ref = jdecode.tokens_to_segments(ROWS, jst, offsets, _text, chunk_durations_s=durs, row_meta=meta)
    assert ours == ref and len(ours) >= 5


@pytest.mark.parametrize("cut", [0.5, 1.0, 13.0])
def test_seek_helpers_equal_jax(cut):
    jst = jdecode.SpecialTokens.for_config(JCFG)
    for row in ROWS:
        assert decode.seek_consumed(row, ST) == jdecode.seek_consumed(row, jst)
        np.testing.assert_array_equal(
            decode.truncate_row_after_seek(row, ST), jdecode.truncate_row_after_seek(row, jst)
        )
        o_row, o_end = decode.keep_closed_segments_before(row, ST, cut)
        r_row, r_end = jdecode.keep_closed_segments_before(row, jst, cut)
        np.testing.assert_array_equal(o_row, r_row)
        assert o_end == r_end
        np.testing.assert_array_equal(
            decode.drop_segments_before(row, ST, cut), jdecode.drop_segments_before(row, jst, cut)
        )


def test_suppress_helpers_equal_jax():
    from audio_processor_tpu.models.whisper.tokenizer import ByteTokenizer as JTok
    from audio_processor_tpu_torch.models.whisper.tokenizer import ByteTokenizer

    jst = jdecode.SpecialTokens.for_config(JCFG)
    np.testing.assert_array_equal(
        decode.build_suppress_mask(ByteTokenizer(), ST), jdecode.build_suppress_mask(JTok(), jst)
    )
    assert decode.space_blank_token_id(ByteTokenizer(), ST) == jdecode.space_blank_token_id(JTok(), jst)


def _assert_obeys_rules(row, suppress, max_initial=50):
    """Whisper's rules on one sampled row (openai's ApplyTimestampRules,
    SuppressTokens, SuppressBlank)."""
    seq = []
    for i, t in enumerate(int(x) for x in row):
        if t == ST.eot:
            assert i > 0, "EOT is suppressed at the first sample"
            assert all(int(x) == ST.eot for x in row[i:])
            return
        assert not suppress[t] and t != ST.no_timestamps
        if i == 0:
            assert TB <= t <= TB + max_initial
        last_ts = bool(seq) and seq[-1] >= TB
        penult_ts = len(seq) < 2 or seq[-2] >= TB
        if last_ts and penult_ts:
            assert t < TB, f"timestamp after a timestamp pair in {seq + [t]}"
        if last_ts and not penult_ts:
            assert t >= TB, f"text after a lone timestamp in {seq + [t]}"
        prior = [x for x in seq if x >= TB]
        if t >= TB and prior:
            floor = prior[-1] if (last_ts and not penult_ts) else prior[-1] + 1
            assert t >= floor, f"decreasing timestamp in {seq + [t]}"
        seq.append(t)


def test_sampling_obeys_rules_and_seed(weights, states, suppress):
    _, params = weights
    kw = dict(
        sot_sequence=tuple(ST.sot_sequence()), max_new_tokens=MAX_NEW,
        suppress_mask=torch.from_numpy(suppress), space_blank_id=32,
        temperature=1.0, quantize_cross_kv=True, kv_bits=4,
    )
    a = decode.greedy_decode(params, CFG, torch.from_numpy(states), rng_seed=3, **kw)
    b = decode.greedy_decode(params, CFG, torch.from_numpy(states), rng_seed=3, **kw)
    c = decode.greedy_decode(params, CFG, torch.from_numpy(states), rng_seed=4, **kw)
    assert torch.equal(a.tokens, b.tokens)
    assert not torch.equal(a.tokens, c.tokens)
    for row in torch.cat([a.tokens, c.tokens]).numpy():
        _assert_obeys_rules(row, suppress)


def test_best_of_picks_highest_average_logprob(weights, states, suppress):
    """best_of=3 returns, per element, the candidate with the best
    sum_logprob / length among the 3 samples drawn for it."""
    _, params = weights
    kw = dict(
        sot_sequence=tuple(ST.sot_sequence()), max_new_tokens=MAX_NEW,
        suppress_mask=torch.from_numpy(suppress), temperature=0.8, rng_seed=5,
    )
    x = torch.from_numpy(states)
    best = decode.greedy_decode(params, CFG, x, best_of=3, **kw)
    cands = decode.greedy_decode(params, CFG, x.repeat_interleave(3, dim=0), **kw)
    avg = (cands.sum_logprob / cands.lengths.clamp(min=1)).reshape(3, 3)
    pick = avg.argmax(dim=1) + torch.arange(3) * 3
    assert torch.equal(best.tokens, cands.tokens[pick])
    assert torch.equal(best.lengths, cands.lengths[pick])
    assert torch.equal(best.no_speech_prob, cands.no_speech_prob[::3])


@pytest.mark.parametrize("best_of", [1, 2])
def test_sampled_row_ignores_the_other_rows(weights, states, suppress, best_of):
    """A row's draws are keyed by its index in the batch: with other rows
    around it (fewer of them, other audio) its sampled tokens stay."""
    _, params = weights
    kw = dict(
        sot_sequence=tuple(ST.sot_sequence()), max_new_tokens=MAX_NEW,
        suppress_mask=torch.from_numpy(suppress), temperature=1.0, rng_seed=9,
        best_of=best_of, quantize_cross_kv=True, kv_bits=4,
    )
    x = torch.from_numpy(states)
    whole = decode.greedy_decode(params, CFG, x, **kw)
    other = torch.from_numpy(np.random.default_rng(99).normal(0, 1, x[:1].shape).astype(np.float32))
    fewer = decode.greedy_decode(params, CFG, torch.cat([other, x[1:2]]), **kw)
    assert torch.equal(fewer.tokens[1], whole.tokens[1])
    assert torch.equal(fewer.lengths[1], whole.lengths[1])
    greedy = decode.greedy_decode(params, CFG, x, **dict(kw, temperature=0.0))
    assert not torch.equal(whole.tokens, greedy.tokens)  # it did sample


def test_mix64_equals_numpy_uint64():
    """The sampler's hash on int64 tensors is splitmix64's finaliser in
    uint64 arithmetic (torch's >> is arithmetic and its products wrap)."""
    xs = np.random.default_rng(12).integers(-2**63, 2**63 - 1, 4099, dtype=np.int64)
    x = xs.view(np.uint64)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    got = decode._mix64(torch.from_numpy(xs)).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, x)


def test_sample_tokens_follow_the_softmax():
    """Gumbel-max draws over 40,000 rows (one stream each) land on
    softmax(logits / T) within 0.01, masked ids never; a fixed key and step
    draws the same token whatever row sits beside it."""
    probs = np.array([0.1, 0.2, 0.0, 0.3, 0.4])
    logits = torch.from_numpy(np.log(np.maximum(probs, 1e-300))).float()
    logits[2] = float("-inf")
    n, temp = 40_000, 0.7
    keys = decode.sampling_row_keys(5, torch.arange(n))
    toks = decode.sample_tokens(logits[None].repeat(n, 1) * temp, temp, keys, 3)
    freq = torch.bincount(toks, minlength=5).double() / n
    assert freq[2] == 0
    assert (freq - torch.from_numpy(probs)).abs().max().item() <= 0.01
    g = torch.Generator().manual_seed(0)
    flat = torch.zeros(64, 50)
    rows = torch.randn(64, 50, generator=g)
    alone = torch.stack([decode.sample_tokens(rows[i:i + 1], 1.0, keys[i:i + 1], 3)[0]
                         for i in range(64)])
    assert torch.equal(decode.sample_tokens(rows, 1.0, keys[:64], 3), alone)
    # the step and the row are in the key: uniform logits draw other ids
    assert not torch.equal(decode.sample_tokens(flat, 1.0, keys[:64], 3),
                           decode.sample_tokens(flat, 1.0, keys[:64], 4))
    assert len(set(decode.sample_tokens(flat, 1.0, keys[:64], 3).tolist())) > 30


def test_rank_groups_equal_jax():
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 900, (6, 5))
    lens = rng.integers(0, 6, 6)
    slp = rng.normal(-5, 2, 6).astype(np.float32)
    nsp = rng.random(6).astype(np.float32)
    ours = decode._rank_groups(*map(torch.from_numpy, (toks, lens, slp, nsp)), 2, 3)
    ref = jdecode._rank_groups(*map(jnp.asarray, (toks, lens, slp, nsp)), 2, 3)
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_num_languages_delegates_to_special_tokens():
    assert dataclasses.replace(CFG, n_vocab=51866).num_languages == 100
    assert CFG.num_languages == 2


# ---------------------------------------------------------------------------
# prompted greedy decode and beam search
# ---------------------------------------------------------------------------

HISTORIES = [[5, 6, 7, 8, 9, 40], [], [100, 200], [7]]  # mixed, one empty


@pytest.fixture(scope="module")
def states4():
    return np.random.default_rng(13).normal(0, 1, (4, CFG.n_audio_ctx, CFG.n_audio_state)).astype(np.float32)


@pytest.fixture(scope="module")
def narrow():
    """A suppress mask that leaves EOT, six text tokens and the timestamps:
    random weights then end hypotheses early, so beam search fills its
    finished sets."""
    mask = np.ones(CFG.n_vocab, bool)
    mask[[ST.eot] + list(range(5, 11))] = False
    mask[TB:] = False
    return mask


def test_build_prompt_rows_equal_jax():
    jst = jdecode.SpecialTokens.for_config(JCFG)
    sot = tuple(ST.sot_sequence())
    for ctx in (0, 3, 8):
        ours = decode.build_prompt_rows(HISTORIES + [[ST.eot, 5]], sot, ST, ctx)
        ref = jdecode.build_prompt_rows(HISTORIES + [[ST.eot, 5]], sot, jst, ctx)
        for o, r in zip(ours, ref):
            np.testing.assert_array_equal(o, r)


def _prompted_pair(weights, states, mask, rows, lens, **kw):
    jparams, params = weights
    common = dict(sot_len=len(ST.sot_sequence()), max_new_tokens=MAX_NEW, space_blank_id=32)
    ref = jdecode.prompted_greedy_decode(
        jparams, JCFG, jnp.asarray(states), jnp.asarray(rows), jnp.asarray(lens),
        suppress_mask=jnp.asarray(mask), **common, **kw,
    )
    ours = decode.prompted_greedy_decode(
        params, CFG, torch.from_numpy(states), rows, lens,
        suppress_mask=torch.from_numpy(mask), **common, **kw,
    )
    return ref, ours


@pytest.mark.parametrize("cache", ["float", "int4", "int8-kernel"])
def test_prompted_greedy_token_exact(weights, states4, suppress, cache):
    rows, lens = decode.build_prompt_rows(HISTORIES, tuple(ST.sot_sequence()), ST, 4)
    ref, ours = _prompted_pair(weights, states4, suppress, rows, lens, **CACHES[cache])
    np.testing.assert_array_equal(ours.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(ours.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_allclose(ours.no_speech_prob.numpy(), np.asarray(ref.no_speech_prob), atol=1e-5)
    np.testing.assert_allclose(ours.sum_logprob.numpy(), np.asarray(ref.sum_logprob), atol=1e-4)


def test_prompted_with_empty_histories_equals_greedy(weights, states4, suppress):
    _, params = weights
    sot = tuple(ST.sot_sequence())
    rows, lens = decode.build_prompt_rows([[]] * 4, sot, ST, 4)
    kw = dict(max_new_tokens=MAX_NEW, suppress_mask=torch.from_numpy(suppress), space_blank_id=32,
              quantize_cross_kv=True, kv_bits=4)
    x = torch.from_numpy(states4)
    prompted = decode.prompted_greedy_decode(params, CFG, x, rows, lens, sot_len=len(sot), **kw)
    plain = decode.greedy_decode(params, CFG, x, sot_sequence=sot, **kw)
    assert torch.equal(prompted.tokens, plain.tokens)
    torch.testing.assert_close(prompted.sum_logprob, plain.sum_logprob, atol=1e-4, rtol=0)


def test_prompted_is_padding_invariant(weights, states4, suppress):
    """A row decodes to the same tokens alone and left-padded in a batch
    whose prompts are longer (the padding is invisible)."""
    _, params = weights
    sot = tuple(ST.sot_sequence())
    kw = dict(sot_len=len(sot), max_new_tokens=MAX_NEW, suppress_mask=torch.from_numpy(suppress),
              space_blank_id=32)
    x = torch.from_numpy(states4)
    rows, lens = decode.build_prompt_rows(HISTORIES, sot, ST, 6)
    batch = decode.prompted_greedy_decode(params, CFG, x, rows, lens, **kw)
    for i, hist in enumerate(HISTORIES):
        r1, l1 = decode.build_prompt_rows([hist], sot, ST, len(hist))
        alone = decode.prompted_greedy_decode(params, CFG, x[i : i + 1], r1, l1, **kw)
        assert torch.equal(alone.tokens[0], batch.tokens[i]), i


def test_top_k_lower_index_matches_lax_top_k():
    x = np.array([[1.0, 3.0, 3.0, -np.inf, 3.0, 0.5, -np.inf, -np.inf],
                  [-np.inf] * 6 + [2.0, 2.0]], np.float32)
    for k in (1, 3, 5):
        vals, idx = decode._top_k_lower_index(torch.from_numpy(x), k)
        jvals, jidx = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


# a covering set: every K, patience, length penalty, prompt and cache kind
BEAM_CASES = {
    "k1": dict(beam_size=1),
    "k2": dict(beam_size=2),
    "k5-patience2": dict(beam_size=5, patience=2.0),
    "k2-lp1-int4": dict(beam_size=2, length_penalty=1.0, **CACHES["int4"]),
    "k5-int8": dict(beam_size=5, **CACHES["int8"]),
    "k2-patience2-int8kernel": dict(beam_size=2, patience=2.0, **CACHES["int8-kernel"]),
    "k5-lp1-prompted-int4": dict(beam_size=5, length_penalty=1.0, prompted=True, **CACHES["int4"]),
    "k2-prompted": dict(beam_size=2, prompted=True),
    "k1-prompted-int8kernel": dict(beam_size=1, prompted=True, **CACHES["int8-kernel"]),
}


@pytest.mark.parametrize("case", list(BEAM_CASES))
def test_beam_decode_token_exact(weights, states4, narrow, case):
    jparams, params = weights
    kw = dict(BEAM_CASES[case])
    sot = tuple(ST.sot_sequence())
    jkw, okw = {}, {}
    if kw.pop("prompted", False):
        rows, lens = decode.build_prompt_rows(HISTORIES, sot, ST, 4)
        jkw = dict(prompt_tokens=jnp.asarray(rows), prompt_lens=jnp.asarray(lens))
        okw = dict(prompt_tokens=rows, prompt_lens=lens)
    common = dict(sot_sequence=sot, max_new_tokens=MAX_NEW, space_blank_id=32, **kw)
    ref = jdecode.beam_decode(
        jparams, JCFG, jnp.asarray(states4), suppress_mask=jnp.asarray(narrow), **common, **jkw,
    )
    ours = decode.beam_decode(
        params, CFG, torch.from_numpy(states4), suppress_mask=torch.from_numpy(narrow),
        **common, **okw,
    )
    np.testing.assert_array_equal(ours.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(ours.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_allclose(ours.sum_logprob.numpy(), np.asarray(ref.sum_logprob), atol=1e-4)
    np.testing.assert_allclose(ours.no_speech_prob.numpy(), np.asarray(ref.no_speech_prob), atol=1e-5)


def test_beam_finished_sets_are_used(weights, states4, narrow):
    """The narrow vocabulary makes hypotheses end before the token cap, so
    the parity cases above run the finished-set and ranking paths."""
    _, params = weights
    out = decode.beam_decode(
        params, CFG, torch.from_numpy(states4), sot_sequence=tuple(ST.sot_sequence()),
        beam_size=5, max_new_tokens=MAX_NEW, suppress_mask=torch.from_numpy(narrow),
        space_blank_id=32,
    )
    assert (out.lengths < MAX_NEW).any()
