"""The port's int8 options against the JAX package's, on the CPU: the int8
self-attention cache (``quantize_self_kv``) and int8 decoder weights
(``models/whisper/quantize.py``).

On the same weights and states, greedy, prompted and beam decoding must
agree with JAX token for token, with the int8 self cache, on int8 decoder
weights, and with both; the quantized weights equal JAX's byte for byte.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from audio_processor_tpu.models.whisper import decode as jdecode
from audio_processor_tpu.models.whisper import model as jmodel
from audio_processor_tpu.models.whisper import quantize as jquantize
from audio_processor_tpu_torch.models.whisper import convert, decode, model, quantize
from audio_processor_tpu_torch.runtime.device import set_full_fp32
from test_torch_decode import CACHES, CFG, HISTORIES, JCFG, MAX_NEW, ST, jax_tree_from_seed

set_full_fp32()


@pytest.fixture(scope="module")
def weights():
    jparams = jax_tree_from_seed(CFG, 7)
    return jparams, convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


@pytest.fixture(scope="module")
def int8_weights(weights):
    jparams, _ = weights
    jq = jquantize.quantize_decoder(jparams)
    return jq, convert.params_from_jax(jax.tree.map(np.asarray, jq), "cpu")


@pytest.fixture(scope="module")
def states4():
    return np.random.default_rng(13).normal(
        0, 1, (4, CFG.n_audio_ctx, CFG.n_audio_state)).astype(np.float32)


@pytest.fixture(scope="module")
def suppress():
    mask = np.zeros(CFG.n_vocab, bool)
    mask[decode.always_suppressed_specials(ST)] = True
    mask[[10, 11, 12]] = True
    return mask


@pytest.fixture(scope="module")
def narrow():
    mask = np.ones(CFG.n_vocab, bool)
    mask[[ST.eot] + list(range(5, 11))] = False
    mask[ST.timestamp_begin:] = False
    return mask


def test_quantize_decoder_equals_jax(weights, int8_weights):
    """w8 bytes equal, scales within 1e-7; the encoder and embeddings stay
    float, every decoder linear is {"w8", "scale"[, "b"]}."""
    _, params = weights
    jq, _ = int8_weights
    ours = quantize.quantize_decoder(params)
    ref = convert._flatten(jax.tree.map(np.asarray, jq))
    flat = convert._flatten(ours)
    assert flat.keys() == ref.keys()
    for key, t in flat.items():
        if key.endswith("/w8"):
            assert t.dtype == torch.int8
            np.testing.assert_array_equal(t.numpy(), ref[key])
        elif key.endswith("/scale") and "attn_ln" not in key and "mlp_ln" not in key:
            np.testing.assert_allclose(t.numpy(), ref[key], rtol=1e-7, atol=0)
    assert "w" in ours["encoder"]["blocks"]["fc1"] and "w8" in ours["decoder"]["blocks"]["fc1"]
    assert "b" not in ours["decoder"]["blocks"]["attn"]["k"]


@pytest.mark.parametrize("bias", [True, False])
def test_int8_linear_equals_jax(bias):
    rng = np.random.default_rng(3)
    p = {"w": rng.normal(0, 0.1, (3, 16, 24)).astype(np.float32)}
    if bias:
        p["b"] = rng.normal(0, 0.1, (3, 24)).astype(np.float32)
    x = rng.normal(0, 1, (2, 5, 16)).astype(np.float32)
    jq = jquantize.quantize_linear({k: jnp.asarray(v) for k, v in p.items()})
    q = quantize.quantize_linear({k: torch.from_numpy(v) for k, v in p.items()})
    for layer in range(3):
        ref = jmodel.linear({k: v[layer] for k, v in jq.items()}, jnp.asarray(x))
        ours = model.linear({k: v[layer] for k, v in q.items()}, torch.from_numpy(x))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)


def test_self_cache_int8_layout_equals_jax(weights, states4):
    jparams, params = weights
    jc = jdecode.init_cache(jparams, JCFG, jnp.asarray(states4), 5, quantize_self_kv=True)
    oc = decode.init_cache(params, CFG, torch.from_numpy(states4), 5, quantize_self_kv=True)
    L_, B_, T_, H_, D_ = jc.self_k.shape  # the port keeps the head-major layout
    assert oc.self_k.dtype == oc.self_v.dtype == torch.int8
    assert tuple(oc.self_k.shape) == (L_, B_, H_, T_, D_)
    assert tuple(oc.self_k_scale.shape) == (L_, B_, H_, T_, 1) == tuple(oc.self_v_scale.shape)
    assert decode.init_cache(params, CFG, torch.from_numpy(states4), 5).self_k_scale is None


def test_quantize_token_rounds_half_to_even():
    x = torch.tensor([63.5, -0.5, 127.0, 1.5]).reshape(1, 4)
    q, scale = decode._quantize_token(x)
    assert scale.item() == 1.0 and q.flatten().tolist() == [64, 0, 127, 2]


def _assert_same(ours, ref):
    np.testing.assert_array_equal(ours.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(ours.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_allclose(ours.no_speech_prob.numpy(), np.asarray(ref.no_speech_prob),
                               atol=1e-5)
    # a float32 sum over the decode's steps: 1e-4 or 1e-5 of its size
    np.testing.assert_allclose(ours.sum_logprob.numpy(), np.asarray(ref.sum_logprob),
                               atol=1e-4, rtol=1e-5)


# (weights, self cache, cross cache)
GREEDY_CASES = {
    "self8-float": ("float", True, "float"),
    "self8-int4": ("float", True, "int4"),
    "self8-int8kernel": ("float", True, "int8-kernel"),
    "w8-int4": ("int8", False, "int4"),
    "w8-float": ("int8", False, "float"),
    "w8-self8-int4": ("int8", True, "int4"),
}


def _params(case, weights, int8_weights):
    return int8_weights if GREEDY_CASES[case][0] == "int8" else weights


@pytest.mark.parametrize("case", list(GREEDY_CASES))
def test_greedy_token_exact(weights, int8_weights, states4, suppress, case):
    jparams, params = _params(case, weights, int8_weights)
    _, self8, cache = GREEDY_CASES[case]
    kw = dict(sot_sequence=tuple(ST.sot_sequence()), max_new_tokens=MAX_NEW, space_blank_id=32,
              quantize_self_kv=self8, **CACHES[cache])
    ref = jdecode.greedy_decode(jparams, JCFG, jnp.asarray(states4),
                                suppress_mask=jnp.asarray(suppress), **kw)
    ours = decode.greedy_decode(params, CFG, torch.from_numpy(states4),
                                suppress_mask=torch.from_numpy(suppress), **kw)
    _assert_same(ours, ref)
    assert (ours.lengths > 0).any()


@pytest.mark.parametrize("case", ["self8-int4", "w8-self8-int4"])
def test_prompted_token_exact(weights, int8_weights, states4, suppress, case):
    jparams, params = _params(case, weights, int8_weights)
    _, self8, cache = GREEDY_CASES[case]
    rows, lens = decode.build_prompt_rows(HISTORIES, tuple(ST.sot_sequence()), ST, 4)
    kw = dict(sot_len=len(ST.sot_sequence()), max_new_tokens=MAX_NEW, space_blank_id=32,
              quantize_self_kv=self8, **CACHES[cache])
    ref = jdecode.prompted_greedy_decode(
        jparams, JCFG, jnp.asarray(states4), jnp.asarray(rows), jnp.asarray(lens),
        suppress_mask=jnp.asarray(suppress), **kw)
    ours = decode.prompted_greedy_decode(params, CFG, torch.from_numpy(states4), rows, lens,
                                         suppress_mask=torch.from_numpy(suppress), **kw)
    _assert_same(ours, ref)


BEAM_CASES = {
    "k2-self8": dict(beam_size=2, self8=True),
    "k5-self8-int4-prompted": dict(beam_size=5, self8=True, prompted=True, **CACHES["int4"]),
    "k3-w8-int4": dict(beam_size=3, w8=True, **CACHES["int4"]),
    "k2-w8-self8-patience2": dict(beam_size=2, w8=True, self8=True, patience=2.0),
}


@pytest.mark.parametrize("case", list(BEAM_CASES))
def test_beam_token_exact(weights, int8_weights, states4, narrow, case):
    """Beams reorder the int8 self cache with its scales."""
    kw = dict(BEAM_CASES[case])
    jparams, params = int8_weights if kw.pop("w8", False) else weights
    kw["quantize_self_kv"] = kw.pop("self8", False)
    sot = tuple(ST.sot_sequence())
    jkw, okw = {}, {}
    if kw.pop("prompted", False):
        rows, lens = decode.build_prompt_rows(HISTORIES, sot, ST, 4)
        jkw = dict(prompt_tokens=jnp.asarray(rows), prompt_lens=jnp.asarray(lens))
        okw = dict(prompt_tokens=rows, prompt_lens=lens)
    common = dict(sot_sequence=sot, max_new_tokens=MAX_NEW, space_blank_id=32, **kw)
    ref = jdecode.beam_decode(jparams, JCFG, jnp.asarray(states4),
                              suppress_mask=jnp.asarray(narrow), **common, **jkw)
    ours = decode.beam_decode(params, CFG, torch.from_numpy(states4),
                              suppress_mask=torch.from_numpy(narrow), **common, **okw)
    _assert_same(ours, ref)
    assert (ours.lengths < MAX_NEW).any()


def test_detect_language_on_int8_weights_equals_jax(int8_weights, states4):
    jparams, params = int8_weights
    _, jprobs = jdecode.detect_language(jparams, JCFG, jnp.asarray(states4))
    _, probs = decode.detect_language(params, CFG, torch.from_numpy(states4))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-5)
