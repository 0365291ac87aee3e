"""The port's Whisper encoder and cached decoder against the JAX package's,
with the JAX weights carried across by ``convert.params_from_jax``.

Config: the JAX suite's genparity shape (tests/test_parity_generate.py).
Tolerances are the JAX suite's: encoder 2e-4, logits 3e-3.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from audio_processor_tpu.models.whisper import convert as jconvert
from audio_processor_tpu.models.whisper import decode as jdecode
from audio_processor_tpu.models.whisper import model as jmodel
from audio_processor_tpu.models.whisper.config import WhisperConfig as JConfig
from audio_processor_tpu.models.whisper.tokenizer import BPETokenizer
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


def jax_tree_from_seed(cfg, seed):
    """A JAX-layout parameter tree of random weights (the conv stem in
    HIO), drawn through the port's initialiser to skip jax.random's
    per-leaf compiles; biases and norms randomised so they count."""
    params = model.init_params(cfg, torch.Generator().manual_seed(seed))
    flat = convert._flatten(params)
    rng = np.random.default_rng(seed)
    out = {}
    for k, t in flat.items():
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
    jparams = jax_tree_from_seed(CFG, 3)
    return jparams, convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


@pytest.fixture(scope="module")
def mel():
    rng = np.random.default_rng(4)
    return rng.normal(0, 1, (2, CFG.n_mels, 2 * CFG.n_audio_ctx)).astype(np.float32)


def test_encode_matches_jax(weights, mel):
    jparams, params = weights
    ours = model.encode(params, CFG, torch.from_numpy(mel)).numpy()
    ref = np.asarray(jmodel.encode(jparams, JCFG, jnp.asarray(mel)))
    assert ours.shape == ref.shape == (2, CFG.n_audio_ctx, CFG.n_audio_state)
    np.testing.assert_allclose(ours, ref, atol=2e-4)


@pytest.mark.parametrize("cache_kind", ["float", "int4"])
def test_decoder_forward_cached_logits_match_jax(weights, cache_kind):
    """Prefill of 3 tokens, then one single-token step, same cache kind on
    both sides; logits at 3e-3."""
    jparams, params = weights
    rng = np.random.default_rng(5)
    states = rng.normal(0, 1, (2, CFG.n_audio_ctx, CFG.n_audio_state)).astype(np.float32)
    tokens = rng.integers(0, 900, (2, 4))
    kw = dict(quantize_cross_kv=True, kernel_layout=True, kv_bits=4) if cache_kind == "int4" else {}
    jcache = jdecode.init_cache(jparams, JCFG, jnp.asarray(states), 8, **kw)
    cache = decode.init_cache(params, CFG, torch.from_numpy(states), 8, **kw)
    okw = dict(kernel_layout=True) if cache_kind == "int4" else {}
    jkw = dict(kv_bits=4, **okw) if cache_kind == "int4" else {}
    jl, jcache = jdecode.decoder_forward_cached(
        jparams, JCFG, jnp.asarray(tokens[:, :3], jnp.int32), jcache, jnp.int32(0), **jkw
    )
    ol, cache = decode.decoder_forward_cached(
        params, CFG, torch.from_numpy(tokens[:, :3]), cache, 0, **okw
    )
    np.testing.assert_allclose(ol.numpy(), np.asarray(jl), atol=3e-3)
    jl, _ = jdecode.decoder_forward_cached(
        jparams, JCFG, jnp.asarray(tokens[:, 3:], jnp.int32), jcache, jnp.int32(3), **jkw
    )
    ol, _ = decode.decoder_forward_cached(
        params, CFG, torch.from_numpy(tokens[:, 3:]), cache, 3, **okw
    )
    assert ol.shape == (2, 1, CFG.n_vocab) and ol.dtype == torch.float32
    np.testing.assert_allclose(ol.numpy(), np.asarray(jl), atol=3e-3)


def test_conv_bias_keeps_compute_dtype(weights):
    """An f32 conv bias must not promote bf16 activations back to f32."""
    _, params = weights
    mel = torch.zeros((1, CFG.n_mels, 2 * CFG.n_audio_ctx))
    states = model.encode(params, CFG, mel, compute_dtype=torch.bfloat16)
    assert states.dtype == torch.bfloat16


def test_params_from_jax_layouts(weights):
    jparams, params = weights
    jw = np.asarray(jparams["encoder"]["conv1"]["w"])  # (width, C_in, C_out)
    assert params["encoder"]["conv1"]["w"].shape == (CFG.n_audio_state, CFG.n_mels, 3)
    np.testing.assert_array_equal(params["encoder"]["conv1"]["w"].numpy(), jw.transpose(2, 1, 0))
    jq = np.asarray(jparams["decoder"]["blocks"]["attn"]["q"]["w"])  # stacked (L, d_in, d_out)
    np.testing.assert_array_equal(params["decoder"]["blocks"]["attn"]["q"]["w"].numpy(), jq)


def test_init_params_has_the_jax_tree_shapes(weights):
    jparams, _ = weights
    ours = model.init_params(CFG, torch.Generator().manual_seed(0))
    flat_j = jconvert._flatten(jparams)
    flat_o = convert._flatten(ours)
    assert set(flat_j) == set(flat_o)
    for k, a in flat_j.items():
        shape = a.shape[::-1] if k in convert._CONV_KEYS else a.shape
        assert tuple(flat_o[k].shape) == tuple(shape), k


def test_load_params_reads_the_jax_npz(weights, tmp_path):
    jparams, params = weights
    cfg = dataclasses.replace(JCFG, alignment_heads=((1, 0), (1, 1)))
    tok = BPETokenizer({"a": 0, "b": 1, "ab": 2}, [("a", "b")])
    path = str(tmp_path / "w.npz")
    jconvert.save_params(path, jparams, cfg, tokenizer=tok)
    loaded, lcfg = convert.load_params(path, "cpu")
    assert dataclasses.astuple(lcfg)[1:] == dataclasses.astuple(cfg)[1:]
    flat_l, flat_p = convert._flatten(loaded), convert._flatten(params)
    assert set(flat_l) == set(flat_p)
    for k in flat_p:
        assert torch.equal(flat_l[k], flat_p[k]), k
    ltok = convert.load_tokenizer(path)
    assert ltok.decode(ltok.encode("abba")) == "abba"


def test_special_tokens_match_jax():
    for n_vocab in (1024, 51864, 51865, 51866):
        ours = decode.SpecialTokens.for_config(dataclasses.replace(CFG, n_vocab=n_vocab))
        ref = jdecode.SpecialTokens.for_config(dataclasses.replace(JCFG, n_vocab=n_vocab))
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert ours.sot_sequence(language=3, task="translate") == ref.sot_sequence(
            language=3, task="translate"
        )
