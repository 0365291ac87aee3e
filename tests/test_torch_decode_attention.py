"""The port's int4 cross-attention (kernel B's plain version and the cache
format) against the JAX package's.

Small shapes: L=2, H=2, Dh=16, Tpad=256.  B=8 exercises the JAX kernel's
bb=8 batch-blocked path, B=3 its per-row path; an odd valid_len covers the
uneven even/odd split.  Tolerance 2e-4, the JAX suite's for this kernel.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_processor_tpu.ops.pallas import decode_attention as jda
from audio_processor_tpu_torch.ops.kernels import decode_attention as da

L, H, DH, TPAD, VALID = 2, 2, 16, 256, 201


def _cache(rng, b):
    k8 = rng.integers(-7, 8, (L, b, H, DH, TPAD)).astype(np.int8)
    v8 = rng.integers(-7, 8, (L, b, H, TPAD, DH)).astype(np.int8)
    return k8, v8


def test_pack_int4_time_bytes_equal_jax(rng):
    k8, v8 = _cache(rng, 3)
    k4, v4 = da.pack_int4_time(torch.from_numpy(k8), torch.from_numpy(v8))
    jk4, jv4 = jda.pack_int4_time(jnp.asarray(k8), jnp.asarray(v8))
    assert k4.dtype == torch.int8 and k4.shape == (L, 3, H, DH, TPAD // 2)
    np.testing.assert_array_equal(k4.numpy(), np.asarray(jk4))
    np.testing.assert_array_equal(v4.numpy(), np.asarray(jv4))


def test_unpack_inverts_pack(rng):
    k8, v8 = _cache(rng, 2)
    k4, v4 = da.pack_int4_time(torch.from_numpy(k8), torch.from_numpy(v8))
    lo, hi = da._unpack_nibbles_u(k4)
    np.testing.assert_array_equal((lo - 8).numpy(), k8[..., 0::2])
    np.testing.assert_array_equal((hi - 8).numpy(), k8[..., 1::2])
    lo, hi = da._unpack_nibbles_u(v4)
    np.testing.assert_array_equal((lo - 8).numpy(), v8[..., 0::2, :])
    np.testing.assert_array_equal((hi - 8).numpy(), v8[..., 1::2, :])


@pytest.mark.parametrize("b,tq", [(8, 1), (8, 3), (3, 1), (3, 3)])
def test_stacked_plain_matches_jax_kernel_every_layer(b, tq):
    rng = np.random.default_rng(10 * b + tq)
    k8, v8 = _cache(rng, b)
    q = rng.normal(0, 0.5, (b, tq, H, DH)).astype(np.float32)
    k4, v4 = da.pack_int4_time(torch.from_numpy(k8), torch.from_numpy(v8))
    jk4, jv4 = jnp.asarray(k4.numpy()), jnp.asarray(v4.numpy())
    before = da.cross_attention_int4_stacked.launches
    for layer in range(L):
        ours = da.cross_attention_int4_stacked(
            torch.from_numpy(q), k4, v4, layer, valid_len=VALID
        ).numpy()
        kern = np.asarray(jda.cross_attention_int4_stacked(
            jnp.asarray(q), jk4, jv4, jnp.int32(layer), valid_len=VALID,
            interpret=True,
        ))
        ref = np.asarray(jda.cross_attention_int4_reference(
            jnp.asarray(q), jk4[layer], jv4[layer], valid_len=VALID
        ))
        assert ours.shape == (b, tq, H, DH) and ours.dtype == np.float32
        np.testing.assert_allclose(ours, kern, atol=2e-4)
        np.testing.assert_allclose(ours, ref, atol=2e-4)
    assert da.cross_attention_int4_stacked.launches == before  # CPU: no kernel


def test_reference_equals_float_attention_in_time_order(rng):
    """The de-interleaved int4 math equals plain attention over the same
    integers in original time order, masked past valid_len."""
    k8, v8 = _cache(rng, 2)
    q = rng.normal(0, 0.5, (2, 2, H, DH)).astype(np.float32)
    k4, v4 = da.pack_int4_time(torch.from_numpy(k8[0]), torch.from_numpy(v8[0]))
    got = da.cross_attention_int4_reference(
        torch.from_numpy(q), k4, v4, valid_len=VALID
    ).numpy()
    scores = np.einsum("bqhd,bhdt->bhqt", q, k8[0].astype(np.float32)) / np.sqrt(DH)
    scores[..., VALID:] = -1e30
    p = np.exp(scores - scores.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want = np.einsum("bhqt,bhtd->bqhd", p, v8[0].astype(np.float32))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("b,tq,valid", [(3, 1, VALID), (2, 3, TPAD)])
def test_int8_plain_matches_jax_kernel(b, tq, valid):
    """Kernel #3's plain version against the JAX int8 kernel (interpret)
    and its reference, on one layer of the int8 kernel layout."""
    rng = np.random.default_rng(20 + b)
    k8 = rng.integers(-127, 128, (b, H, DH, TPAD)).astype(np.int8)
    v8 = rng.integers(-127, 128, (b, H, TPAD, DH)).astype(np.int8)
    q = rng.normal(0, 0.02, (b, tq, H, DH)).astype(np.float32)
    before = da.cross_attention_int8.launches
    ours = da.cross_attention_int8(
        torch.from_numpy(q), torch.from_numpy(k8), torch.from_numpy(v8), valid_len=valid
    ).numpy()
    jargs = (jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8))
    kern = np.asarray(jda.cross_attention_int8(*jargs, valid_len=valid, interpret=True))
    ref = np.asarray(jda.cross_attention_int8_reference(*jargs, valid_len=valid))
    assert ours.shape == (b, tq, H, DH) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, kern, atol=2e-4)
    np.testing.assert_allclose(ours, ref, atol=2e-4)
    assert da.cross_attention_int8.launches == before  # CPU: no kernel


@pytest.mark.parametrize("b,tq", [(3, 1), (2, 4)])
def test_int4_single_layer_plain_matches_jax_kernel(b, tq):
    """Kernel #4 (kernel B's function on a single-layer cache) against the
    JAX ``cross_attention_int4`` in interpret mode."""
    rng = np.random.default_rng(30 + b)
    k8, v8 = _cache(rng, b)
    k4, v4 = da.pack_int4_time(torch.from_numpy(k8[0]), torch.from_numpy(v8[0]))
    q = rng.normal(0, 0.5, (b, tq, H, DH)).astype(np.float32)
    before = da.cross_attention_int4.launches
    ours = da.cross_attention_int4(torch.from_numpy(q), k4, v4, valid_len=VALID).numpy()
    kern = np.asarray(jda.cross_attention_int4(
        jnp.asarray(q), jnp.asarray(k4.numpy()), jnp.asarray(v4.numpy()),
        valid_len=VALID, interpret=True,
    ))
    np.testing.assert_allclose(ours, kern, atol=2e-4)
    assert da.cross_attention_int4.launches == before


def test_wrappers_reject_other_devices():
    q = torch.zeros((1, 1, H, DH), device="meta")
    k = torch.zeros((1, H, DH, TPAD), dtype=torch.int8, device="meta")
    v = torch.zeros((1, H, TPAD, DH), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        da.cross_attention_int8(q, k, v, valid_len=VALID)
    with pytest.raises(ValueError):
        da.cross_attention_int4(q, k[..., ::2], v[:, :, ::2], valid_len=VALID)
