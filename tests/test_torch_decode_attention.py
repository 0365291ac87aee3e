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


# ---------------------------------------------------------------------------
# kernel B's arithmetic (csrc/cross_attn_int4.cu), modelled on the CPU
# ---------------------------------------------------------------------------

TWO23 = np.float32(2.0**23)


def _byte_perm(x: np.ndarray, y: int, sel: int) -> np.ndarray:
    """CUDA's __byte_perm(x, y, sel) on uint32 arrays: result byte n is
    byte (sel >> 4n) & 7 of the eight bytes {x0..x3, y0..y3}."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + [np.uint32((y >> (8 * i)) & 0xFF)
                                                        for i in range(4)]
    out = np.zeros_like(x)
    for n in range(4):
        out |= src[(sel >> (4 * n)) & 7] << (8 * n)
    return out


def _magic(masked: np.ndarray, i: int) -> np.ndarray:
    """The kernel's nibble i of a 0x0F0F0F0F-masked word as a float:
    __byte_perm(masked, 0x4B000000, 0x7650 | i) read as float32."""
    return _byte_perm(masked, 0x4B000000, 0x7650 | i).view(np.float32)


def test_magic_number_conversion_every_nibble():
    """2^23 + u exactly for every nibble u and byte position, low and high
    nibbles alike; one subtraction gives u (V) or u - 8 (K) exactly."""
    u = np.arange(16, dtype=np.uint32)
    for i in range(4):
        for high in (False, True):
            # u in nibble position (i, high) of a word whose other nibbles are 15
            word = np.uint32(0xFFFFFFFF) & ~np.uint32(0xF << (8 * i + 4 * high)) | (u << (8 * i + 4 * high))
            masked = ((word >> 4) if high else word) & np.uint32(0x0F0F0F0F)
            f = _magic(masked.astype(np.uint32), i)
            assert f.dtype == np.float32
            np.testing.assert_array_equal(f, TWO23 + u.astype(np.float32))
            np.testing.assert_array_equal(f - TWO23, u.astype(np.float32))
            np.testing.assert_array_equal(f - (TWO23 + np.float32(8)), u.astype(np.float32) - 8)


def _nibbles_as_kernel(p8: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """(low, high) nibble values u of an int8 array through the kernel's
    word-wise masks and magic numbers (the last axis in 4-byte words)."""
    words = np.ascontiguousarray(p8.numpy()).view(np.uint32)
    lo = [_magic(words & np.uint32(0x0F0F0F0F), i) - TWO23 for i in range(4)]
    hi = [_magic((words >> 4) & np.uint32(0x0F0F0F0F), i) - TWO23 for i in range(4)]
    shape = p8.shape
    return (np.stack(lo, -1).reshape(shape), np.stack(hi, -1).reshape(shape))


CHUNK = da.INT4_CHUNK


def _chunked_kernel_model(q, k4, v4, valid_len):
    """Kernel B's algorithm in float32: per live chunk of CHUNK packed
    columns, the scores, a chunk-local softmax (max m, sum l) and the
    unshifted P.u; then the last block's combine in chunk order,
    out = sum e^(m_c - M) acc_c / sum e^(m_c - M) l_c - 8.  Chunks wholly
    past valid_len are not launched: every score there is masked."""
    b, tq, h, dh = q.shape
    half = k4.shape[-1]
    n_even, n_odd = (valid_len + 1) // 2, valid_len // 2
    chunks = -(-n_even // CHUNK)
    k_lo, k_hi = (torch.from_numpy(x) - 8 for x in _nibbles_as_kernel(k4))  # (B,H,Dh,half)
    v_lo, v_hi = (torch.from_numpy(x) for x in _nibbles_as_kernel(v4))      # (B,H,half,Dh)
    col = torch.arange(half)
    for c in range(chunks, half // CHUNK):  # never launched: nothing valid in them
        cols = col[c * CHUNK:(c + 1) * CHUNK]
        assert not (cols < n_even).any() and not (cols < n_odd).any()
    scale = 1.0 / np.sqrt(dh)
    parts = []
    for c in range(chunks):
        cs = slice(c * CHUNK, (c + 1) * CHUNK)
        s_lo = torch.einsum("bqhd,bhdj->bhqj", q, k_lo[..., cs]) * scale
        s_hi = torch.einsum("bqhd,bhdj->bhqj", q, k_hi[..., cs]) * scale
        s_lo = s_lo.masked_fill(col[cs] >= n_even, -np.inf)
        s_hi = s_hi.masked_fill(col[cs] >= n_odd, -np.inf)
        s = torch.cat([s_lo, s_hi], -1)
        m = s.amax(-1)  # finite: the chunk's first even column is valid
        p = torch.exp(s - m[..., None])
        acc = (torch.einsum("bhqj,bhjd->bhqd", p[..., :CHUNK], v_lo[:, :, cs])
               + torch.einsum("bhqj,bhjd->bhqd", p[..., CHUNK:], v_hi[:, :, cs]))
        parts.append((m, p.sum(-1), acc))
    big_m = torch.stack([m for m, _, _ in parts]).amax(0)
    num = sum(torch.exp(m - big_m)[..., None] * acc for m, _, acc in parts)
    den = sum(torch.exp(m - big_m) * l for m, l, _ in parts)
    return (num / den[..., None] - 8).permute(0, 2, 1, 3)  # (B, Tq, H, Dh)


@pytest.mark.parametrize("tq", [1, 4, 48])
@pytest.mark.parametrize("valid", [1, 127, 128, 129, 1500])
def test_chunked_kernel_model_matches_plain(valid, tq):
    """Whisper's Tpad=1536 (12 chunks of 64 packed columns) and Dh=64:
    valid_len 1 leaves 11 chunks wholly masked, 127-129 straddle the first
    chunk's edge (even and odd halves end apart), 1500 is whisper's; Tq 48
    is a prefill.  Within 5e-4 of the plain version (integer units)."""
    rng = np.random.default_rng(valid + 7 * tq)
    b, h, dh, tpad = 2, 2, 64, 1536
    k8 = rng.integers(-7, 8, (b, h, dh, tpad)).astype(np.int8)
    v8 = rng.integers(-7, 8, (b, h, tpad, dh)).astype(np.int8)
    k4, v4 = da.pack_int4_time(torch.from_numpy(k8), torch.from_numpy(v8))
    q = torch.from_numpy(rng.normal(0, 0.5, (b, tq, h, dh)).astype(np.float32))
    got = _chunked_kernel_model(q, k4, v4, valid)
    want = da.cross_attention_int4_reference(q, k4, v4, valid_len=valid)
    assert got.shape == want.shape == (b, tq, h, dh)
    assert (got - want).abs().max().item() <= 5e-4


def test_wrappers_reject_other_devices():
    q = torch.zeros((1, 1, H, DH), device="meta")
    k = torch.zeros((1, H, DH, TPAD), dtype=torch.int8, device="meta")
    v = torch.zeros((1, H, TPAD, DH), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        da.cross_attention_int8(q, k, v, valid_len=VALID)
    with pytest.raises(ValueError):
        da.cross_attention_int4(q, k[..., ::2], v[:, :, ::2], valid_len=VALID)
