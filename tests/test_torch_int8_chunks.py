"""The time split of kernel #3, the int8 cross-attention
(``csrc/cross_attn_int8.cu``), modelled on the CPU against its plain version
(``ops/kernels/decode_attention.py``) and the JAX kernel.

The kernel turns each cache byte into a float without an int-to-float
instruction (XOR 0x80 gives u = x + 128, the byte becomes the mantissa's low
byte of 2^23, one subtraction of 2^23 + 128 gives x), cuts the time axis
into fixed chunks, one block a chunk, and the last block of a (row, head)
combines the chunks' (max, sum, P.x) in chunk order.  The model below
follows that arithmetic in float32 at two chunk widths; the card holds the
kernel to the plain version within 1e-3 in integer units, so the split must
keep the model there too.  Small shapes: B=2, H=2, Dh=64, Tpad=1536.  The
wrapper's refusals are checked here on CPU tensors, and every caller's
cache is shown to fit them.
"""
import functools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_processor_tpu.ops.pallas import decode_attention as jda
from audio_processor_tpu_torch.models.whisper import decode, model
from audio_processor_tpu_torch.models.whisper.config import WhisperConfig
from audio_processor_tpu_torch.ops.kernels import decode_attention as da

B, H, DH, TPAD = 2, 2, 64, 1536
TOL = 1e-3  # the card gate, integer units
MAGIC = np.float32(2**23 + 128)


def _bytes_as_kernel(x8: np.ndarray) -> np.ndarray:
    """int8 values through the kernel's conversion, word by word along the
    last axis: XOR 0x80808080, byte i into the low byte of 0x4B000000 (the
    float 2^23 + u), minus 2^23 + 128."""
    words = np.ascontiguousarray(x8).view(np.uint32) ^ np.uint32(0x80808080)
    parts = [(((words >> np.uint32(8 * i)) & np.uint32(0xFF)) | np.uint32(0x4B000000)).view(np.float32)
             - MAGIC for i in range(4)]
    return np.stack(parts, -1).reshape(x8.shape)


def _chunked_model(q, k8t, v8, valid_len, chunk):
    """Kernel #3's algorithm in float32: per launched chunk of ``chunk``
    time positions (those holding a valid one), the scores (q.x) * 1/sqrt(Dh)
    masked past valid_len, the chunk's max m, p = e^(s - m), its sum l and
    P.x; then the last block's combine in chunk order,
    out = sum e^(m_c - M) acc_c / sum e^(m_c - M) l_c."""
    b, tq, h, dh = q.shape
    k = torch.from_numpy(_bytes_as_kernel(k8t.numpy()))  # (B, H, Dh, Tpad)
    v = torch.from_numpy(_bytes_as_kernel(v8.numpy()))   # (B, H, Tpad, Dh)
    tpad = k.shape[-1]
    pos = torch.arange(tpad)
    chunks = -(-valid_len // chunk)
    for c in range(tpad // chunk):  # launched exactly when it holds a valid position
        assert (c < chunks) == bool((pos[c * chunk:(c + 1) * chunk] < valid_len).any())
    scale = np.float32(1.0 / np.sqrt(dh))
    qh = q.permute(0, 2, 1, 3)  # (B, H, Tq, Dh)
    parts = []
    for c in range(chunks):
        cs = slice(c * chunk, (c + 1) * chunk)
        s = (qh @ k[..., cs]) * scale
        s = s.masked_fill(pos[cs] >= valid_len, -np.inf)
        m = s.amax(-1)  # finite: the chunk's first position is valid
        p = torch.exp(s - m[..., None])
        parts.append((m, p.sum(-1), p @ v[:, :, cs]))
    big_m = torch.stack([m for m, _, _ in parts]).amax(0)
    num, den = 0.0, 0.0
    for m, l, acc in parts:  # chunk order
        w = torch.exp(m - big_m)
        num = num + w[..., None] * acc
        den = den + w * l
    return (num / den[..., None]).permute(0, 2, 1, 3)


def _inputs(seed, tq, *, extremes=False, q_scale=0.02):
    rng = np.random.default_rng(seed)
    if extremes:
        ext = np.array([-128, -127, 127], dtype=np.int8)
        k8 = ext[rng.integers(0, 3, (B, H, DH, TPAD))]
        v8 = ext[rng.integers(0, 3, (B, H, TPAD, DH))]
    else:
        k8 = rng.integers(-128, 128, (B, H, DH, TPAD)).astype(np.int8)
        v8 = rng.integers(-128, 128, (B, H, TPAD, DH)).astype(np.int8)
    q = (rng.normal(0, 1, (B, tq, H, DH)) * q_scale).astype(np.float32)
    return q, k8, v8


@functools.lru_cache(maxsize=None)
def _case(valid, tq):
    """Seeded inputs and the JAX kernel's output in interpret mode (one
    compile a (valid_len, Tq), shared by the chunk widths)."""
    q, k8, v8 = _inputs(1000 * tq + valid, tq)
    jax_out = np.asarray(jda.cross_attention_int8(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), valid_len=valid, interpret=True))
    return q, k8, v8, jax_out


def test_conversion_is_exact_for_every_byte():
    """Every int8 value at each of a word's four byte positions comes out
    as exactly that value, in float32, with no int-to-float step."""
    x = np.arange(-128, 128, dtype=np.int8)
    for i in range(4):
        words = np.zeros((256, 4), dtype=np.int8)
        words[:, i] = x
        words[:, (i + 1) % 4] = np.int8(-128)  # neighbours do not leak in
        got = _bytes_as_kernel(words)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got[:, i], x.astype(np.float32))
        np.testing.assert_array_equal(got[:, (i + 1) % 4], np.float32(-128))


@pytest.mark.parametrize("tq", [1, 4, 55])
@pytest.mark.parametrize("where", ["one", "edge", "past-edge", "whisper", "tpad"])
@pytest.mark.parametrize("chunk", [da.INT8_CHUNK, 2 * da.INT8_CHUNK])
def test_chunked_model_matches_plain_and_jax(chunk, where, tq):
    """valid_len 1 (one chunk, one key), the first chunk's edge and one past
    it, whisper's 1500 and every position of Tpad; a decode step, a 4-row
    prefill and 55 rows.  Within the card gate of the plain version and of
    the JAX kernel (interpret mode)."""
    valid = {"one": 1, "edge": chunk, "past-edge": chunk + 1, "whisper": 1500, "tpad": TPAD}[where]
    q, k8, v8, want_jax = _case(valid, tq)
    args = (torch.from_numpy(q), torch.from_numpy(k8), torch.from_numpy(v8))
    got = _chunked_model(*args, valid, chunk)
    want = da.cross_attention_int8_reference(*args, valid_len=valid)
    assert got.shape == want.shape == (B, tq, H, DH) and got.dtype == torch.float32
    assert (got - want).abs().max().item() <= TOL
    assert np.abs(got.numpy() - want_jax).max() <= TOL


@pytest.mark.parametrize("tq", [1, 4])
@pytest.mark.parametrize("chunk", [da.INT8_CHUNK, 2 * da.INT8_CHUNK])
def test_chunked_model_on_the_int8_extremes(chunk, tq):
    """A cache of only -128, -127 and 127, q large enough that each row's
    softmax is peaked (the chunks' maxima far apart): within the card gate
    of the plain version and of the JAX reference."""
    q, k8, v8 = _inputs(77 + tq + chunk, tq, extremes=True, q_scale=0.05)
    args = (torch.from_numpy(q), torch.from_numpy(k8), torch.from_numpy(v8))
    got = _chunked_model(*args, 1500, chunk)
    want = da.cross_attention_int8_reference(*args, valid_len=1500)
    want_jax = np.asarray(jda.cross_attention_int8_reference(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), valid_len=1500))
    assert (got - want).abs().max().item() <= TOL
    assert np.abs(got.numpy() - want_jax).max() <= TOL
    assert got.abs().max().item() > 100  # the extremes reach the output


def _refusal(label):
    """(q, k8t, v8, valid_len) that ``check_int8_kernel_args`` refuses."""
    def cache(dh, tpad):
        return (torch.zeros((2, 2, dh, tpad), dtype=torch.int8),
                torch.zeros((2, 2, tpad, dh), dtype=torch.int8))

    q = torch.zeros((2, 1, 2, 16))
    k8, v8 = cache(16, 128)
    flat = torch.zeros(2 * 2 * 16 * 128 + 16, dtype=torch.int8)
    offset = (-flat.data_ptr()) % 16 + 1  # one byte past a 16-byte boundary
    cases = {
        "v-transposed": lambda: (q, k8, v8.transpose(2, 3), 100),
        "valid-past-tpad": lambda: (q, k8, v8, 129),
        "valid-zero": lambda: (q, k8, v8, 0),
        "q-float64": lambda: (q.double(), k8, v8, 100),
        "q-not-contiguous": lambda: (torch.zeros((2, 1, 16, 2)).transpose(2, 3), k8, v8, 100),
        "k-uint8": lambda: (q, k8.view(torch.uint8), v8, 100),
        "v-shape": lambda: (q, k8, v8[:, :, :64], 50),
        "dh-24": lambda: (torch.zeros((2, 1, 2, 24)), *cache(24, 128), 100),
        "dh-4": lambda: (torch.zeros((2, 1, 2, 4)), *cache(4, 128), 100),
        "dh-512": lambda: (torch.zeros((2, 1, 2, 512)), *cache(512, 128), 100),
        "tpad-192": lambda: (q, *cache(16, 192), 100),
        "tpad-too-long": lambda: (q, *cache(16, da.INT8_MAX_TPAD + da.INT8_CHUNK), 100),
        "k-misaligned": lambda: (q, flat[offset:offset + k8.numel()].view(k8.shape), v8, 100),
    }
    return cases[label]()


@pytest.mark.parametrize("label", ["v-transposed", "valid-past-tpad", "valid-zero", "q-float64",
                                   "q-not-contiguous", "k-uint8", "v-shape", "dh-24", "dh-4",
                                   "dh-512", "tpad-192", "tpad-too-long", "k-misaligned"])
def test_kernel_args_refused(label):
    """What the kernel does not take raises ValueError before a launch."""
    q, k8, v8, valid = _refusal(label)
    with pytest.raises(ValueError):
        da.check_int8_kernel_args(q, k8, v8, valid)


SMALL = WhisperConfig(name="small-test", n_mels=80, n_audio_ctx=96, n_audio_state=64,
                      n_audio_head=2, n_audio_layer=1, n_vocab=1024, n_text_ctx=64,
                      n_text_state=64, n_text_head=2, n_text_layer=2)
CHECK = WhisperConfig(name="check", n_mels=80, n_audio_ctx=1500, n_audio_state=128,
                      n_audio_head=2, n_audio_layer=2, n_vocab=1024, n_text_ctx=64,
                      n_text_state=128, n_text_head=2, n_text_layer=2)


@pytest.mark.parametrize("cfg", [SMALL, CHECK], ids=["card-tests-small", "check-config"])
def test_every_caller_fits_the_kernel(cfg):
    """The decoder's int8 kernel-layout cache (``init_cache``, Tpad padded to
    a multiple of 128; Dh 32 and 64 here, whisper's 64) passes the
    kernel's checks layer by layer at the decoder's valid_len, as does
    whisper-small's probe shape (Dh 64, Tpad 1536)."""
    params = model.init_params(cfg, torch.Generator().manual_seed(0))
    states = torch.zeros((2, cfg.n_audio_ctx, cfg.n_audio_state))
    cache = decode.init_cache(params, cfg, states, 8, quantize_cross_kv=True,
                              kernel_layout=True, kv_bits=8)
    dh = cfg.n_text_state // cfg.n_text_head
    q = torch.zeros((2, 1, cfg.n_text_head, dh))
    for layer in range(cfg.n_text_layer):
        da.check_int8_kernel_args(q, cache.cross_k[layer], cache.cross_v[layer], cfg.n_audio_ctx)
    k8 = torch.zeros((2, 12, 64, 1536), dtype=torch.int8)
    da.check_int8_kernel_args(torch.zeros((2, 1, 12, 64)), k8, k8.transpose(2, 3).contiguous(), 1500)
