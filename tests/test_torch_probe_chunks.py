"""The time split of kernel B's design probes P1 and P2
(``csrc/cross_attn_probes.cu``), modelled on the CPU against their plain
versions (``ops/kernels/probe_attention.py``).

The kernels cut the packed time axis into chunks of columns, one block a
chunk, and a group's combining block adds the chunks in chunk order.  The models below follow that arithmetic in float32 (P2) and in
wrapping 32-bit integers (P1) at several chunk widths; the plain versions
are what the kernels are held to on the card, so the split must keep P2
within the card gates (5e-4 exact, 2e-3 bf16, integer units) and P1 bit for
bit.  Small shapes: B=2, H=2, Dh=64, Tpad=1536 (half=768) and 1664 (a last
chunk narrower than the others).
"""
import numpy as np
import pytest
import torch

from audio_processor_tpu_torch.ops.kernels import decode_attention as da
from audio_processor_tpu_torch.ops.kernels import probe_attention as pa

B, H, DH = 2, 2, 64


def _layer(seed, tpad=1536, layers=2):
    rng = np.random.default_rng(seed)
    k8 = rng.integers(-7, 8, (layers, B, H, DH, tpad)).astype(np.int8)
    v8 = rng.integers(-7, 8, (layers, B, H, tpad, DH)).astype(np.int8)
    k4, v4 = da.pack_int4_time(torch.from_numpy(k8), torch.from_numpy(v8))
    q = torch.from_numpy(rng.normal(size=(B, 1, H, DH)).astype(np.float32))
    return q, k4, v4


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _rows_model(q, k4_all, v4_all, layer, valid_len, chunk, bf16=False, exchange=None):
    """P2's arithmetic: per chunk holding a valid even column, the masked
    scores, the chunk's max (with ``exchange``, the row's global max, which
    the bf16 kernel's cluster exchanges; by default under bf16), exp, sum
    and the unshifted P.u (P rounded to bf16 first under bf16); then the
    combine in chunk order, sum e^(m_c - M) acc_c / sum e^(m_c - M) l_c - 8."""
    exchange = bf16 if exchange is None else exchange
    half = k4_all.shape[-1]
    n_even, n_odd = (valid_len + 1) // 2, valid_len // 2
    chunks = -(-n_even // chunk)
    qh = q.permute(0, 2, 1, 3)  # (B, H, 1, Dh)
    if bf16:
        qh = _bf16(qh)
    k_lo, k_hi = (x.float() - 8 for x in da._unpack_nibbles_u(k4_all[layer]))
    v_lo, v_hi = (x.float() for x in da._unpack_nibbles_u(v4_all[layer]))
    col = torch.arange(half)
    scale = 1.0 / np.sqrt(DH)
    scores = []
    for c in range(chunks):
        cs = slice(c * chunk, min((c + 1) * chunk, half))
        s_lo = (qh @ k_lo[..., cs]) * scale
        s_hi = (qh @ k_hi[..., cs]) * scale
        s_lo = s_lo.masked_fill(col[cs] >= n_even, -np.inf)
        s_hi = s_hi.masked_fill(col[cs] >= n_odd, -np.inf)
        scores.append((cs, s_lo, s_hi))
    row_max = torch.stack([torch.maximum(lo.amax(-1), hi.amax(-1)) for _, lo, hi in scores]).amax(0)
    parts = []
    for cs, s_lo, s_hi in scores:
        m = row_max if exchange else torch.maximum(s_lo.amax(-1), s_hi.amax(-1))
        p_lo, p_hi = torch.exp(s_lo - m[..., None]), torch.exp(s_hi - m[..., None])
        l = p_lo.sum(-1) + p_hi.sum(-1)
        if bf16:
            p_lo, p_hi = _bf16(p_lo), _bf16(p_hi)
        parts.append((m, l, p_lo @ v_lo[:, :, cs] + p_hi @ v_hi[:, :, cs]))
    big_m = torch.stack([m for m, _, _ in parts]).amax(0)
    num = sum(torch.exp(m - big_m)[..., None] * acc for m, _, acc in parts)
    den = sum(torch.exp(m - big_m) * l for m, l, _ in parts)
    return (num / den[..., None] - 8).permute(0, 2, 1, 3).contiguous()


def _stream_model(q, k4_all, v4_all, layer, chunk):
    """P1's arithmetic: each chunk's K and V bytes weighed as the JAX
    probe's int32 words weigh them, summed per (row, head, chunk) in 64-bit
    and cut to 32 bits; the chunks' sums added with 32-bit wrap; the heads'
    int32 sums added in order in float32."""
    k = k4_all[layer].to(torch.int64) & 0xFF  # (B, H, Dh, half)
    v = v4_all[layer].to(torch.int64) & 0xFF  # (B, H, half, Dh)
    half = k.shape[-1]
    wk = 256 ** (torch.arange(DH) % 4)
    total = torch.zeros((B, H), dtype=torch.int64)
    for c0 in range(0, half, chunk):
        cs = slice(c0, min(c0 + chunk, half))
        wv = 256 ** (torch.arange(half)[cs] % 4)
        part = (k[..., cs].sum(-1) * wk).sum(-1) + (v[:, :, cs].sum(-1) * wv).sum(-1)
        total = (total + (part & 0xFFFFFFFF)) & 0xFFFFFFFF
    s = torch.where(total >= 2**31, total - 2**32, total).to(torch.float32)
    acc = torch.zeros(B, dtype=torch.float32)
    for h in range(H):
        acc = acc + s[:, h]
    return acc[:, None, None, None].expand(q.shape).contiguous()


@pytest.mark.parametrize("chunk", [64, 128, 256])
@pytest.mark.parametrize("valid", [1, 129, 512, 700, 1500])
@pytest.mark.parametrize("bf16", [False, True])
def test_rows_time_split_matches_plain(chunk, valid, bf16):
    """valid_len 1 (one chunk), 129 (the halves end on different columns),
    512 (two whole chunks of 128), 700 (ends inside a chunk) and 1500."""
    q, k4, v4 = _layer(valid + chunk + bf16)
    got = _rows_model(q, k4, v4, 1, valid, chunk, bf16)
    want = pa.int4_rows_reference(q, k4, v4, 1, valid_len=valid, bf16=bf16)
    assert got.shape == want.shape == (B, 1, H, DH)
    assert (got - want).abs().max().item() <= (2e-3 if bf16 else 5e-4)


@pytest.mark.parametrize("chunk", [64, 128, 256])
@pytest.mark.parametrize("tpad", [1536, 1664])
def test_stream_time_split_is_bit_equal(chunk, tpad):
    """The checksum does not depend on how the chunks cut the time axis:
    bit-equal to the plain version, with a narrower last chunk at 1664."""
    q, k4, v4 = _layer(chunk + tpad, tpad=tpad)
    assert torch.equal(_stream_model(q, k4, v4, 1, chunk), pa.probe_stream_reference(q, k4, v4, 1))


def test_bf16_needs_the_row_max_before_rounding():
    """Rounding P to bf16 with each chunk's own max instead of the row's
    moves the result by more than the 2e-3 gate on some rows, which is why
    the bf16 kernel exchanges the chunks' maxima before exponentiating."""
    q, k4, v4 = _layer(3)
    q = q * 4  # peaked softmaxes: the chunks' maxima differ from the row's
    want = pa.int4_rows_reference(q, k4, v4, 1, valid_len=1500, bf16=True)
    exchanged = _rows_model(q, k4, v4, 1, 1500, 128, bf16=True)
    chunk_local = _rows_model(q, k4, v4, 1, 1500, 128, bf16=True, exchange=False)
    assert (exchanged - want).abs().max().item() <= 2e-3
    assert (chunk_local - want).abs().max().item() > 2e-3
