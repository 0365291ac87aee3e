"""The port's CUDA kernels against their plain PyTorch versions, on the
card: A (log-mel, on Whisper's 30 s windows and the diarizer's 10 s and
6 s ones), B (int4 cross-attention, stacked and single-layer), #5
(kernel B on a model rank's heads), the int8 cross-attention and the
encoder self-attention; the C++ DTW of the word timestamps against its
numpy twin; and the paths that run them (greedy, int8-kernel greedy and
beam decodes, with the int8 self cache too, the bundled Diarizer) against
the CPU's results; and the mesh paths (word timestamps, int8 decoder
weights, the Diarizer and the service under ``APTPU_DISTRIBUTED=1``) on a
world of 2 gloo ranks sharing the card, each with its kernel launches.

CUDA kernels have no CPU mode, so every test here is marked ``cuda`` and
skips without a card.  This file imports neither jax nor the JAX package,
so it also runs where jax is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import math

import numpy as np
import pytest
import torch

from audio_processor_tpu_torch.models.whisper import decode, model
from audio_processor_tpu_torch.models.whisper.config import WhisperConfig
from audio_processor_tpu_torch.ops import frontend
from audio_processor_tpu_torch.ops.kernels import decode_attention as da
from audio_processor_tpu_torch.ops.kernels import dtw
from audio_processor_tpu_torch.ops.kernels import encoder_attention as ea
from audio_processor_tpu_torch.ops.kernels.log_mel import log_mel
from audio_processor_tpu_torch.parallel.mesh import Mesh, split_bounds
from audio_processor_tpu_torch.runtime.device import set_full_fp32

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    set_full_fp32()
    return torch.device("cuda")


@pytest.mark.parametrize("n_mels,n_samples", [(80, 480_000), (128, 480_000), (80, 16_000 * 7 + 123)])
def test_log_mel_kernel_matches_plain(dev, n_mels, n_samples):
    g = torch.Generator(device=dev).manual_seed(n_mels)
    audio = torch.randn(3, n_samples, device=dev, generator=g) * 0.2
    audio[1] *= 1e-3  # a quiet window: the clamp and log must still agree
    before = log_mel.launches
    out = log_mel(audio, n_mels)
    torch.cuda.synchronize()
    assert log_mel.launches == before + 1
    ref = frontend.log_mel_spectrogram(audio, n_mels)
    assert out.shape == ref.shape == (3, n_mels, n_samples // 160)
    assert (out - ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_kernel_matches_plain_at_bench_batch(dev, n_mels):
    """B=128 windows (the bench's batch and the default slab): 12,000
    32-frame items walked by one persistent CTA an SM."""
    g = torch.Generator(device=dev).manual_seed(128 + n_mels)
    audio = torch.randn(128, frontend.N_SAMPLES, device=dev, generator=g) * 0.2
    audio[::7] *= 1e-3  # quiet windows among loud ones
    before = log_mel.launches
    out = log_mel(audio, n_mels)
    torch.cuda.synchronize()
    assert log_mel.launches == before + 1
    ref = frontend.log_mel_spectrogram(audio, n_mels)
    assert out.shape == ref.shape == (128, n_mels, frontend.N_FRAMES)
    assert (out - ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("n_samples", [160_000, 96_000])
def test_log_mel_kernel_at_diarization_windows(dev, n_samples):
    """The segmentation net's windows: 10 s (the published config) and 6 s
    (the bundled checkpoint), one row all zeros as a zero-padded slab row
    is (every bin at the floor, the peak-8 clamp a no-op)."""
    g = torch.Generator(device=dev).manual_seed(n_samples)
    audio = torch.randn(2, n_samples, device=dev, generator=g) * 0.2
    audio[1] = 0.0
    before = log_mel.launches
    out = log_mel(audio, 80)
    torch.cuda.synchronize()
    assert log_mel.launches == before + 1
    ref = frontend.log_mel_spectrogram(audio, 80)
    assert out.shape == ref.shape == (2, 80, n_samples // 160)
    assert (out - ref).abs().max().item() <= 1e-4
    assert torch.all(out[1] == -1.5)


def test_diarizer_on_card_matches_cpu(dev, monkeypatch):
    """The bundled Diarizer on the card against the CPU's plain path, with
    the embedding convs in float32: equal turns on a 20 s 3-speaker
    meeting, kernel A launched once a slab."""
    import functools

    from audio_processor_tpu_torch.models.diarization import embedding as emb
    from audio_processor_tpu_torch.models.diarization.checkpoint import synth_voice
    from audio_processor_tpu_torch.pipeline.diarize import Diarizer

    monkeypatch.setattr(emb, "embed_crops",
                        functools.partial(emb.embed_crops, compute_dtype=torch.float32))
    rng = np.random.default_rng(13579)
    audio = rng.normal(0, 0.003, 20 * 16_000).astype(np.float32)
    t, i = 0.3, 0
    while t < 18.0:
        dur = float(rng.uniform(1.2, 2.0))
        a, b = int(t * 16_000), int(min(t + dur, 20.0) * 16_000)
        audio[a:b] += synth_voice(rng, (110.0, 220.0, 350.0)[i % 3], b - a, 16_000)
        t += dur + float(rng.uniform(0.3, 0.6))
        i += 1
    cpu = Diarizer.bundled(window_step_s=2.0, device="cpu")
    card = Diarizer.bundled(window_step_s=2.0, device=dev)
    windows = card._windows(audio)[0]
    before = log_mel.launches
    probs = card._segment_all(windows)
    assert log_mel.launches == before + 1
    assert np.abs(probs - cpu._segment_all(windows)).max() <= 1e-4
    turns = card.diarize(audio)
    assert turns and turns == cpu.diarize(audio)


def test_rewritten_kernels_still_reject_bad_inputs(dev):
    """The wrappers of the redesigned kernels refuse what they refused
    before, and launch nothing for it."""
    before = (log_mel.launches, ea.fused_self_attention.launches)
    for bad in (torch.zeros((2, 480_000), device=dev)[:, ::2],  # not contiguous
                torch.zeros(480_000, device=dev),                 # not (B, n_samples)
                torch.zeros((2, 150), device=dev)):               # too short to frame
        with pytest.raises(ValueError):
            log_mel(bad)
    x = torch.zeros((1, 8, 2, 64), device=dev, dtype=torch.bfloat16)
    wide = torch.zeros((1, 8, 2, 68), device=dev, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError):  # row stride of 68 elements: not 16-byte units
        ea.fused_self_attention(wide, x, x)
    gapped = torch.zeros((1, 8, 2, 128), device=dev, dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError):  # the head axis is not contiguous
        ea.fused_self_attention(gapped, x, x)
    with pytest.raises(ValueError):  # k of another shape
        ea.fused_self_attention(x, x[:, :4], x)
    assert (log_mel.launches, ea.fused_self_attention.launches) == before


@pytest.mark.parametrize("b,tq,h,dh,tpad,valid", [
    (3, 1, 2, 16, 256, 201), (3, 3, 2, 16, 256, 201), (8, 4, 12, 64, 1536, 1500),
    # kernel B's 64-column chunks at whisper's widths: valid_len 1 leaves 11
    # of 12 chunks wholly masked, 127-129 straddle the first chunk's edge;
    # Tq 48 is a prefill; B=1 one block column a head
    *[(2, tq, 12, 64, 1536, valid) for valid in (1, 127, 128, 129, 1500) for tq in (1, 4, 48)],
    (1, 1, 12, 64, 1536, 1500), (1, 48, 12, 64, 1536, 129),
])
def test_cross_attention_kernel_matches_plain(dev, b, tq, h, dh, tpad, valid):
    g = torch.Generator(device=dev).manual_seed(b * tq + valid)
    n_layers = 3
    k8 = torch.randint(-7, 8, (n_layers, b, h, dh, tpad), device=dev, generator=g, dtype=torch.int8)
    v8 = torch.randint(-7, 8, (n_layers, b, h, tpad, dh), device=dev, generator=g, dtype=torch.int8)
    k4, v4 = da.pack_int4_time(k8, v8)
    q = torch.randn(b, tq, h, dh, device=dev, generator=g) * 0.1
    for layer in range(n_layers):
        before = da.cross_attention_int4_stacked.launches
        out = da.cross_attention_int4_stacked(q, k4, v4, layer, valid_len=valid)
        torch.cuda.synchronize()
        assert da.cross_attention_int4_stacked.launches == before + 1
        ref = da.cross_attention_int4_reference(q, k4[layer], v4[layer], valid_len=valid)
        # integer-unit outputs (|x| <= 7); sums over Tpad keys in another order
        assert (out - ref).abs().max().item() <= 5e-4


def _int4_case(dev, seed, b, tq, h, valid, n_layers=2, dh=64, tpad=1536):
    g = torch.Generator(device=dev).manual_seed(seed)
    k8 = torch.randint(-7, 8, (n_layers, b, h, dh, tpad), device=dev, generator=g, dtype=torch.int8)
    v8 = torch.randint(-7, 8, (n_layers, b, h, tpad, dh), device=dev, generator=g, dtype=torch.int8)
    k4, v4 = da.pack_int4_time(k8, v8)
    return torch.randn(b, tq, h, dh, device=dev, generator=g) * 0.1, k4, v4, valid


def test_int4_kernel_counters_reset_between_calls(dev):
    """Kernel B's last-block combine takes tickets from per-(row, head)
    counters and puts them back to 0: calls of other shapes (other grids,
    chunk counts and counters) in turn give bit-equal outputs on a repeat."""
    cases = [_int4_case(dev, 1, 8, 1, 12, 1500), _int4_case(dev, 2, 3, 4, 6, 129),
             _int4_case(dev, 3, 5, 48, 12, 700)]
    call = lambda q, k4, v4, valid: da.cross_attention_int4_stacked(q, k4, v4, 1, valid_len=valid)
    first = [call(*c) for c in cases]
    again = [call(*c) for c in reversed(cases)][::-1]
    torch.cuda.synchronize()
    for a, b, (q, k4, v4, valid) in zip(first, again, cases):
        assert torch.equal(a, b)
        ref = da.cross_attention_int4_reference(q, k4[1], v4[1], valid_len=valid)
        assert (a - ref).abs().max().item() <= 5e-4


def test_int4_kernel_converts_nibbles_without_int_to_float(dev):
    """The built kernel B library holds no I2F instruction: nibbles become
    floats through the 2^23 magic number (cuobjdump -sass of the library)."""
    import os
    import shutil
    import subprocess

    from audio_processor_tpu_torch.ops.kernels import build

    tool = next((p for p in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump")
                 if p and os.path.exists(p)), None)
    if tool is None:
        pytest.skip("cuobjdump is not installed beside nvcc")
    build.load("cross_attn_int4")
    sass = subprocess.run([tool, "-sass", str(build.library_path("cross_attn_int4"))],
                          capture_output=True, text=True, check=True).stdout
    assert "cross_attn_int4_kernel" in sass and "PRMT" in sass
    assert "I2F" not in sass


def test_cross_attention_wrapper_rejects_bad_inputs(dev):
    k4 = torch.zeros((1, 2, 2, 16, 128), dtype=torch.int8, device=dev)
    v4 = torch.zeros((1, 2, 2, 128, 16), dtype=torch.int8, device=dev)
    q = torch.zeros((2, 1, 2, 16), device=dev)
    with pytest.raises(ValueError):
        da.cross_attention_int4_stacked(q.bfloat16(), k4, v4, 0, valid_len=200)
    with pytest.raises(ValueError):
        da.cross_attention_int4_stacked(q, k4, v4, 1, valid_len=200)
    with pytest.raises(ValueError):
        da.cross_attention_int4_stacked(q, k4.transpose(3, 4), v4, 0, valid_len=200)
    with pytest.raises(ValueError):  # Tpad/2 = 96: not whole 64-column chunks
        da.cross_attention_int4_stacked(q, k4[..., :96].contiguous(), v4[..., :96, :].contiguous(),
                                        0, valid_len=100)
    with pytest.raises(ValueError):
        log_mel(torch.zeros((2, 480_000), device=dev, dtype=torch.float64))


def test_resolve_device_keeps_float32_accumulation(dev):
    from audio_processor_tpu_torch.runtime.device import resolve_device

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    torch.backends.cuda.matmul.allow_tf32 = True
    assert resolve_device().type == "cuda"
    matmul = torch.backends.cuda.matmul
    assert not (matmul.allow_tf32 or torch.backends.cudnn.allow_tf32)
    assert not (matmul.allow_bf16_reduced_precision_reduction
                or matmul.allow_fp16_reduced_precision_reduction)


SMALL = WhisperConfig(name="small-test", n_mels=80, n_audio_ctx=96, n_audio_state=64,
                      n_audio_head=2, n_audio_layer=1, n_vocab=1024, n_text_ctx=64,
                      n_text_state=64, n_text_head=2, n_text_layer=2)


@pytest.mark.parametrize("kind,kw,counter", [
    ("greedy-int4", dict(quantize_cross_kv=True, kv_bits=4), da.cross_attention_int4_stacked),
    ("greedy-int8-kernel", dict(quantize_cross_kv=True, kv_bits=8, use_pallas_kernel=True),
     da.cross_attention_int8),
    ("beam3-int4", dict(beam_size=3, quantize_cross_kv=True, kv_bits=4),
     da.cross_attention_int4_stacked),
    ("beam2-int8-kernel", dict(beam_size=2, quantize_cross_kv=True, kv_bits=8,
                               use_pallas_kernel=True), da.cross_attention_int8),
    ("greedy-int4-self-int8", dict(quantize_cross_kv=True, kv_bits=4, quantize_self_kv=True),
     da.cross_attention_int4_stacked),
    ("beam3-int4-self-int8", dict(beam_size=3, quantize_cross_kv=True, kv_bits=4,
                                  quantize_self_kv=True), da.cross_attention_int4_stacked),
])
def test_decode_on_card_matches_cpu(dev, kind, kw, counter):
    """Float32 decodes on a small config: the card path (through the
    kernel named by ``counter``) gives the CPU path's tokens."""
    params = model.init_params(SMALL, torch.Generator().manual_seed(0))
    st = decode.SpecialTokens.for_config(SMALL)
    states = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (4, 96, 64)).astype(np.float32))
    fn = decode.beam_decode if "beam_size" in kw else decode.greedy_decode
    kw = dict(kw, sot_sequence=tuple(st.sot_sequence()), max_new_tokens=16)
    cpu = fn(params, SMALL, states, **kw)
    gpu_params = model.map_params(lambda t: t.to(dev), params)
    before = counter.launches
    gpu = fn(gpu_params, SMALL, states.to(dev), **kw)
    assert counter.launches > before
    assert torch.equal(gpu.tokens.cpu(), cpu.tokens)
    assert math.isclose(gpu.sum_logprob.sum().item(), cpu.sum_logprob.sum().item(), abs_tol=1e-2)


@pytest.mark.parametrize("b,tq,layer", [(128, 1, 0), (128, 4, 11), (8, 1, 3)])
def test_int8_cross_attention_kernel_matches_plain(dev, b, tq, layer):
    """Whisper-small's int8 kernel layout (H=12, Dh=64, Tpad=1536, 1500
    valid) read per layer in place; integer-unit outputs up to 127, f32
    sums over 1500 keys in another order than the plain version's."""
    g = torch.Generator(device=dev).manual_seed(b + tq)
    n_layers, h, dh, tpad, valid = 12, 12, 64, 1536, 1500
    k8 = torch.randint(-127, 128, (n_layers, b, h, dh, tpad), device=dev, generator=g,
                       dtype=torch.int8)
    v8 = torch.randint(-127, 128, (n_layers, b, h, tpad, dh), device=dev, generator=g,
                       dtype=torch.int8)
    q = torch.randn(b, tq, h, dh, device=dev, generator=g) * 0.02
    before = da.cross_attention_int8.launches
    out = da.cross_attention_int8(q, k8[layer], v8[layer], valid_len=valid)
    torch.cuda.synchronize()
    assert da.cross_attention_int8.launches == before + 1
    ref = da.cross_attention_int8_reference(q, k8[layer], v8[layer], valid_len=valid)
    assert (out - ref).abs().max().item() <= 1e-3


def test_int4_single_layer_kernel_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(4)
    b, h, dh, tpad, valid = 8, 12, 64, 1536, 1500
    k8 = torch.randint(-7, 8, (b, h, dh, tpad), device=dev, generator=g, dtype=torch.int8)
    v8 = torch.randint(-7, 8, (b, h, tpad, dh), device=dev, generator=g, dtype=torch.int8)
    k4, v4 = da.pack_int4_time(k8, v8)
    q = torch.randn(b, 1, h, dh, device=dev, generator=g) * 0.1
    before = da.cross_attention_int4.launches
    out = da.cross_attention_int4(q, k4, v4, valid_len=valid)
    torch.cuda.synchronize()
    assert da.cross_attention_int4.launches == before + 1
    ref = da.cross_attention_int4_reference(q, k4, v4, valid_len=valid)
    assert (out - ref).abs().max().item() <= 5e-4


@pytest.mark.parametrize("dtype,tol,t,h", [
    (torch.bfloat16, 4e-3, 1500, 12), (torch.float32, 1e-4, 1500, 12),
    (torch.bfloat16, 4e-3, 77, 2), (torch.float32, 1e-4, 77, 2),
])
def test_encoder_attention_kernel_matches_plain(dev, dtype, tol, t, h):
    """Whisper-small's encoder shape (B=8, T=1500, H=12, Dh=64), read from
    the split-heads views of one (B, T, 3*H*Dh) projection, and a short
    ragged T with 2 heads.  Both sides keep the scores in f32 and round the
    normalised P to bf16, so bf16 outputs (|x| up to ~0.3) differ by an
    output ulp or two: 4e-3; f32 at 1e-4."""
    g = torch.Generator(device=dev).manual_seed(t)
    b, dh = 8, 64
    qkv = torch.randn(b, t, 3 * h * dh, device=dev, generator=g).to(dtype)
    q, k, v = (x.reshape(b, t, h, dh) for x in qkv.split(h * dh, dim=-1))
    before = ea.fused_self_attention.launches
    out = ea.fused_self_attention(q, k, v)
    torch.cuda.synchronize()
    assert ea.fused_self_attention.launches == before + 1
    ref = ea.attention_reference(q, k, v)
    assert out.dtype == dtype and out.shape == ref.shape
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("split", [True, False], ids=["split-views", "contiguous"])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("t", [1, 127, 128, 129, 1500])
def test_encoder_attention_bf16_tiles_and_layouts(dev, t, b, split):
    """The bf16 kernel around its 128-row tiles (one key, one short of a
    tile, a whole tile, one past, whisper's 1500 = 11 tiles + 92) on the
    split-heads views of one (B, T, 3*H*Dh) projection and on contiguous
    (B, T, H, Dh) tensors: within 4e-3 of the reference."""
    g = torch.Generator(device=dev).manual_seed(1000 * b + t)
    h, dh = 12, 64
    if split:
        qkv = torch.randn(b, t, 3 * h * dh, device=dev, generator=g).bfloat16()
        q, k, v = (x.reshape(b, t, h, dh) for x in qkv.split(h * dh, dim=-1))
    else:
        q, k, v = (torch.randn(b, t, h, dh, device=dev, generator=g).bfloat16() for _ in range(3))
    before = ea.fused_self_attention.launches
    out = ea.fused_self_attention(q, k, v)
    torch.cuda.synchronize()
    assert ea.fused_self_attention.launches == before + 1
    assert out.shape == (b, t, h, dh) and out.dtype == torch.bfloat16
    ref = ea.attention_reference(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() <= 4e-3


def test_encoder_attention_kernel_peak_memory(dev):
    """At the default slab (B=128, T=1500, H=12, Dh=64, bf16) one layer
    call allocates only its output: far below one layer's f32 scores
    (128 * 12 * 1500^2 * 4 B = 13.8 GB), which the plain path holds."""
    b, t, h, dh = 128, 1500, 12, 64
    q, k, v = (torch.randn(b, t, h, dh, device=dev, dtype=torch.bfloat16) for _ in range(3))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ea.fused_self_attention(q, k, v)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert extra <= b * t * h * dh * 2 + (1 << 20)
    assert torch.cuda.max_memory_allocated() < 13.8e9


def test_new_wrappers_reject_bad_inputs(dev):
    q = torch.zeros((2, 1, 2, 16), device=dev)
    k8 = torch.zeros((2, 2, 16, 128), dtype=torch.int8, device=dev)
    v8 = torch.zeros((2, 2, 128, 16), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        da.cross_attention_int8(q, k8, v8.transpose(2, 3), valid_len=100)
    with pytest.raises(ValueError):
        da.cross_attention_int8(q, k8, v8, valid_len=200)
    x = torch.zeros((1, 8, 2, 48), device=dev)
    with pytest.raises(ValueError):  # only 64-wide heads are instantiated
        ea.fused_self_attention(x, x, x)
    x32 = torch.zeros((1, 8, 2, 32), device=dev)
    with pytest.raises(ValueError):
        ea.fused_self_attention(x32, x32, x32)
    with pytest.raises(ValueError):
        ea.fused_self_attention(x.half(), x.half(), x.half())


@pytest.mark.parametrize("tp,b", [(2, 8), (3, 8), (4, 8), (2, 5), (3, 3)])
def test_tp_kernel_matches_plain_and_full_heads(dev, tp, b):
    """Kernel #5 on each emulated model rank's contiguous head slice of q and
    of the stacked cache (whisper-small's 12 heads; ragged batches too):
    within 5e-4 of its plain version, and the ranks' outputs concatenated
    along the heads equal kernel B's full-head output exactly (a (row,
    head)'s 64-column chunks and their combine order do not depend on the
    grid, so neither does its arithmetic)."""
    g = torch.Generator(device=dev).manual_seed(10 * tp + b)
    n_layers, h, dh, tpad, valid = 2, 12, 64, 1536, 1500
    k8 = torch.randint(-7, 8, (n_layers, b, h, dh, tpad), device=dev, generator=g, dtype=torch.int8)
    v8 = torch.randint(-7, 8, (n_layers, b, h, tpad, dh), device=dev, generator=g, dtype=torch.int8)
    k4, v4 = da.pack_int4_time(k8, v8)
    q = torch.randn(b, 1, h, dh, device=dev, generator=g) * 0.1
    for layer in range(n_layers):
        full = da.cross_attention_int4_stacked(q, k4, v4, layer, valid_len=valid)
        parts = []
        for r in range(tp):
            mesh = Mesh(dp=1, tp=tp, data_rank=0, model_rank=r, device=dev)
            lo, hi = split_bounds(h, mesh)
            ql = q[:, :, lo:hi].contiguous()
            kl, vl = k4[:, :, lo:hi].contiguous(), v4[:, :, lo:hi].contiguous()
            before = da.cross_attention_int4_stacked_tp.launches
            out = da.cross_attention_int4_stacked_tp(mesh, ql, kl, vl, layer, valid_len=valid,
                                                     n_head=h)
            torch.cuda.synchronize()
            assert da.cross_attention_int4_stacked_tp.launches == before + 1
            ref = da.cross_attention_int4_reference(ql, kl[layer], vl[layer], valid_len=valid)
            assert (out - ref).abs().max().item() <= 5e-4
            parts.append(out)
        assert torch.equal(torch.cat(parts, dim=2), full)


def test_tp_kernel_rejects_heads_that_do_not_shard(dev):
    mesh = Mesh(dp=1, tp=5, data_rank=0, model_rank=0, device=dev)
    k4 = torch.zeros((1, 2, 2, 16, 128), dtype=torch.int8, device=dev)
    v4 = torch.zeros((1, 2, 2, 128, 16), dtype=torch.int8, device=dev)
    q = torch.zeros((2, 1, 2, 16), device=dev)
    before = da.cross_attention_int4_stacked_tp.launches
    with pytest.raises(ValueError, match="heads do not shard"):
        da.cross_attention_int4_stacked_tp(mesh, q, k4, v4, 0, valid_len=200, n_head=12)
    with pytest.raises(ValueError, match="expected"):
        da.cross_attention_int4_stacked_tp(mesh, q, k4, v4, 0, valid_len=200, n_head=5)
    with pytest.raises(ValueError):  # kernel B's own checks: layer out of range
        da.cross_attention_int4_stacked_tp(mesh, q[:, :, :1].contiguous(), k4[:, :, :1].contiguous(),
                                           v4[:, :, :1].contiguous(), 1, valid_len=200, n_head=5)
    assert da.cross_attention_int4_stacked_tp.launches == before


# ---------------------------------------------------------------------------
# kernel B's design probes (csrc/cross_attn_probes.cu): P1 stream floor, P2
# int4_rows, P3 int8_dot, each against its plain version
# ---------------------------------------------------------------------------

def _probe_caches(dev, seed, b, valid, h=12, n_layers=2, tpad=1536):
    """Stacked int4 and int8 caches of the same ints (as the JAX probe #9
    builds them) and q (B, 1, H, 64)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    k8 = torch.randint(-7, 8, (n_layers, b, h, 64, tpad), device=dev, generator=g, dtype=torch.int8)
    v8 = torch.randint(-7, 8, (n_layers, b, h, tpad, 64), device=dev, generator=g, dtype=torch.int8)
    k4, v4 = da.pack_int4_time(k8, v8)
    return torch.randn(b, 1, h, 64, device=dev, generator=g), k4, v4, k8, v8


# (bb, unpack, joint, bf16): v3.1 and i4_bf16 at bb=1 (as their probes run
# them), every bb of ROW_BLOCKS with its rows in turn (a) and, past 1,
# jointly (b-e); exact variants are held to kernel B's 5e-4, bf16 to 2e-3
# (one bf16 rounding of P can flip where the card's expf and torch's differ
# by an ulp)
_INT4_ROWS_CASES = [(1, "byte", False, False), (1, "packed", False, True),
                    (1, "packed", False, False), (2, "packed", False, False),
                    (2, "packed", True, False), (4, "packed", False, False),
                    (4, "packed", True, False), (8, "packed", False, False),
                    (8, "packed", True, False)]
# valid lengths (P2 splits the packed time axis in chunks of 128 or 256
# columns): one time; 129 (65 even and 64 odd times: the halves end on
# different columns); inside a chunk (700: 350 of each); exactly on a chunk
# boundary (512: 256 of each, whole chunks); the JAX probes' 1500
_PROBE_VALID = (1, 129, 700, 512, 1500)


@pytest.mark.parametrize("b", [8, 64])
@pytest.mark.parametrize("bb,unpack,joint,bf16", _INT4_ROWS_CASES)
def test_int4_rows_kernel_matches_plain(dev, b, bb, unpack, joint, bf16):
    """P2 at every valid length of _PROBE_VALID within its gate; a call of
    another grid in between leaves the counters at 0, so a repeat is equal."""
    from audio_processor_tpu_torch.ops.kernels import probe_attention as pa

    for valid in _PROBE_VALID:
        q, k4, v4, _, _ = _probe_caches(dev, b + bb + valid, b, valid)
        before = pa.int4_rows.launches
        kw = dict(unpack=unpack, bb=bb, joint=joint, bf16=bf16)
        out = pa.int4_rows(q, k4, v4, 1, valid_len=valid, **kw)
        other = pa.int4_rows(q[:2].contiguous(), k4[:, :2].contiguous(), v4[:, :2].contiguous(), 0,
                             valid_len=1536 - valid, bf16=bf16)
        again = pa.int4_rows(q, k4, v4, 1, valid_len=valid, **kw)
        torch.cuda.synchronize()
        assert pa.int4_rows.launches == before + 3
        ref = pa.int4_rows_reference(q, k4, v4, 1, valid_len=valid, bf16=bf16)
        assert (out - ref).abs().max().item() <= (2e-3 if bf16 else 5e-4)
        assert torch.equal(again, out)
        ref = pa.int4_rows_reference(q[:2], k4[:, :2], v4[:, :2], 0, valid_len=1536 - valid,
                                     bf16=bf16)
        assert (other - ref).abs().max().item() <= (2e-3 if bf16 else 5e-4)


@pytest.mark.parametrize("b", [8, 64])
@pytest.mark.parametrize("bb,joint", [(1, False), (2, False), (2, True), (4, False), (4, True),
                                      (8, False), (8, True)])
def test_probe_stream_kernel_equals_plain(dev, b, bb, joint):
    """The stream floor's checksum is bit-equal to its plain version, and
    its counters are left at 0 (a repeat, after a call of another grid, is
    bit-equal too)."""
    from audio_processor_tpu_torch.ops.kernels import probe_attention as pa

    q, k4, v4, _, _ = _probe_caches(dev, b + bb, b, 1500)
    before = pa.probe_stream.launches
    out = pa.probe_stream(q, k4, v4, 1, bb=bb, joint=joint)
    other = pa.probe_stream(q[:4].contiguous(), k4[:, :4].contiguous(), v4[:, :4].contiguous(), 0)
    again = pa.probe_stream(q, k4, v4, 1, bb=bb, joint=joint)
    torch.cuda.synchronize()
    assert pa.probe_stream.launches == before + 3
    assert torch.equal(out, pa.probe_stream_reference(q, k4, v4, 1))
    assert torch.equal(again, out)
    assert torch.equal(other, pa.probe_stream_reference(q[:4], k4[:, :4], v4[:, :4], 0))


@pytest.mark.parametrize("b", [8, 64])
@pytest.mark.parametrize("cache,pv", [("int4", "int8"), ("int8", "int8"), ("int8", "f32")])
def test_int8_dot_kernel_matches_plain(dev, b, cache, pv):
    """q row-quantised to int8, dp4a products: within 2e-3 integer units of
    the plain version (a p8 rounding can flip on an ulp of expf)."""
    from audio_processor_tpu_torch.ops.kernels import probe_attention as pa

    for valid in (1500, 129):
        q, k4, v4, k8, v8 = _probe_caches(dev, 3 * b + valid, b, valid)
        kc, vc = (k4, v4) if cache == "int4" else (k8, v8)
        before = pa.int8_dot.launches
        out = pa.int8_dot(q, kc, vc, 1, valid_len=valid, cache=cache, pv=pv)
        torch.cuda.synchronize()
        assert pa.int8_dot.launches == before + 1
        ref = pa.int8_dot_reference(q, kc, vc, 1, valid_len=valid, cache=cache, pv=pv)
        assert (out - ref).abs().max().item() <= 2e-3


def test_probe_kernels_convert_with_int_to_float_only_in_the_byte_unpack(dev):
    """cuobjdump -sass of the probes' library: I2F appears in the byte-wise
    unpack's instantiation of int4_rows (v3.1) and in no other kernel."""
    import os
    import re
    import shutil
    import subprocess

    from audio_processor_tpu_torch.ops.kernels import build

    tool = next((p for p in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump")
                 if p and os.path.exists(p)), None)
    if tool is None:
        pytest.skip("cuobjdump is not installed beside nvcc")
    build.load("cross_attn_probes")
    sass = subprocess.run([tool, "-sass", str(build.library_path("cross_attn_probes"))],
                          capture_output=True, text=True, check=True).stdout
    counts = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name, body = part.split("\n", 1)
        counts[name.strip()] = sum("I2F" in ln for ln in body.splitlines())
    byte = [n for n in counts if "int4_rows_kernelILb1E" in n]
    assert len(counts) >= 19 and len(byte) == 1, sorted(counts)
    assert all(counts[n] > 0 for n in byte)
    assert not {n: c for n, c in counts.items() if c and n not in byte}


def test_probe_wrappers_reject_bad_inputs(dev):
    from audio_processor_tpu_torch.ops.kernels import probe_attention as pa

    q, k4, v4, k8, v8 = _probe_caches(dev, 5, 8, 1500, h=2)
    before = (pa.probe_stream.launches, pa.int4_rows.launches, pa.int8_dot.launches)
    with pytest.raises(ValueError):  # bb does not divide B
        pa.int4_rows(q[:6].contiguous(), k4[:, :6].contiguous(), v4[:, :6].contiguous(), 0,
                     valid_len=1500, bb=4)
    with pytest.raises(ValueError):  # not instantiated
        pa.int4_rows(q, k4, v4, 0, valid_len=1500, unpack="byte", bb=8)
    with pytest.raises(ValueError):  # Tq > 1
        pa.int8_dot(q.expand(8, 2, 2, 64).contiguous(), k4, v4, 0, valid_len=1500)
    with pytest.raises(ValueError):  # Dh 32
        pa.probe_stream(q[..., :32].contiguous(), k4[:, :, :, :32].contiguous(),
                        v4[..., :32].contiguous(), 0)
    with pytest.raises(ValueError):  # Tpad/2 = 96
        pa.int4_rows(q, k4[..., :96].contiguous(), v4[..., :96, :].contiguous(), 0,
                     valid_len=100)
    with pytest.raises(ValueError):  # the int8 cache past its length
        pa.int8_dot(q, k8, v8, 0, valid_len=1537, cache="int8")
    with pytest.raises(ValueError):
        pa.int8_dot(q, k4, v4, 0, valid_len=1500, cache="int4", pv="f32")
    assert (pa.probe_stream.launches, pa.int4_rows.launches, pa.int8_dot.launches) == before


@pytest.mark.parametrize("seed", [0, 1])
def test_dtw_native_equals_twin(dev, seed):
    """The C++ DTW (csrc/dtw.cu) gives the numpy twin's starts exactly: on
    tie plateaus, on a padded batch of rows of other sizes, and at the word
    path's shape (a slab of 8 rows of 229 x 1,500)."""
    rng = np.random.default_rng(seed)
    plateaus = (np.round(rng.uniform(0, 1, (6, 40, 300)) * 3) / 3).astype(np.float32)
    rows, frames = np.array([40, 3, 0, 17, 40, 1]), np.array([300, 5, 10, 299, 1, 300])
    full = rng.normal(size=(8, 229, 1500)).astype(np.float32)
    for cost, t, ta in ((plateaus, rows, frames), (full, 229, 1500)):
        before = dtw.dtw_native.launches
        got = dtw.dtw_starts(cost, t, ta, dev)
        assert dtw.dtw_native.launches == before + 1
        np.testing.assert_array_equal(got, dtw.dtw_wavefront(cost, t, ta))
    with pytest.raises(ValueError):
        dtw.dtw_native(plateaus, 41, 300)


# ---------------------------------------------------------------------------
# the mesh paths: a world of 2 gloo ranks sharing the card
# ---------------------------------------------------------------------------

_MESH_CFG = WhisperConfig(name="check", n_mels=80, n_audio_ctx=1500, n_audio_state=128,
                          n_audio_head=2, n_audio_layer=2, n_vocab=1024, n_text_ctx=64,
                          n_text_state=128, n_text_head=2, n_text_layer=2)


class _Letters:
    def encode(self, text):
        return list(text.encode("utf-8"))

    def decode(self, ids):
        return "".join(" " if int(i) % 5 == 0 else chr(97 + int(i) % 26) for i in ids)


def _speech(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16_000)) / 16_000
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.5 * t)
    sig = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 6))
    sig = sig * (np.sin(2 * np.pi * 1.3 * t) > -0.2) * 0.3 + rng.normal(0, 0.01, len(t))
    return sig.astype(np.float32)


def case_mesh_path(path):
    """One mesh path on this rank of a 2-rank world, its kernels counted as
    the smoke counts them (zeroed just before the path, read just after)."""
    import os

    from audio_processor_tpu_torch.models.whisper import quantize
    from audio_processor_tpu_torch.parallel import mesh as mesh_lib
    from audio_processor_tpu_torch.pipeline.diarize import Diarizer
    from audio_processor_tpu_torch.pipeline.transcribe import Transcriber

    set_full_fp32()
    counters = (log_mel, da.cross_attention_int4_stacked, da.cross_attention_int4_stacked_tp)
    kw = dict(cfg=_MESH_CFG, compute_dtype="float32", max_new_tokens=8, tokenizer=_Letters(),
              enable_fallback=False, no_speech_threshold=None)
    params = model.init_params(_MESH_CFG, torch.Generator().manual_seed(2))
    mesh = mesh_lib.make_mesh(1 if path == "int8_weights" else 2)
    for c in counters:
        c.launches = 0
    if path == "words":  # dp1 x tp2
        t = Transcriber(params=params, mesh=mesh, word_timestamps=True, **kw)
        got = [(w["word"], w["start"], w["end"]) for w in t.transcribe(_speech(40, 3))["words"]]
    elif path == "int8_weights":  # dp2 x tp1
        t = Transcriber(params=quantize.quantize_decoder(params), mesh=mesh, **kw)
        got = [s["tokens"] for s in t.transcribe(_speech(40, 3))["segments"]]
    elif path == "diarizer":  # dp1 x tp2
        got = Diarizer.bundled(mesh=mesh).diarize(_speech(20, 4))
    else:  # the service under APTPU_DISTRIBUTED=1, dp1 x tp2: one /v1-style call
        from audio_processor_tpu_torch.runtime import services

        os.environ.update(APTPU_DISTRIBUTED="1", APTPU_MODEL_PARALLEL="2")
        try:
            svc = services.build_services(model="tiny", with_drive=False, with_llm=False,
                                          diarization=False)
        finally:
            for k in ("APTPU_DISTRIBUTED", "APTPU_MODEL_PARALLEL"):
                os.environ.pop(k)
        for c in counters:
            c.launches = 0
        if svc.controller.is_leader:
            got = svc.processor.transcriber.transcribe(_speech(20, 5))["text"]
            svc.controller.stop()
            svc.engine.shutdown(wait=False)
        else:
            svc.controller.follow()
            got = None
    torch.cuda.synchronize()
    return got, {c.__name__: c.launches for c in counters}


@pytest.mark.parametrize("path,want", [
    ("words", {"log_mel": True, "cross_attention_int4_stacked_tp": True,
               "cross_attention_int4_stacked": False}),
    ("int8_weights", {"log_mel": True, "cross_attention_int4_stacked_tp": False,
                      "cross_attention_int4_stacked": True}),
    ("diarizer", {"log_mel": True}),
    ("service", {"log_mel": True, "cross_attention_int4_stacked_tp": True,
                 "cross_attention_int4_stacked": False}),
])
def test_mesh_path_launches_its_kernels(dev, path, want):
    """Each mesh path on 2 gloo ranks sharing the card launches the kernels
    the smoke counts for it on every rank (kernel A; #5 on tp=2, kernel B
    on the data-only mesh of int8 weights) and no other, and the ranks
    agree (the service's follower returns after the stop message)."""
    from test_torch_parallel import World

    w = World(2)
    try:
        out = w.run(case_mesh_path, path, timeout=600.0)
    finally:
        w.close()
    for got, launches in out:
        for name, on in want.items():
            assert bool(launches[name]) == on, (path, launches)
    if path != "service":
        assert out[0][0] == out[1][0] and out[0][0]
    else:
        assert out[0][0] is not None and out[1][0] is None
