"""Kernels A (log-mel) and B (int4 cross-attention) against their plain
PyTorch versions, on the card.

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
from audio_processor_tpu_torch.ops.kernels.log_mel import log_mel
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


@pytest.mark.parametrize("b,tq,h,dh,tpad,valid", [
    (3, 1, 2, 16, 256, 201), (3, 3, 2, 16, 256, 201), (8, 4, 12, 64, 1536, 1500),
])
def test_cross_attention_kernel_matches_plain(dev, b, tq, h, dh, tpad, valid):
    g = torch.Generator(device=dev).manual_seed(b * tq)
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


def test_greedy_decode_on_card_matches_cpu(dev):
    """Float32 int4 greedy decode: the card path (kernel B) gives the CPU
    path's tokens on a small config."""
    cfg = WhisperConfig(name="small-test", n_mels=80, n_audio_ctx=96, n_audio_state=64,
                        n_audio_head=2, n_audio_layer=1, n_vocab=1024, n_text_ctx=64,
                        n_text_state=64, n_text_head=2, n_text_layer=2)
    params = model.init_params(cfg, torch.Generator().manual_seed(0))
    st = decode.SpecialTokens.for_config(cfg)
    states = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (4, 96, 64)).astype(np.float32))
    kw = dict(sot_sequence=tuple(st.sot_sequence()), max_new_tokens=16,
              quantize_cross_kv=True, kv_bits=4)
    cpu = decode.greedy_decode(params, cfg, states, **kw)
    gpu_params = model.map_params(lambda t: t.to(dev), params)
    before = da.cross_attention_int4_stacked.launches
    gpu = decode.greedy_decode(gpu_params, cfg, states.to(dev), **kw)
    assert da.cross_attention_int4_stacked.launches > before
    assert torch.equal(gpu.tokens.cpu(), cpu.tokens)
    assert math.isclose(gpu.sum_logprob.sum().item(), cpu.sum_logprob.sum().item(), abs_tol=1e-2)
