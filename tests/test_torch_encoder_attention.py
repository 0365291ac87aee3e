"""The port's encoder self-attention (the plain version beside kernel #6,
``ops/kernels/encoder_attention.py``) against the JAX package's Pallas
kernel ``fused_self_attention`` in interpret mode, and the encoder with
``fused_attn=True`` against the JAX encoder through that kernel.

Tolerances: float32 2e-5 (T=64 and the tail-padded T=50), the JAX
suite's for this kernel; bfloat16 4e-3 + 8e-3 relative, tighter than that
suite's 2e-2 because both sides keep the scores in float32 and round only
the normalised probabilities and the output to bf16; the encoder 2e-4.
"""
import functools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_processor_tpu.models.whisper import model as jmodel
from audio_processor_tpu.models.whisper.config import WhisperConfig as JConfig
from audio_processor_tpu.ops.pallas import encoder_attention as jea
from audio_processor_tpu_torch.models.whisper import convert, model
from audio_processor_tpu_torch.models.whisper.config import WhisperConfig
from audio_processor_tpu_torch.ops.kernels import encoder_attention as ea
from audio_processor_tpu_torch.runtime.device import set_full_fp32

set_full_fp32()


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("t", [64, 50])  # a whole and a tail-padded grid
def test_plain_matches_jax_kernel_f32(t):
    q, k, v = _qkv(t, (2, t, 4, 64))
    before = ea.fused_self_attention.launches
    ours = ea.fused_self_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    ref = np.asarray(jea.fused_self_attention(
        *map(jnp.asarray, (q, k, v)), block_q=32, interpret=True
    ))
    assert ours.shape == ref.shape == (2, t, 4, 64)
    np.testing.assert_allclose(ours, ref, atol=2e-5, rtol=1e-5)
    assert ea.fused_self_attention.launches == before  # CPU: no kernel


def test_plain_matches_jax_kernel_bf16():
    q, k, v = _qkv(3, (1, 96, 2, 64))
    ours = ea.fused_self_attention(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v))
    )
    assert ours.dtype == torch.bfloat16
    ref = jea.fused_self_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), block_q=32, interpret=True
    )
    np.testing.assert_allclose(
        ours.float().numpy(), np.asarray(ref, np.float32), atol=4e-3, rtol=8e-3
    )


def test_plain_reads_strided_views():
    """The kernel reads q, k, v through their strides; the plain version
    must agree on a non-contiguous view (a slice along the head axis)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, (2, 40, 6, 32)))
    got = ea.fused_self_attention(q[:, :, ::2], k[:, :, ::2], v[:, :, ::2])
    want = ea.attention_reference(*(x[:, :, ::2].contiguous() for x in (q, k, v)))
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_encode_fused_matches_jax_kernel(monkeypatch):
    dims = dict(n_mels=80, n_audio_ctx=32, n_audio_state=64, n_audio_head=4,
                n_audio_layer=2, n_vocab=256, n_text_ctx=16, n_text_state=64,
                n_text_head=4, n_text_layer=1)
    cfg, jcfg = WhisperConfig(name="t", **dims), JConfig(name="t", **dims)
    params = model.init_params(cfg, torch.Generator().manual_seed(5))
    jparams = convert._unflatten({
        k: jnp.asarray(t.numpy().transpose(2, 1, 0) if k in convert._CONV_KEYS else t.numpy())
        for k, t in convert._flatten(params).items()
    })
    mel = np.random.default_rng(6).normal(0, 1, (2, 80, 64)).astype(np.float32)
    monkeypatch.setattr(jea, "fused_self_attention",
                        functools.partial(jea.fused_self_attention, interpret=True))
    ref = np.asarray(jmodel.encode(jparams, jcfg, jnp.asarray(mel), fused_attn=True))
    ours = model.encode(params, cfg, torch.from_numpy(mel), fused_attn=True).numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=1e-4)
    plain = model.encode(params, cfg, torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(ours, plain, atol=1e-6)


# one ragged tile; one past a whole tile; 11 whole tiles and a tail of 92
@pytest.mark.parametrize("t", [77, 129, 1500])
def test_plain_matches_jax_kernel_bf16_at_kernel_tiles(t):
    """At the card test's lengths around the bf16 kernel's 128-key tiles,
    the plain version (the kernel's bar on the card) stays within that
    bar, 4e-3, of the JAX Pallas kernel: both round the same normalised P."""
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(t + 1, (1, t, 2, 64)))
    ref = ea.attention_reference(q, k, v).float()
    assert ref.shape == (1, t, 2, 64)
    jax_ref = np.asarray(jea.fused_self_attention(
        *(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)), interpret=True
    ), np.float32)
    assert np.abs(ref.numpy() - jax_ref).max() <= 4e-3


def test_wrapper_rejects_other_devices():
    q = torch.zeros((1, 4, 1, 32), device="meta")
    with pytest.raises(ValueError):
        ea.fused_self_attention(q, q, q)
