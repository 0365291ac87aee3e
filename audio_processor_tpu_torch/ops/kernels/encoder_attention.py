"""Kernel #6: fused non-causal self-attention for the encoder (CUDA C++,
``csrc/encoder_attn.cu``), beside its plain PyTorch version.

Replaces the TPU kernel ``fused_self_attention``
(``audio_processor_tpu/ops/pallas/encoder_attention.py:80``).  Inputs are
(B, T, H, Dh) in the compute dtype (bfloat16 or float32), read through
their strides; the result is (B, T, H, Dh) in the same dtype.  Scores and
softmax run in float32 and the normalised probabilities are rounded to
the compute dtype before the product with V, as the TPU kernel does.

``fused_self_attention`` launches the kernel on CUDA tensors and runs the
plain version (``attention_reference``) on CPU tensors; ``kernel_serves``
says where the encoder takes the kernel unasked.  The bf16 kernel
gathers the softmax statistics tile by tile in a first pass over the keys
and forms P in a second, so it rounds the same P as the plain version.
Bound and design: see the source.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64,)  # the kernel's instantiations: every Whisper config's head width


def _scores_f32(qh: torch.Tensor, kh: torch.Tensor) -> torch.Tensor:
    """q k^T as float32 from (B, H, T, Dh) operands in q's dtype, the sums
    never rounded to a narrower type (JAX's preferred_element_type=f32).
    A bf16 product on the card is a bf16 GEMM with a float32 output;
    elsewhere it is a float32 matmul of the exactly upcast operands."""
    if qh.is_cuda and qh.dtype == torch.bfloat16:
        b, h, t, dh = qh.shape
        s = torch.bmm(qh.reshape(b * h, t, dh), kh.reshape(b * h, t, dh).transpose(-1, -2),
                      out_dtype=torch.float32)
        return s.view(b, h, t, t)
    return torch.matmul(qh.float(), kh.float().transpose(-1, -2))


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(dh)) v with (B, T, H, Dh) layouts: scores and
    softmax in float32, the probabilities rounded back to q's dtype, then
    P V in q's dtype with float32 sums (the JAX ``model.attention``)."""
    dh = q.shape[-1]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, T, Dh)
    scores = _scores_f32(qh, kh).mul_(1.0 / math.sqrt(dh))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, vh).transpose(1, 2).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("encoder_attn")
    fn = lib.encoder_attn_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


def kernel_serves(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the kernel serves these (B, T, H, Dh) operands: on CUDA, in
    bfloat16 (the float32 kernel is a parity path, not a serving one), at a
    head width it is built for, and with nothing requiring grad (it has no
    backward).  Both compute one function at one precision, so where the
    kernel does not serve, the plain version runs."""
    return (q.device.type == "cuda" and q.dtype == torch.bfloat16 and q.shape[-1] in _HEAD_DIMS
            and not (q.requires_grad or k.requires_grad or v.requires_grad))


def fused_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal attention over (B, T, H, Dh) tensors: every position
    attends to all T positions.

    CUDA tensors: the kernel, or an error.  CPU tensors: the plain version.
    """
    if q.device.type == "cpu":
        return attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"fused_self_attention: unsupported device {q.device}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, T, H, Dh), got shape {tuple(q.shape)}")
    b, t, h, dh = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"fused_self_attention takes float32 or bfloat16, not {q.dtype}")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"head dim {dh} is not one of the kernel's {_HEAD_DIMS}")
    align = 16 // q.element_size()  # TMA (bf16) and float4 loads (f32): 16-byte units
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype or tuple(x.shape) != (b, t, h, dh):
            raise ValueError(f"{name} must be a {q.dtype} tensor of shape {(b, t, h, dh)} on {q.device}")
        if x.stride(3) != 1 or any(s % align for s in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(
                f"{name} needs a contiguous head axis, 16-byte aligned rows and "
                f"strides divisible by {align}; got strides {x.stride()}"
            )
    lib = _library()
    out = torch.empty((b, t, h, dh), dtype=q.dtype, device=q.device)
    strides = [s for x in (q, k, v, out) for s in x.stride()[:3]]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.encoder_attn_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[q.dtype], b, t, h, dh, *strides, 1.0 / math.sqrt(dh), stream,
    )
    if rc != 0:
        raise RuntimeError(f"encoder_attn kernel launch failed: CUDA error {rc}")
    fused_self_attention.launches += 1
    return out


fused_self_attention.launches = 0
