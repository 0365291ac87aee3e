"""Decode cross-attention kernels over the quantized cross-KV cache (CUDA
C++), with the int4 cache format helpers and each kernel's plain version.

* Kernel B, ``cross_attention_int4_stacked`` (``csrc/cross_attn_int4.cu``):
  one layer of the stacked nibble-packed int4 cache.  Replaces the TPU
  kernel ``cross_attention_int4_stacked``
  (``audio_processor_tpu/ops/pallas/decode_attention.py:411``).
* Kernel #5, ``cross_attention_int4_stacked_tp``: kernel B on one rank's
  shard of a (data, model) mesh, its heads and rows.  Replaces the TPU
  kernel ``cross_attention_int4_stacked_tp`` (``decode_attention.py:471``).
* ``cross_attention_int4``: the same function on a single-layer cache
  (B, H, Dh, Tpad/2), launched through kernel B's library.  Replaces the
  TPU kernel ``cross_attention_int4`` (``decode_attention.py:277``).
* Kernel #3, ``cross_attention_int8`` (``csrc/cross_attn_int8.cu``): one
  layer of the int8 kernel-layout cache, K (B, H, Dh, Tpad) and V
  (B, H, Tpad, Dh), split over 128-position chunks as kernel B splits its
  packed columns.  Replaces the TPU kernel ``cross_attention_int8``
  (``decode_attention.py:83``).

The int4 cache keeps the JAX package's byte layout so tests compare it
exactly: offset-binary nibbles u = x + 8, time de-interleaved (low nibbles
= even times, high nibbles = odd times), K as (L, B, H, Dh, Tpad/2) and V
as (L, B, H, Tpad/2, Dh), Tpad a multiple of 128.

Each wrapper launches its kernel on CUDA tensors and runs the plain
PyTorch version (``*_reference``) on CPU tensors; q carries K's dequant
scale and the result is in integer units (the caller applies V's scale).
Bound and design: see the sources.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build


# ---------------------------------------------------------------------------
# Cache format (plain PyTorch)
# ---------------------------------------------------------------------------

def pack_int4_time(k8: torch.Tensor, v8: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Nibble-pack K along its last (time) axis and V along its second-last
    (time) axis: int4-valued int8 in [-7, 7] -> int8 bytes holding
    (x_even + 8) | (x_odd + 8) << 4."""
    def pack(lo, hi):
        u = (lo.to(torch.int32) + 8) | ((hi.to(torch.int32) + 8) << 4)
        return u.to(torch.uint8).view(torch.int8)

    return pack(k8[..., 0::2], k8[..., 1::2]), pack(v8[..., 0::2, :], v8[..., 1::2, :])


def _unpack_nibbles_u(p8: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 -> (low nibble, high nibble), both unsigned-offset int32 in
    [1, 15] (subtract 8 for the signed value)."""
    x = p8.to(torch.int32)
    return x & 0xF, (x >> 4) & 0xF


def _deinterleaved_valid_mask(tq: int, tpad: int, valid_len: int, device) -> torch.Tensor:
    """(Tq, Tpad) bool mask for the [evens, odds] time order."""
    half = tpad // 2
    j = torch.arange(tpad, device=device)
    orig = torch.where(j < half, 2 * j, 2 * (j - half) + 1)
    return (orig < valid_len)[None, :].expand(tq, tpad)


def cross_attention_int8_reference(
    q: torch.Tensor, k8t: torch.Tensor, v8: torch.Tensor, *, valid_len: int
) -> torch.Tensor:
    """Plain version on one layer: q (B, Tq, H, Dh) (K scale folded in),
    k8t (B, H, Dh, Tpad), v8 (B, H, Tpad, Dh) int8 -> (B, Tq, H, Dh) float32
    in integer units; positions >= valid_len are masked to -1e30."""
    dh = q.shape[-1]
    scores = torch.einsum("bqhd,bhdt->bhqt", q.float(), k8t.float()) / math.sqrt(dh)
    valid = torch.arange(k8t.shape[3], device=q.device) < valid_len
    scores = torch.where(valid, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqt,bhtd->bqhd", probs, v8.float())


def cross_attention_int4_reference(
    q: torch.Tensor, k4: torch.Tensor, v4: torch.Tensor, *, valid_len: int
) -> torch.Tensor:
    """Plain version on one layer's packed arrays: q (B, Tq, H, Dh) (K scale
    folded in), k4 (B, H, Dh, Tpad/2), v4 (B, H, Tpad/2, Dh) -> (B, Tq, H, Dh)
    float32 in integer units (the caller applies the V scale)."""
    dh = q.shape[-1]
    tq = q.shape[1]
    lo_k, hi_k = _unpack_nibbles_u(k4)
    k_full = (torch.cat([lo_k, hi_k], dim=3) - 8).float()  # (B, H, Dh, Tpad)
    lo_v, hi_v = _unpack_nibbles_u(v4)
    v_full = (torch.cat([lo_v, hi_v], dim=2) - 8).float()  # (B, H, Tpad, Dh)
    scores = torch.einsum("bqhd,bhdt->bhqt", q.float(), k_full) / math.sqrt(dh)
    valid = _deinterleaved_valid_mask(tq, k_full.shape[3], valid_len, q.device)
    scores = torch.where(valid[None, None], scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqt,bhtd->bqhd", probs, v_full)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

def _check_q(q: torch.Tensor, name: str) -> None:
    if q.dtype != torch.float32 or not q.is_contiguous():
        raise ValueError(f"{name}: q must be contiguous float32")


def _check_cache(name: str, t: torch.Tensor, device, shape: tuple) -> None:
    if t.device != device or t.dtype != torch.int8 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int8 tensor on {device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("cross_attn_int4")
    fn = lib.cross_attn_int4_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


# Kernel B's time split: packed columns a chunk (csrc/cross_attn_int4.cu kChunk)
INT4_CHUNK = 64
INT4_MAX_DH = 256
INT4_MAX_HALF = 128 * INT4_CHUNK  # a chunk a thread in the combine
# per (device index, stream): the (row, head) counters of kernel B's and
# kernel #3's last-block combines, zeroed once when made (every launch
# leaves them at 0), and a decode step's (Tq=1) workspace of per-chunk
# partials; grown when a call needs more
_SCRATCH: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch(q: torch.Tensor, stream: int, n_counters: int, n_work: int):
    key = (q.get_device(), stream)
    counters, work = _SCRATCH.get(key, (None, None))
    if counters is None or counters.numel() < n_counters:
        counters = torch.zeros(n_counters, dtype=torch.int32, device=q.device)
    if work is None or work.numel() < n_work:
        work = torch.empty(n_work, dtype=torch.float32, device=q.device)
    _SCRATCH[key] = counters, work
    return counters, work


def _check_out(name: str, out: torch.Tensor | None, q: torch.Tensor) -> torch.Tensor:
    """``out`` where it can take the kernel's (B, Tq, H, Dh) float32 output
    (a caller's buffer at a fixed address), else a new tensor."""
    if out is None:
        return torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if out.shape != q.shape or out.dtype != torch.float32 or out.device != q.device \
            or not out.is_contiguous():
        raise ValueError(f"{name}: out must be a contiguous float32 tensor of q's shape "
                         f"{tuple(q.shape)} on {q.device}")
    return out


def _launch_int4_stacked(name, q, k4_all, v4_all, layer, valid_len, out=None) -> torch.Tensor:
    """Kernel B on layer ``layer`` of a stacked packed cache, read in place
    through a pointer offset (no per-layer copy); CUDA tensors only."""
    b, tq, h, dh = q.shape
    n_layers, half = k4_all.shape[0], k4_all.shape[4]
    _check_q(q, name)
    _check_cache("k4_all", k4_all, q.device, (n_layers, b, h, dh, half))
    _check_cache("v4_all", v4_all, q.device, (n_layers, b, h, half, dh))
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} out of range for {n_layers} layers")
    if dh & (dh - 1) or not 8 <= dh <= INT4_MAX_DH or half % INT4_CHUNK or half > INT4_MAX_HALF:
        raise ValueError(f"kernel needs Dh a power of two in [8, {INT4_MAX_DH}] and Tpad/2 "
                         f"a multiple of {INT4_CHUNK} up to {INT4_MAX_HALF} "
                         f"(Dh={dh}, Tpad/2={half})")
    k_ptr, v_ptr = k4_all.data_ptr(), v4_all.data_ptr()
    if (k_ptr | v_ptr) % 16:
        raise ValueError("kernel needs 16-byte aligned caches (it copies 16 bytes at a time)")
    if not 1 <= valid_len <= 2 * half:
        raise ValueError(f"valid_len {valid_len} outside [1, {2 * half}]")
    lib = _library()
    out = _check_out(name, out, q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    # each live chunk's (max, sum, acc[Dh]) per query row, combined in the launch
    chunks = -(-((valid_len + 1) // 2) // INT4_CHUNK)
    counters, work = _scratch(q, stream, b * h, b * h * chunks * (dh + 2))
    if tq > 1:  # a prefill's partials: not kept between calls
        work = torch.empty(b * h * tq * chunks * (dh + 2), dtype=torch.float32, device=q.device)
    layer_bytes = b * h * dh * half
    rc = lib.cross_attn_int4_launch(
        q.data_ptr(), k_ptr + layer * layer_bytes, v_ptr + layer * layer_bytes,
        out.data_ptr(), work.data_ptr(), counters.data_ptr(),
        b, tq, h, dh, half, valid_len, 1.0 / math.sqrt(dh), stream,
    )
    if rc != 0:
        raise RuntimeError(f"cross_attn_int4 kernel launch failed: CUDA error {rc}")
    return out


def cross_attention_int4_stacked(
    q: torch.Tensor,
    k4_all: torch.Tensor,
    v4_all: torch.Tensor,
    layer: int,
    *,
    valid_len: int,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Decode cross-attention of q (B, Tq, H, Dh) float32 (K scale folded
    in) against layer ``layer`` of the stacked packed cache, k4_all
    (L, B, H, Dh, Tpad/2) and v4_all (L, B, H, Tpad/2, Dh) int8.
    Returns (B, Tq, H, Dh) float32 in integer units, in ``out`` when given
    (a contiguous float32 tensor of q's shape).

    CUDA tensors: the kernel, reading the layer in place through a
    pointer offset (no per-layer copy), or an error.  CPU tensors: the
    plain version.
    """
    if q.device.type == "cpu":
        ref = cross_attention_int4_reference(q, k4_all[layer], v4_all[layer], valid_len=valid_len)
        return ref if out is None else _check_out("cross_attention_int4_stacked", out, q).copy_(ref)
    if q.device.type != "cuda":
        raise ValueError(f"cross_attention_int4_stacked: unsupported device {q.device}")
    out = _launch_int4_stacked("cross_attention_int4_stacked", q, k4_all, v4_all, layer,
                               valid_len, out)
    cross_attention_int4_stacked.launches += 1
    return out


cross_attention_int4_stacked.launches = 0


def cross_attention_int4_stacked_tp(
    mesh,
    q_local: torch.Tensor,
    k4_local: torch.Tensor,
    v4_local: torch.Tensor,
    layer: int,
    *,
    valid_len: int,
    n_head: int,
) -> torch.Tensor:
    """Kernel #5: kernel B on this rank's shard of a (data, model) mesh.

    Heads are split over the model axis (the q/k/v projections are column
    parallel, so q arrives with the rank's heads) and rows over the data
    axis: q_local (B/dp, Tq, H/tp, Dh) float32 against the rank's stacked
    cache, k4_local (L, B/dp, H/tp, Dh, Tpad/2) and v4_local
    (L, B/dp, H/tp, Tpad/2, Dh).  Heads are independent in this function,
    so no collective runs here (the row-parallel output projection sums
    over the model group afterwards).  ``n_head``: the model's heads, H;
    raises ValueError when they do not split evenly over tp.

    CUDA tensors: kernel B's library on the rank's tensors, the layer read
    in place, or an error.  CPU tensors: the plain version.
    """
    tp = 1 if mesh is None else mesh.tp
    if n_head % tp:
        raise ValueError(f"{n_head} heads do not shard over tp={tp}")
    if q_local.shape[2] != n_head // tp:
        raise ValueError(
            f"q_local holds {q_local.shape[2]} heads, expected {n_head // tp} of {n_head} over tp={tp}"
        )
    if q_local.device.type == "cpu":
        return cross_attention_int4_reference(
            q_local, k4_local[layer], v4_local[layer], valid_len=valid_len
        )
    if q_local.device.type != "cuda":
        raise ValueError(f"cross_attention_int4_stacked_tp: unsupported device {q_local.device}")
    out = _launch_int4_stacked(
        "cross_attention_int4_stacked_tp", q_local, k4_local, v4_local, layer, valid_len
    )
    cross_attention_int4_stacked_tp.launches += 1
    return out


cross_attention_int4_stacked_tp.launches = 0


def cross_attention_int4(
    q: torch.Tensor, k4: torch.Tensor, v4: torch.Tensor, *, valid_len: int
) -> torch.Tensor:
    """Kernel B's function on a single-layer packed cache: q (B, Tq, H, Dh)
    float32 (K scale folded in), k4 (B, H, Dh, Tpad/2), v4 (B, H, Tpad/2, Dh)
    int8 -> (B, Tq, H, Dh) float32 in integer units.

    CUDA tensors: kernel B's library on the one layer, or an error.  CPU
    tensors: the plain version.
    """
    if q.device.type == "cpu":
        return cross_attention_int4_reference(q, k4, v4, valid_len=valid_len)
    if q.device.type != "cuda":
        raise ValueError(f"cross_attention_int4: unsupported device {q.device}")
    out = _launch_int4_stacked("cross_attention_int4", q, k4[None], v4[None], 0, valid_len)
    cross_attention_int4.launches += 1
    return out


cross_attention_int4.launches = 0


@functools.lru_cache(maxsize=None)
def _library_int8() -> ctypes.CDLL:
    lib = build.load("cross_attn_int8")
    fn = lib.cross_attn_int8_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


# Kernel #3's time split: time positions a chunk (csrc/cross_attn_int8.cu kChunk)
INT8_CHUNK = 128
INT8_MAX_DH = 256
INT8_MAX_TPAD = 128 * INT8_CHUNK  # a chunk a thread in the combine


def check_int8_kernel_args(q: torch.Tensor, k8t: torch.Tensor, v8: torch.Tensor,
                           valid_len: int) -> None:
    """Raise ValueError for what kernel #3 does not take: q not contiguous
    float32; caches not contiguous int8 of the matching shapes on q's
    device, or not 16-byte aligned (the kernel copies 16 bytes at a time);
    Dh not a power of two in [8, INT8_MAX_DH]; Tpad not a multiple of
    INT8_CHUNK up to INT8_MAX_TPAD; valid_len outside [1, Tpad]."""
    _check_q(q, "cross_attention_int8")
    b, _, h, dh = q.shape
    tpad = k8t.shape[-1]
    _check_cache("k8t", k8t, q.device, (b, h, dh, tpad))
    _check_cache("v8", v8, q.device, (b, h, tpad, dh))
    if dh & (dh - 1) or not 8 <= dh <= INT8_MAX_DH or tpad % INT8_CHUNK or tpad > INT8_MAX_TPAD:
        raise ValueError(f"kernel needs Dh a power of two in [8, {INT8_MAX_DH}] and Tpad a "
                         f"multiple of {INT8_CHUNK} up to {INT8_MAX_TPAD} (Dh={dh}, Tpad={tpad})")
    if (k8t.data_ptr() | v8.data_ptr()) % 16:
        raise ValueError("kernel needs 16-byte aligned caches (it copies 16 bytes at a time)")
    if not 1 <= valid_len <= tpad:
        raise ValueError(f"valid_len {valid_len} outside [1, {tpad}]")


def cross_attention_int8(
    q: torch.Tensor, k8t: torch.Tensor, v8: torch.Tensor, *, valid_len: int,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Decode cross-attention of q (B, Tq, H, Dh) float32 (K scale folded
    in) against one layer of the int8 kernel-layout cache, k8t
    (B, H, Dh, Tpad) and v8 (B, H, Tpad, Dh).  Returns (B, Tq, H, Dh)
    float32 in integer units, in ``out`` when given (a contiguous float32
    tensor of q's shape).

    CUDA tensors: the kernel, or an error (``check_int8_kernel_args``); the
    decoder passes the layer's view ``cache.cross_k[l]`` in place.  CPU
    tensors: the plain version.
    """
    if q.device.type == "cpu":
        ref = cross_attention_int8_reference(q, k8t, v8, valid_len=valid_len)
        return ref if out is None else _check_out("cross_attention_int8", out, q).copy_(ref)
    if q.device.type != "cuda":
        raise ValueError(f"cross_attention_int8: unsupported device {q.device}")
    check_int8_kernel_args(q, k8t, v8, valid_len)
    b, tq, h, dh = q.shape
    tpad = k8t.shape[-1]
    lib = _library_int8()
    out = _check_out("cross_attention_int8", out, q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    # each live chunk's (max, sum, acc[Dh]) per query row, combined in the
    # launch; the counters and a decode step's workspace are kernel B's
    # (one stream runs its launches in order)
    chunks = -(-valid_len // INT8_CHUNK)
    counters, work = _scratch(q, stream, b * h, b * h * chunks * (dh + 2))
    if tq > 1:  # a prefill's partials: not kept between calls
        work = torch.empty(b * h * tq * chunks * (dh + 2), dtype=torch.float32, device=q.device)
    rc = lib.cross_attn_int8_launch(
        q.data_ptr(), k8t.data_ptr(), v8.data_ptr(), out.data_ptr(), work.data_ptr(),
        counters.data_ptr(), b, tq, h, dh, tpad, valid_len, 1.0 / math.sqrt(dh), stream,
    )
    if rc != 0:
        raise RuntimeError(f"cross_attn_int8 kernel launch failed: CUDA error {rc}")
    cross_attention_int8.launches += 1
    return out


cross_attention_int8.launches = 0
