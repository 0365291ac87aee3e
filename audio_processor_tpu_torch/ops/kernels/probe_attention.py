"""Kernel B's design probes (CUDA C++), each beside its plain version.

The JAX package's three probes of its int4 decode kernel run one layer of
the stacked cross-KV cache through other kernel bodies
(``benchmarks/kernel_v32_probe.py``, ``kernel_v34_probe.py``,
``kernel_v4_probe.py``).  The bodies that compute kernel B's function as
kernel B does (v3.2) or kernel #3's (``i8_f32``) run those kernels
(``decode_attention``); the others run the three kernels of
``csrc/cross_attn_probes.cu`` through the wrappers here:

* ``probe_stream`` (P1): the stream-only floor, #8 ``s``.  Reads every K/V
  byte of the layer in 16-byte loads and reduces them to the JAX probe's
  checksum (``probe_stream_reference``), bit for bit.
* ``int4_rows`` (P2): the exact int4 function, f32 products on CUDA cores,
  BB batch rows a block: v3.1 (``unpack="byte"``), #8 a
  (``joint=False``) and b-e (``joint=True``), #9 ``i4_bf16`` (``bf16``).
* ``int8_dot`` (P3): q row-quantised to int8 (``quant_q``) and the products
  as exact int32 sums by dp4a: #7 ``mxu`` and #9 ``i4_mxu_kv``
  (``cache="int4"``), ``i8_mxu_kv`` (``cache="int8"``), ``i8_mxu_k``
  (``cache="int8", pv="f32"``).

P1 and P2 split the packed time axis across blocks (a chunk of columns a
block, as kernel B does) and combine the chunks in the same launch, in
chunk order: each block counts its partial on a per-group counter, and the
group's last block waits for the count.

Each wrapper takes q (B, 1, H, 64) float32 (K's scale folded in), a stacked
cache and ``layer``, as ``cross_attention_int4_stacked`` does, and returns
(B, 1, H, 64) float32 in integer units.  CUDA tensors launch the kernel, or
raise ``ValueError`` for a shape or variant the source does not instantiate;
CPU tensors run the plain version.  No failure falls back to the plain
version.  The plain versions follow the JAX probes' operation order.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build
from .decode_attention import _check_cache, _check_q, _unpack_nibbles_u

DH = 64  # the kernels' head width: every Whisper model's
ROW_BLOCKS = (1, 2, 4, 8)  # BB values instantiated
# int4_rows instantiations: (unpack, bb, joint, bf16); joint at bb=1 is the
# same block as joint off
INT4_ROWS_VARIANTS = frozenset(
    [("byte", 1, False, False), ("packed", 1, False, True)]
    + [("packed", bb, False, False) for bb in ROW_BLOCKS]
    + [("packed", bb, True, False) for bb in ROW_BLOCKS[1:]]
)
INT8_DOT_VARIANTS = frozenset([("int4", "int8"), ("int8", "int8"), ("int8", "f32")])
_NEG = -1e30


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def quant_q(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., Dh) float32 -> (int8 values, scale (..., 1)): one scale a row,
    amax / 127, rounded half to even.  The clip to [-127, 127] never acts
    (|q| / (amax / 127) <= 127), so this serves both JAX probes' versions."""
    amax = q.abs().amax(dim=-1, keepdim=True)
    sq = amax.clamp_min(1e-8) / 127.0
    return torch.round(q / sq).clamp(-127, 127).to(torch.int8), sq


def _heads_first(q: torch.Tensor) -> torch.Tensor:
    return q.float().permute(0, 2, 1, 3)  # (B, H, Tq, Dh)


def _halves_softmax(s_lo, s_hi, valid_len):
    """Joint softmax over the two de-interleaved halves (low nibbles: even
    times, high: odd), masked per half."""
    half = s_lo.shape[-1]
    col = torch.arange(half, device=s_lo.device)
    s_lo = torch.where(col < (valid_len + 1) // 2, s_lo, torch.full_like(s_lo, _NEG))
    s_hi = torch.where(col < valid_len // 2, s_hi, torch.full_like(s_hi, _NEG))
    m = torch.maximum(s_lo.amax(-1, keepdim=True), s_hi.amax(-1, keepdim=True))
    p_lo, p_hi = torch.exp(s_lo - m), torch.exp(s_hi - m)
    return p_lo, p_hi, p_lo.sum(-1, keepdim=True) + p_hi.sum(-1, keepdim=True)


def probe_stream_reference(q: torch.Tensor, k4_all: torch.Tensor, v4_all: torch.Tensor,
                           layer: int) -> torch.Tensor:
    """The stream-only probe's checksum of layer ``layer``: per row, the f32
    sum over heads in order of the wrapping int32 sum of the head's K and V
    blocks viewed as int32 words, four consecutive rows of the second-to-last
    axis a word (K byte (d, j) weighs 256^(d mod 4), V byte (j, d)
    256^(j mod 4)); broadcast to q's shape (B, 1, H, Dh)."""
    k = k4_all[layer].to(torch.int64) & 0xFF  # (B, H, Dh, half) unsigned bytes
    v = v4_all[layer].to(torch.int64) & 0xFF  # (B, H, half, Dh)
    dev = k.device
    wk = 256 ** (torch.arange(k.shape[2], device=dev) % 4)
    wv = 256 ** (torch.arange(v.shape[2], device=dev) % 4)
    s = ((k.sum(-1) * wk).sum(-1) + (v.sum(-1) * wv).sum(-1)) & 0xFFFFFFFF
    s = torch.where(s >= 2**31, s - 2**32, s).to(torch.float32)  # (B, H) as int32 -> f32
    acc = torch.zeros(s.shape[0], dtype=torch.float32, device=dev)
    for h in range(s.shape[1]):
        acc = acc + s[:, h]
    return acc[:, None, None, None].expand(q.shape).contiguous()


def int4_rows_reference(q: torch.Tensor, k4_all: torch.Tensor, v4_all: torch.Tensor, layer: int,
                        *, valid_len: int, bf16: bool = False) -> torch.Tensor:
    """Kernel B's function on layer ``layer`` in the probes' operation
    order (split halves, the offset folded into 8 sum(q)); ``bf16`` rounds
    q and P to bf16 before the products (#9 ``i4_bf16``), f32 sums."""
    qh = _heads_first(q)
    if bf16:
        qh = qh.to(torch.bfloat16).float()
    lo_k, hi_k = _unpack_nibbles_u(k4_all[layer])  # (B, H, Dh, half)
    lo_v, hi_v = _unpack_nibbles_u(v4_all[layer])  # (B, H, half, Dh)
    scale = 1.0 / math.sqrt(q.shape[-1])
    corr = 8.0 * qh.sum(-1, keepdim=True)
    s_lo = (qh @ lo_k.float() - corr) * scale
    s_hi = (qh @ hi_k.float() - corr) * scale
    p_lo, p_hi, denom = _halves_softmax(s_lo, s_hi, valid_len)
    if bf16:
        p_lo, p_hi = p_lo.to(torch.bfloat16).float(), p_hi.to(torch.bfloat16).float()
    acc = p_lo @ lo_v.float() + p_hi @ hi_v.float()
    return (acc / denom - 8.0).permute(0, 2, 1, 3).contiguous()


def _idot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer matrix product (float64 holds every sum here exactly;
    integer matmuls have no CUDA path)."""
    return a.double() @ b.double()


def int8_dot_reference(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor, layer: int,
                       *, valid_len: int, cache: str = "int4", pv: str = "int8") -> torch.Tensor:
    """q row-quantised to int8 and q.K as exact integer sums, on the int4
    cache (offset-binary nibbles, 8 sum(q8) correction) or the int8 cache
    (K (L,B,H,Dh,Tpad), V (L,B,H,Tpad,Dh)); P.V in f32 or in int8 with P at
    the static scale 127 (max p is exactly 1) and the 8 sum(p8) correction."""
    qh = _heads_first(q)
    q8, sq = quant_q(qh)
    s_scale = sq * (1.0 / math.sqrt(q.shape[-1]))
    if cache == "int4":
        lo_k, hi_k = _unpack_nibbles_u(k_all[layer])
        corr = 8.0 * q8.double().sum(-1, keepdim=True)
        s_lo = (_idot(q8, lo_k) - corr).float() * s_scale
        s_hi = (_idot(q8, hi_k) - corr).float() * s_scale
        p_lo, p_hi, denom = _halves_softmax(s_lo, s_hi, valid_len)
        p8_lo, p8_hi = torch.round(p_lo * 127.0), torch.round(p_hi * 127.0)
        lo_v, hi_v = _unpack_nibbles_u(v_all[layer])
        psum = p8_lo.double().sum(-1, keepdim=True) + p8_hi.double().sum(-1, keepdim=True)
        o = _idot(p8_lo, lo_v) + _idot(p8_hi, hi_v) - 8.0 * psum
        out = o.float() / (denom * 127.0)
    elif cache == "int8":
        k8, v8 = k_all[layer], v_all[layer]
        s = _idot(q8, k8).float() * s_scale
        col = torch.arange(s.shape[-1], device=s.device)
        s = torch.where(col < valid_len, s, torch.full_like(s, _NEG))
        p = torch.exp(s - s.amax(-1, keepdim=True))
        denom = p.sum(-1, keepdim=True)
        if pv == "f32":
            out = (p @ v8.float()) / denom
        else:
            out = _idot(torch.round(p * 127.0), v8).float() / (denom * 127.0)
    else:
        raise ValueError(f"cache must be 'int4' or 'int8', not {cache!r}")
    return out.permute(0, 2, 1, 3).contiguous()


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("cross_attn_probes")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_stream_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.int4_rows_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float, i, i, i,
                                     i, p]
    lib.int8_dot_launch.argtypes = [p, p, p, p, i, i, i, i, i, ctypes.c_float, i, i, p]
    lib.probe_chunk_columns.argtypes = [i, i, i]
    for fn in (lib.probe_stream_launch, lib.int4_rows_launch, lib.int8_dot_launch,
               lib.probe_chunk_columns):
        fn.restype = ctypes.c_int
    return lib


# P2's bf16 instantiation launches a (row, head)'s chunks as one cluster, at
# most 8 blocks (the portable cluster size)
MAX_CLUSTER_CHUNKS = 8
# per (device index, stream, kernel): the kernel's zeroed counters (every
# launch leaves them at 0) and its per-chunk workspace, grown when a call
# needs more
_SCRATCH: dict[tuple[int, int, str], tuple[torch.Tensor, torch.Tensor]] = {}


def _chunks(cols: int, stream: bool, bb: int, rows_at_once: int) -> int:
    """Blocks along the time axis for ``cols`` packed columns: the source's
    chunk width for P1 (``stream``) or P2 at ``bb`` rows a block,
    ``rows_at_once`` of them at once."""
    width = _library().probe_chunk_columns(int(stream), bb, rows_at_once)
    return -(-cols // width)


def _scratch(q: torch.Tensor, stream: int, kernel: str, n_counters: int, n_work: int, dtype):
    key = (q.get_device(), stream, kernel)
    counters, work = _SCRATCH.get(key, (None, None))
    if counters is None or counters.numel() < n_counters:
        counters = torch.zeros(n_counters, dtype=torch.int32, device=q.device)
    if work is None or work.numel() < n_work:
        work = torch.empty(n_work, dtype=dtype, device=q.device)
    _SCRATCH[key] = counters, work
    return counters, work


def _layer_args(name, q, k_all, v_all, layer, k_tail, v_tail, valid_len=None, max_valid=None):
    """Checks shared by the wrappers; returns (B, H, the layer's K and V
    pointers).  ``k_tail``/``v_tail``: the cache's shape after (L, B, H)."""
    _check_q(q, name)
    b, tq, h, dh = q.shape
    if tq != 1 or dh != DH:
        raise ValueError(f"{name}: the kernels take q (B, 1, H, {DH}), not {tuple(q.shape)}")
    n_layers = k_all.shape[0]
    _check_cache("k_all", k_all, q.device, (n_layers, b, h, *k_tail))
    _check_cache("v_all", v_all, q.device, (n_layers, b, h, *v_tail))
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} out of range for {n_layers} layers")
    if valid_len is not None and not 1 <= valid_len <= max_valid:
        raise ValueError(f"valid_len {valid_len} outside [1, {max_valid}]")
    k_ptr, v_ptr = k_all.data_ptr(), v_all.data_ptr()
    if (k_ptr | v_ptr) % 16:
        raise ValueError(f"{name}: caches must be 16-byte aligned")
    layer_bytes = k_all[0].numel()
    return b, h, k_ptr + layer * layer_bytes, v_ptr + layer * layer_bytes


def _int4_cols(name: str, k4_all: torch.Tensor) -> int:
    half = k4_all.shape[-1]
    if half % 64 or half < 64:
        raise ValueError(f"{name}: Tpad/2 must be a positive multiple of 64, not {half}")
    return half


def _check_bb(name: str, b: int, bb: int) -> None:
    if bb not in ROW_BLOCKS or b % bb:
        raise ValueError(f"{name}: bb must be one of {ROW_BLOCKS} and divide B={b}, not {bb}")


def _raise_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _device(name: str, q: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")


def probe_stream(q: torch.Tensor, k4_all: torch.Tensor, v4_all: torch.Tensor, layer: int, *,
                 bb: int = 1, joint: bool = False) -> torch.Tensor:
    """The stream-only floor (#8 ``s``) on layer ``layer`` of the stacked
    int4 cache: the checksum of ``probe_stream_reference``, shaped like q.
    ``bb`` rows and one time chunk a block, the rows walked in turn
    (``joint=False``) or a warp group each (``joint=True``)."""
    if q.device.type == "cpu":
        return probe_stream_reference(q, k4_all, v4_all, layer)
    _device("probe_stream", q)
    half = _int4_cols("probe_stream", k4_all)
    b, h, k_ptr, v_ptr = _layer_args("probe_stream", q, k4_all, v4_all, layer,
                                     (DH, half), (half, DH))
    _check_bb("probe_stream", b, bb)
    if h > 32:
        raise ValueError(f"probe_stream: at most 32 heads (a lane each in the combine), not {h}")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rows_at_once = bb if joint else 1
    counters, work = _scratch(q, stream, "probe_stream", b // bb,
                              b * h * _chunks(half, True, bb, rows_at_once), torch.int32)
    rc = _library().probe_stream_launch(k_ptr, v_ptr, out.data_ptr(), work.data_ptr(),
                                        counters.data_ptr(), b, h, DH, half, bb, rows_at_once,
                                        stream)
    _raise_rc("probe_stream", rc)
    probe_stream.launches += 1
    return out


probe_stream.launches = 0


def int4_rows(q: torch.Tensor, k4_all: torch.Tensor, v4_all: torch.Tensor, layer: int, *,
              valid_len: int, unpack: str = "packed", bb: int = 1, joint: bool = False,
              bf16: bool = False) -> torch.Tensor:
    """Kernel B's function on layer ``layer`` of the stacked int4 cache,
    f32 products on CUDA cores, ``bb`` batch rows a block: nibbles by
    ``unpack`` "byte" (an int-to-float each, v3.1) or "packed" (kernel B's
    magic number); the rows walked in turn (``joint=False``, #8 a) or a
    warp group each (``joint=True``, #8 b-e);
    ``bf16`` rounds q and P to bf16 first (#9 ``i4_bf16``), P with the row's
    global max, which a row and head's chunks exchange as one cluster: at
    most ``MAX_CLUSTER_CHUNKS`` chunks."""
    if q.device.type == "cpu":
        return int4_rows_reference(q, k4_all, v4_all, layer, valid_len=valid_len, bf16=bf16)
    _device("int4_rows", q)
    half = _int4_cols("int4_rows", k4_all)
    b, h, k_ptr, v_ptr = _layer_args("int4_rows", q, k4_all, v4_all, layer, (DH, half),
                                     (half, DH), valid_len, 2 * half)
    _check_bb("int4_rows", b, bb)
    joint = joint and bb > 1
    if (unpack, bb, joint, bf16) not in INT4_ROWS_VARIANTS:
        raise ValueError(f"int4_rows: no instantiation for unpack={unpack!r}, bb={bb}, "
                         f"joint={joint}, bf16={bf16}")
    rows_at_once = bb if joint else 1
    chunks = _chunks((valid_len + 1) // 2, False, bb, rows_at_once)
    if bf16 and chunks > MAX_CLUSTER_CHUNKS:
        raise ValueError(f"int4_rows: bf16 takes at most {MAX_CLUSTER_CHUNKS} chunks (one cluster), "
                         f"not {chunks} for valid_len {valid_len}")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    counters, work = _scratch(q, stream, "int4_rows", b // bb * h, b * h * chunks * (DH + 2),
                              torch.float32)
    rc = _library().int4_rows_launch(q.data_ptr(), k_ptr, v_ptr, out.data_ptr(), work.data_ptr(),
                                     counters.data_ptr(), b, h, DH, half, valid_len,
                                     1.0 / math.sqrt(DH), int(unpack == "byte"), bb,
                                     rows_at_once, int(bf16), stream)
    _raise_rc("int4_rows", rc)
    int4_rows.launches += 1
    return out


int4_rows.launches = 0


def int8_dot(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor, layer: int, *,
             valid_len: int, cache: str = "int4", pv: str = "int8") -> torch.Tensor:
    """q row-quantised to int8, q.K (and, with ``pv="int8"``, P.V at the
    static scale 127) as exact int32 sums by dp4a, on layer ``layer`` of
    the stacked int4 cache (``cache="int4"``, K (L,B,H,Dh,Tpad/2)) or int8
    cache (``cache="int8"``, K (L,B,H,Dh,Tpad), V (L,B,H,Tpad,Dh))."""
    if q.device.type == "cpu":
        return int8_dot_reference(q, k_all, v_all, layer, valid_len=valid_len, cache=cache, pv=pv)
    _device("int8_dot", q)
    if (cache, pv) not in INT8_DOT_VARIANTS:
        raise ValueError(f"int8_dot: no instantiation for cache={cache!r}, pv={pv!r}")
    cols = _int4_cols("int8_dot", k_all)
    max_valid = 2 * cols if cache == "int4" else cols
    b, h, k_ptr, v_ptr = _layer_args("int8_dot", q, k_all, v_all, layer, (DH, cols), (cols, DH),
                                     valid_len, max_valid)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _library().int8_dot_launch(q.data_ptr(), k_ptr, v_ptr, out.data_ptr(), b, h, DH, cols,
                                    valid_len, 1.0 / math.sqrt(DH), int(cache == "int4"),
                                    int(pv == "int8"), stream)
    _raise_rc("int8_dot", rc)
    int8_dot.launches += 1
    return out


int8_dot.launches = 0
