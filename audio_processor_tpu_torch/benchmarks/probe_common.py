"""Shared parts of the port's kernel-B probes: the JAX probes' shapes, seeded
caches, each variant and its H100 counterpart, gates, timing and bounds.

Every variant computes kernel B's function, or a quantised form of it, on
one layer of a stacked cache at whisper-small's widths: L=12 layers, H=12
heads of Dh=64, Tpad=1536 of which 1500 positions are valid.  The caches
hold the ints [-7, 7] (as the JAX probes make them), nibble-packed for the
int4 variants; the int8 variants read the same ints unpacked.
"""
from __future__ import annotations

import dataclasses
import math
import subprocess
import sys
import time
from typing import Callable

import numpy as np
import torch

from ..ops.kernels import decode_attention as da
from ..ops.kernels import probe_attention as pa

L, H, DH, TPAD, VALID = 12, 12, 64, 1536, 1500
# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}
# the gates against the plain version on the card, integer units (|x| <= 7):
# exact functions take kernel B's; a bf16 or p8 rounding can flip where the
# card's expf differs from torch's by an ulp
EXACT_TOL, QUANT_TOL = 5e-4, 2e-3
# int-to-float conversions a clock an SM (the CUDA C++ Programming Guide's
# arithmetic-instruction throughput table, compute capability 9.0): v3.1's
# byte-wise unpack converts every nibble with one
I2F_PER_CLOCK_SM = 16


@dataclasses.dataclass(frozen=True)
class Variant:
    label: str            # the JAX probe's name for the variant
    replaces: str         # its body in the JAX package, file:line
    kernel: str           # the port's wrapper that launches it (its launch counter)
    counterpart: str      # what runs on the H100
    cache: str            # "int4" or "int8"
    products: tuple       # the types of q.K and P.V (the operations bound); () streams
    call: Callable        # (q, k_all, v_all, layer) -> (B, 1, H, Dh) float32
    plain: Callable       # its plain version, the same arguments
    tol: float | None     # gate against the plain version; None: bit-equal
    stream: tuple         # (bb, joint) of the stream floor it is compared with
    i2f: bool = False     # an int-to-float a nibble (v3.1): bounded by those too


def _kernel_b(q, k, v, l):
    return da.cross_attention_int4_stacked(q, k, v, l, valid_len=VALID)


def _kernel_b_plain(q, k, v, l):
    return da.cross_attention_int4_reference(q, k[l], v[l], valid_len=VALID)


def _rows(**kw):
    return (lambda q, k, v, l: pa.int4_rows(q, k, v, l, valid_len=VALID, **kw),
            lambda q, k, v, l: pa.int4_rows_reference(q, k, v, l, valid_len=VALID,
                                                      bf16=kw.get("bf16", False)))


def _dot(**kw):
    return (lambda q, k, v, l: pa.int8_dot(q, k, v, l, valid_len=VALID, **kw),
            lambda q, k, v, l: pa.int8_dot_reference(q, k, v, l, valid_len=VALID, **kw))


KERNEL_B = "kernel B, cross_attention_int4_stacked (csrc/cross_attn_int4.cu)"
V32 = "benchmarks/kernel_v32_probe.py"
V34 = "benchmarks/kernel_v34_probe.py"
V4 = "benchmarks/kernel_v4_probe.py"


def variants(probe: str, bb: int = 8) -> dict[str, Variant]:
    """The variants of one JAX probe ("v32", "v34" or "v4"), keyed by its
    labels; ``bb`` is the v34 probe's rows a block."""
    f32, i8, bf = "f32", "int8", "bf16"
    if probe == "v32":
        return {
            "v3.1": Variant("v3.1", f"{V32}:117 (fast_unpack=False)", "int4_rows",
                            "P2 int4_rows(unpack=byte, bb=1)", "int4", (f32, f32),
                            *_rows(unpack="byte"), EXACT_TOL, (1, False), i2f=True),
            "v3.2": Variant("v3.2", f"{V32}:117 (fast_unpack=True)", "cross_attention_int4_stacked",
                            KERNEL_B, "int4", (f32, f32), _kernel_b, _kernel_b_plain, EXACT_TOL,
                            (1, False)),
            "v3.3mxu": Variant("v3.3mxu", f"{V32}:56", "int8_dot",
                               "P3 int8_dot(cache=int4, pv=int8)", "int4", (i8, i8),
                               *_dot(cache="int4", pv="int8"), QUANT_TOL, (1, False)),
        }
    if probe == "v34":
        out = {"v32": Variant("v32", f"{V34}:292", "cross_attention_int4_stacked", KERNEL_B,
                              "int4", (f32, f32), _kernel_b, _kernel_b_plain, EXACT_TOL,
                              (1, False))}
        lines = {"a": 58, "b": 93, "c": 127, "d": 168, "e": 202}
        for x, at in lines.items():
            joint = x != "a" and bb > 1
            out[x] = Variant(x, f"{V34}:{at}", "int4_rows",
                             f"P2 int4_rows(unpack=packed, bb={bb}, joint={joint})", "int4",
                             (f32, f32), *_rows(bb=bb, joint=joint), EXACT_TOL, (bb, joint))
        out["s"] = Variant(
            "s", f"{V34}:235", "probe_stream", f"P1 probe_stream(bb={bb})", "int4", (),
            lambda q, k, v, l: pa.probe_stream(q, k, v, l, bb=bb),
            pa.probe_stream_reference, None, (bb, False))
        return out
    if probe == "v4":
        return {
            "v31": Variant("v31", f"{V4}:230 (da.cross_attention_int4_stacked)",
                           "cross_attention_int4_stacked", KERNEL_B, "int4", (f32, f32),
                           _kernel_b, _kernel_b_plain, EXACT_TOL, (1, False)),
            "i8_f32": Variant(
                "i8_f32", f"{V4}:64", "cross_attention_int8",
                "kernel #3, cross_attention_int8 (csrc/cross_attn_int8.cu) on k8[l], v8[l]",
                "int8", (f32, f32),
                lambda q, k, v, l: da.cross_attention_int8(q, k[l], v[l], valid_len=VALID),
                lambda q, k, v, l: da.cross_attention_int8_reference(q, k[l], v[l],
                                                                     valid_len=VALID),
                EXACT_TOL, (1, False)),
            "i8_mxu_k": Variant("i8_mxu_k", f"{V4}:85", "int8_dot",
                                "P3 int8_dot(cache=int8, pv=f32)", "int8", (i8, f32),
                                *_dot(cache="int8", pv="f32"), QUANT_TOL, (1, False)),
            "i8_mxu_kv": Variant("i8_mxu_kv", f"{V4}:102", "int8_dot",
                                 "P3 int8_dot(cache=int8, pv=int8)", "int8", (i8, i8),
                                 *_dot(cache="int8", pv="int8"), QUANT_TOL, (1, False)),
            "i4_mxu_kv": Variant("i4_mxu_kv", f"{V4}:169", "int8_dot",
                                 "P3 int8_dot(cache=int4, pv=int8)", "int4", (i8, i8),
                                 *_dot(cache="int4", pv="int8"), QUANT_TOL, (1, False)),
            "i4_bf16": Variant("i4_bf16", f"{V4}:122", "int4_rows",
                               "P2 int4_rows(unpack=packed, bb=1, bf16=True)", "int4",
                               (bf, bf), *_rows(bf16=True), QUANT_TOL, (1, False)),
        }
    raise ValueError(f"unknown probe {probe!r}")


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def make_inputs(batch: int, device, *, int4: bool = True, int8: bool = False,
                seed: int = 0) -> dict:
    """q (B, 1, H, Dh) ~ N(0, 1) and the stacked caches of the ints [-7, 7]:
    ``k4``/``v4`` nibble-packed (int4), ``k8``/``v8`` as they are (int8).
    Made a layer at a time (a bounded transient), by numpy on the CPU and a
    seeded torch.Generator on the card."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    g = torch.Generator(device=device).manual_seed(seed) if on_card else None
    rng = None if on_card else np.random.default_rng(seed)

    def ints(shape):
        if on_card:
            return torch.randint(-7, 8, shape, device=device, generator=g, dtype=torch.int8)
        return torch.from_numpy(rng.integers(-7, 8, shape).astype(np.int8))

    out = {}
    if int4:
        out["k4"] = torch.empty((L, batch, H, DH, TPAD // 2), dtype=torch.int8, device=device)
        out["v4"] = torch.empty((L, batch, H, TPAD // 2, DH), dtype=torch.int8, device=device)
    if int8:
        out["k8"] = torch.empty((L, batch, H, DH, TPAD), dtype=torch.int8, device=device)
        out["v8"] = torch.empty((L, batch, H, TPAD, DH), dtype=torch.int8, device=device)
    for layer in range(L):
        k8, v8 = ints((batch, H, DH, TPAD)), ints((batch, H, TPAD, DH))
        if int4:
            out["k4"][layer], out["v4"][layer] = da.pack_int4_time(k8, v8)
        if int8:
            out["k8"][layer], out["v8"][layer] = k8, v8
    if on_card:
        out["q"] = torch.randn(batch, 1, H, DH, device=device, generator=g)
    else:
        out["q"] = torch.from_numpy(rng.normal(size=(batch, 1, H, DH)).astype(np.float32))
    return out


def cache_of(v: Variant, data: dict) -> tuple[torch.Tensor, torch.Tensor]:
    return (data["k4"], data["v4"]) if v.cache == "int4" else (data["k8"], data["v8"])


def gate(v: Variant, data: dict, layers=(0, L - 1)) -> float:
    """Max abs difference from the plain version over ``layers``; raises
    AssertionError past the variant's gate (bit-equality for the stream)."""
    k, vc = cache_of(v, data)
    worst = 0.0
    for layer in layers:
        got = v.call(data["q"], k, vc, layer)
        ref = v.plain(data["q"], k, vc, layer)
        if got.shape != ref.shape or not torch.isfinite(got).all():
            raise AssertionError(f"{v.label} layer {layer}: shape {tuple(got.shape)} or non-finite")
        err = (got - ref).abs().max().item()
        if v.tol is None and not torch.equal(got, ref):
            raise AssertionError(f"{v.label} layer {layer}: not bit-equal to its plain version")
        if v.tol is not None and not err <= v.tol:
            raise AssertionError(f"{v.label} layer {layer}: max abs err {err} > {v.tol}")
        worst = max(worst, err)
    return worst


# ---------------------------------------------------------------------------
# Timing and bounds
# ---------------------------------------------------------------------------

def step_ms(call, q, k, v, steps: int, runs: int = 3) -> float:
    """ms per 12-layer decode step, as the JAX probes time it: ``steps``
    steps of q <- q * 0.999 + (sum over layers of call) * 1e-6 (a data
    dependence across steps), the least of ``runs`` runs after a warm one.
    CUDA events on the card; the host clock on the CPU (not a device time)."""
    def run():
        qq = q
        for _ in range(steps):
            acc = torch.zeros_like(qq)
            for layer in range(L):
                acc = acc + call(qq, k, v, layer)
            qq = qq * 0.999 + acc * 1e-6
        return qq

    on_card = q.device.type == "cuda"
    run()
    if on_card:
        torch.cuda.synchronize()
    best = math.inf
    for _ in range(runs):
        if on_card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            run()
            best = min(best, (time.perf_counter() - t0) * 1e3)
    return best / steps


def device_call_ms(fn, iters: int = 24) -> float:
    """Device time per call of fn(layer), the layers cycled, from
    torch.profiler's kernel events (short calls would otherwise time the
    host's launch).  fn launches one kernel a call: a session that records
    another number of kernel runs (seen on the card: none, or part of them)
    is taken again, and after three such sessions the calls are timed by
    CUDA events instead, with a note on stderr."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i % L)
            torch.cuda.synchronize()
        total, runs = 0.0, 0
        for e in prof.key_averages():
            if getattr(e, "device_type", None) == DeviceType.CUDA:
                us = getattr(e, "self_device_time_total", None)
                total += us if us is not None else getattr(e, "self_cuda_time_total", 0.0)
                runs += e.count
        if runs == iters and total > 0:
            return total / 1e3 / iters
    print(f"probe: the profiler recorded {runs} kernel runs for {iters} calls; timing by "
          "CUDA events", file=sys.stderr, flush=True)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % L)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(v: Variant, batch: int) -> tuple[float, str]:
    """The least time the card could take for one call: the larger of the
    bytes it must move (the valid K/V bytes, q in, out; the stream reads
    every byte of the blocks) over 3.35 TB/s, and its products (2
    operations a multiply-add, q.K and P.V over the valid positions) over
    the peak for their type."""
    rows = batch * H
    io = 2 * 4 * rows * DH
    if not v.products:
        return (rows * DH * TPAD + io) / PEAK_BYTES_PER_S * 1e3, "bytes"
    cache = 2 * rows * DH * (math.ceil(VALID / 2) if v.cache == "int4" else VALID)
    t_bytes = (cache + io) / PEAK_BYTES_PER_S * 1e3
    t_ops = sum(2 * rows * DH * VALID / PEAK_OPS_PER_S[p] for p in v.products) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_sm_clock_hz() -> float | None:
    """The card's maximum SM clock as nvidia-smi gives it (None without)."""
    proc = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                           "--format=csv,noheader,nounits"],
                          capture_output=True, text=True, timeout=60)
    try:
        return float(proc.stdout.split()[0]) * 1e6
    except (IndexError, ValueError):
        return None


def i2f_bound_ms(batch: int) -> float | str:
    """The byte-wise unpack's least time by its conversions: one a valid
    nibble of K and V (2 B H Dh VALID) at I2F_PER_CLOCK_SM a clock on every
    SM of the card at its maximum SM clock."""
    clock = max_sm_clock_hz()
    if clock is None:
        return "not measured (no SM clock from nvidia-smi)"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 2 * batch * H * DH * VALID / (I2F_PER_CLOCK_SM * sms * clock) * 1e3


def sdpa_call(data: dict, cache: str):
    """One PyTorch call for the same attention (the yardstick, never used by
    the port): SDPA on layer 0's K/V dequantised to bf16 in time order,
    valid positions only."""
    q = data["q"]
    if cache == "int4":
        lo, hi = da._unpack_nibbles_u(data["k4"][0])
        k_t = torch.stack([lo, hi], dim=-1).flatten(-2)[..., :VALID] - 8
        lo, hi = da._unpack_nibbles_u(data["v4"][0])
        v_t = torch.stack([lo, hi], dim=-2).flatten(-3, -2)[:, :, :VALID] - 8
    else:
        k_t, v_t = data["k8"][0][..., :VALID], data["v8"][0][:, :, :VALID]
    k_bf = k_t.transpose(-1, -2).to(torch.bfloat16).contiguous()
    v_bf = v_t.to(torch.bfloat16).contiguous()
    q_bf = q.transpose(1, 2).to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(q_bf, k_bf, v_bf)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 else "not measured"


def describe(device: torch.device) -> str:
    if device.type == "cpu":
        return "cpu: the plain versions, timed by the host clock (not a device time)"
    return f"{torch.cuda.get_device_name(device)} ({card_line()})"


def measure(v: Variant, data: dict, steps: int, floors: dict) -> dict:
    """One variant's numbers at the data's batch: ms per 12-layer step (the
    probe's own timing), and on the card the device ms a call, the stream
    floor's (P1 at the variant's rows a block, kept in ``floors``) and their
    ratio ``stream_share``, beside the bound."""
    q = data["q"]
    k, vc = cache_of(v, data)
    batch = q.shape[0]
    res = {"label": v.label, "counterpart": v.counterpart, "replaces": v.replaces,
           "kernel": v.kernel, "batch": batch, "step_ms": step_ms(v.call, q, k, vc, steps)}
    res["bound_ms"], res["bound_by"] = bound_ms(v, batch)
    if q.device.type != "cuda":
        res.update(call_ms="not measured (cpu)", stream_ms="not measured (cpu)",
                   stream_share="not measured (cpu)")
        return res
    res["call_ms"] = device_call_ms(lambda layer: v.call(q, k, vc, layer))
    if v.i2f:
        res["i2f_bound_ms"] = i2f_bound_ms(batch)
    if "k4" not in data:
        res.update(stream_ms="not measured (no int4 cache)", stream_share="not measured")
        return res
    if v.stream not in floors:
        bb, joint = v.stream
        floors[v.stream] = device_call_ms(
            lambda layer: pa.probe_stream(q, data["k4"], data["v4"], layer, bb=bb, joint=joint))
    res["stream_ms"] = floors[v.stream]
    res["stream_share"] = res["call_ms"] / res["stream_ms"]
    return res


def line(res: dict) -> str:
    """A variant's printed line: its times, bound and H100 counterpart."""
    def num(x):
        return f"{x:.5f}" if isinstance(x, float) else str(x)

    i2f = f" (I2F bound {num(res['i2f_bound_ms'])} ms)" if "i2f_bound_ms" in res else ""
    return (f"{res['label']:10s} {res['step_ms']:9.4f} ms / {L}-layer step   "
            f"{num(res['call_ms'])} ms a call (device)   bound {res['bound_ms']:.5f} ms "
            f"({res['bound_by']}){i2f}   stream_share {num(res['stream_share'])}   "
            f"H100: {res['counterpart']}")
