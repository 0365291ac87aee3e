"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --tp-only       # sharded serving alone, e.g. on a card per rank
    python3 chip_smoke.py --probes-only   # the build and kernel B's design probes alone

Builds the port's CUDA kernels from ``audio_processor_tpu_torch/csrc`` (one
nvcc per source, all at once), holds each against its plain PyTorch version
at the main path's shapes and times it, checks the whole chain card vs CPU
on a small config (greedy, int8-kernel greedy, beam, prompted, fused
encoder), drives ``Transcriber.transcribe`` at whisper-small width with
random weights on its default path and with openai-whisper's CLI defaults
(beam 5, conditioned on the previous text, an initial prompt carried to
every window) through the fused encoder, and runs the bench workload
(log-mel + encode + 96-token decode, bf16, EOT suppressed) in its
variants: int4 greedy at batch 32 and at the default slab of 128, the
fused encoder at 128, the int8 kernel decode at 32 and beam 5 at 32.
Sharded serving: kernel #5 on each emulated model rank's shard against
kernel B's full-head output and its plain version, then worlds of 2
(dp1 x tp2) and 4 (dp2 x tp2) ranks, one process each (NCCL with a card
per rank, else gloo with the ranks sharing the card), each holding the
small config's tokens to the single-card decode and transcribing 2 min at
whisper-small width (the default 224-token cap).  The mesh paths ride in
those worlds, at the bench's 96-token cap where they decode:
``transcribe_words_tp`` (words, the hallucination filter and the int8 self
cache on both meshes; the check config's f32 words held to the single
card's), and in the 4-rank world ``int8_weights_dp`` (a second mesh,
dp4 x tp1: int8 decoder weights, the check config's tokens held to the
single card's, the bench's int8 line at 32; tp=2 must refuse them),
``diarize_tp`` (the bundled Diarizer on dp2 x tp2: f32 activations and
turns held to the single card's, the 30 min meeting timed) and
``serve_tp`` (``build_services`` under APTPU_DISTRIBUTED=1: rank 0 serves
three 2 min meetings and a word-granularity ``/v1`` request over HTTP,
the other ranks follow its calls until the stop message; the ``serve``
phase runs the same three jobs in one process at that cap beside them).  Kernel B's design probes (#7, #8, #9): every variant
of the three probes at their default batches held to its plain version,
then driven as its probe drives it and timed beside its bound, the stream
floor and SDPA; a ``probes_split`` line sets P1's and P2's times beside their
first design's (no split of the time axis) and their bounds.  The service (``serve``): ``build_services`` at whisper-small
width with the bundled diarizer, ``create_app`` on a local port, three
2 min meetings through the job API at once (all 9 stages, one job held to
direct calls, kernels A and B counted), four concurrent ``/v1`` uploads
through the dynamic batcher.  Ingest (``ingest``, after the bench lines):
the port's C++ WAV decoder, built with g++, on a seeded 10 min 44.1 kHz
stereo WAV through ``ingest.load_audio`` against the Python reader +
``resample_host`` (2e-7), each C entry point timed; then the media build's
state: without the libav headers one ``media`` line says so, with them a
failed build fails the run, and a 4 min .m4a (``encode_m4a``) is gated
against its WAV twin, the ``transcribe`` cell runs from its path (tokens
equal to the decoded array's) and a 2 min meeting .m4a runs the 9 stages
at 96 tokens, kernels A and B counted.  Config 2's frontend
(``device_frontend``, after ingest): 10 min of 44.1 kHz audio, config 2's
own signal and a recording whose pauses reach the trim's cut, through the
host chain (native resample, ``trim_silence_host``, int16 windows, kernel
A) and the device chain (int16 to the card, ``resample``,
``silence_mask``, the mask's intervals on the host,
``gather_kept_intervals``, kernel A), each timed (median of 3) with the
device chain's stages by CUDA events; the card's mask held to the CPU's,
the gather bit-equal to the host concatenation, kernel A to the plain
log-mel in float64, kernel A counted.  Word timestamps (``transcribe_words``): the
``transcribe`` workload with word_timestamps, the hallucination filter and
the int8 self cache, its teacher-forced pass, host chain and DTW (the C++
function against its numpy twin on the phase's own costs) timed apart,
and a bench line on int8 decoder weights with the int8 self cache.
Diarization, last: kernel A on the segmentation net's
10 s and 6 s windows at a slab of 128, the bundled Diarizer on the card
against the CPU in float32 and against the JAX suite's quality gates at
its bf16 default, fusion of the card's and the CPU's turns, then a 30 min
4-speaker meeting through ``Diarizer.bundled()`` and through the configs'
published widths, timed stage by stage.  Conversion (``convert``):
whisper-small from seeded weights written as an openai ``.pt`` and an HF
directory, through ``convert-whisper`` (every leaf bit-equal; the 4 min
transcript from the converted ``.npz`` equal to the source params'), and a
PyanNet + ResNet34 pack through ``convert-diarizer`` (the 30 min meeting's
turns equal).  Training (``train``): ``finetune-whisper`` at whisper-small
width in float32 (step 0 held to the CPU), ``train-segmentation``,
``train-embedding`` and ``calibrate-alignment-heads --write``, each timed a
step; ``--tp-only`` adds one sharded train step on dp1 x tp2 and dp2 x tp2
held to one process.  The bundled diarizer's builder and the parity tool
(``bundled_diarizer``, last): ``tools/make_bundled_diarizer``'s held-out
gates on the committed assets at its full settings (a failed gate ends
the run), its two trainers for 20 steps at its batches (kernel A counted,
the ``--from-cache`` reload bit-equal), and ``tools/verify_parity`` on a
seeded Whisper case (the card's transcript equal to the CPU's, a changed
text failing, ``main``'s records).
Prints one JSON line per phase, the kernel table, the card's name and
power limit, and, last, ``{"ok": true, "device": {...}}``.  Exits non-zero,
with no result line, when there is no card, when the port is not beside
this script, or when any phase or any rank fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import queue
import socket
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12  # dense, tensor cores


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str, code: int = 1) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0:
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def sass_i2f(build, name: str) -> dict | str:
    """I2F instructions (I2F and I2FP alike) in each kernel, by mangled name,
    of a built library's SASS (cuobjdump beside nvcc), or "not measured"
    without cuobjdump."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return "not measured (no cuobjdump beside nvcc)"
    proc = subprocess.run([tool, "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0 or "PRMT" not in proc.stdout:
        fail(f"cuobjdump -sass {name}: {proc.stderr.strip()[-500:]}")
    counts = {}
    for part in proc.stdout.split("Function : ")[1:]:
        fn, body = part.split("\n", 1)
        counts[fn.strip()] = sum("I2F" in ln for ln in body.splitlines())
    return counts


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over iters calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_rows(fn, cpu_ops: bool = True) -> list[tuple[float, str, int]]:
    """(device ms, kernel name, calls) of every kernel fn() launches, from
    torch.profiler's kernel events (an aten op's row repeats its kernels'
    time, so only kernel rows count), largest first.  ``cpu_ops=False``
    records the card's activity alone: the same kernel rows, with far less
    of the profiler's host overhead (no CPU op events to record and to
    build), but now and then a kernel at a run's edge missed, so the
    timed kernel calls keep the CPU ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] * cpu_ops + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.key, e.count))
    return sorted(rows, reverse=True)


def device_ms(fn, iters: int) -> float:
    """Mean device time per call of fn's kernels: for calls shorter than
    their host launch overhead, where CUDA events would time the host.
    Now and then a profiler session records no kernel at all (seen on the
    card): up to three sessions are tried, then the call is timed by CUDA
    events, with a note on stderr, so that the kernel line keeps a number."""
    fn()
    for _ in range(3):
        rows = kernel_rows(lambda: [fn() for _ in range(iters)])
        if rows:
            return sum(r[0] for r in rows) / iters
    print("chip_smoke: the profiler recorded no kernel time in 3 sessions; "
          "timing by CUDA events", file=sys.stderr, flush=True)
    return time_ms(fn, iters)


def bound_ms(n_bytes: float, n_flops: float, peak_flops: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_log_mel(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """torch.stft-based Whisper log-mel: kernel A's yardstick, never used by
    the port."""
    from audio_processor_tpu_torch.ops import frontend

    window = torch.hann_window(frontend.N_FFT, device=audio.device)
    filters = torch.from_numpy(frontend.mel_filterbank(n_mels)).to(audio.device)
    spec = torch.stft(audio, frontend.N_FFT, frontend.HOP_LENGTH, window=window,
                      center=True, pad_mode="reflect", return_complex=True)
    mel = filters @ spec[..., :-1].abs().square()
    log_spec = torch.clamp(mel, min=1e-10).log10()
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(-2, -1), keepdim=True) - 8.0)
    return (log_spec + 4.0) / 4.0


def log_mel_bounds(rows: int, n: int) -> tuple[float, str, float, float]:
    """(function bound, its limit, DFT-as-matmul bound, four-step bound) in
    ms for ``rows`` windows of ``n`` samples at 80 mels.  Bytes: audio in
    and log-mel out once a window, the kernel's tables once a call."""
    from audio_processor_tpu_torch.ops import frontend
    from audio_processor_tpu_torch.ops.kernels.log_mel import four_step_tables

    frames = n // frontend.HOP_LENGTH
    n_fft, n_freqs = frontend.N_FFT, frontend.N_FREQS
    tables = four_step_tables(80)
    nbytes = rows * (4 * n + 4 * frames * 80) + sum(a.nbytes for a in tables.values())
    # operations the function needs: per frame, the window multiply, a
    # real FFT (2.5 N log2 N, half a complex FFT's 5 N log2 N), power (3
    # a bin), the mel projection (2 a non-zero of the filterbank: the
    # zeros add nothing) and the log and clamp (3 a mel)
    per_frame = (n_fft + 2.5 * n_fft * math.log2(n_fft) + 3 * n_freqs
                 + 2 * tables["weights"].size + 3 * 80)
    fn_ms, by = bound_ms(nbytes, rows * frames * per_frame)
    # the TPU kernel's algorithm (this kernel's first port): the DFT as two matmuls
    # against the (400, 201) bases, about 8x the operations of the FFT
    dft = rows * frames * (2 * 2 * n_fft * n_freqs + 2 * n_freqs * 80)
    # this kernel's: stage 1 (20 n2 x 11 k1 x 20 n1, re and im), stage 2
    # (201 kept bins x 20 n2, a complex multiply-add each), power, the
    # sparse mel (the filters' non-zeros) and the log and clamp
    four = rows * frames * (2 * 2 * 20 * 11 * 20 + 8 * n_freqs * 20 + 3 * n_freqs
                            + 2 * tables["weights"].size + 3 * 80)
    return fn_ms, by, bound_ms(nbytes, dft)[0], bound_ms(nbytes, four)[0]


def speech_like(seconds: float, seed: int, sr: int = 16_000) -> np.ndarray:
    """Seeded synthetic 'speech': AM-modulated harmonics, noise, pauses."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.5 * t)
    sig = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 6))
    envelope = (np.sin(2 * np.pi * 1.3 * t) > -0.2).astype(np.float32)
    sig = sig * envelope * 0.3 + rng.normal(0, 0.01, len(t))
    return sig.astype(np.float32)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_log_mel(dev, kernels) -> dict:
    from audio_processor_tpu_torch.ops import frontend
    from audio_processor_tpu_torch.ops.kernels.log_mel import log_mel

    g = torch.Generator(device=dev).manual_seed(0)
    b, n = 8, frontend.N_SAMPLES
    audio = torch.randn(b, n, device=dev, generator=g) * 0.2
    audio[1] *= 1e-3  # one quiet window
    out = {"phase": "log_mel", "batch": b}
    for n_mels in (80, 128):
        got = log_mel(audio, n_mels)
        torch.cuda.synchronize()
        ref = frontend.log_mel_spectrogram(audio, n_mels)
        err = (got - ref).abs().max().item()
        if not (got.shape == ref.shape == (b, n_mels, frontend.N_FRAMES)) or not err <= 1e-4:
            fail(f"log_mel n_mels={n_mels}: max abs err {err} > 1e-4 or bad shape")
        out[f"max_abs_err_{n_mels}"] = err

    def library():
        return library_log_mel(audio)

    lib_err = (library() - frontend.log_mel_spectrogram(audio, 80)).abs().max().item()
    frames = n // frontend.HOP_LENGTH

    def bounds(rows):
        return log_mel_bounds(rows, n)

    bms, by, dft_bms, four_bms = bounds(b)
    ms = time_ms(lambda: log_mel(audio, 80), iters=20)
    plain = time_ms(lambda: frontend.log_mel_spectrogram(audio, 80), iters=5)
    lib = time_ms(library, iters=10)
    out.update(kernel_ms=ms, plain_ms=plain, library_ms=lib, library_max_abs_err=lib_err,
               bound_ms=bms, bound_by=by, dft_algorithm_bound_ms=dft_bms,
               algorithm_bound_ms=four_bms, n_mels_timed=80)
    del audio
    # the bench's batch and the default slab: 128 windows
    big = 128
    audio = torch.randn(big, n, device=dev, generator=g) * 0.2
    got = log_mel(audio, 80)
    torch.cuda.synchronize()
    err = (got - frontend.log_mel_spectrogram(audio, 80)).abs().max().item()
    if not err <= 1e-4:
        fail(f"log_mel B={big}: max abs err {err} > 1e-4")
    out.update(max_abs_err_b128=err, kernel_ms_b128=time_ms(lambda: log_mel(audio, 80), iters=10),
               library_ms_b128=time_ms(library, iters=5))
    out["bound_ms_b128"], _, out["dft_algorithm_bound_ms_b128"], out["algorithm_bound_ms_b128"] = \
        bounds(big)
    kernels["log_mel"] = dict(
        name="log_mel", route="cuda", source="audio_processor_tpu_torch/csrc/log_mel.cu",
        replaces="audio_processor_tpu/ops/pallas/mel_kernel.py:61",
        max_abs_err=max(out["max_abs_err_80"], out["max_abs_err_128"], err),
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
        dft_algorithm_bound_ms=dft_bms, algorithm_bound_ms=four_bms,
        shape=f"audio ({b}, {n}) f32 -> ({b}, 80, {frames})",
        ms_b128=out["kernel_ms_b128"], library_ms_b128=out["library_ms_b128"],
        bound_ms_b128=out["bound_ms_b128"],
    )
    return out


def _sdpa_on_dequantized(q, k_t, v_t):
    """SDPA on K/V in time order (valid positions) as bf16: the yardstick
    of the decode kernels; q (B, Tq, H, Dh), k_t (B, H, Dh, T), v_t (B, H, T, Dh)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    k_bf = k_t.transpose(-1, -2).to(torch.bfloat16).contiguous()
    v_bf = v_t.to(torch.bfloat16).contiguous()
    q_bf = q.transpose(1, 2).to(torch.bfloat16)
    return lambda: sdpa(q_bf, k_bf, v_bf)


def phase_cross_attn(dev, kernels) -> dict:
    from audio_processor_tpu_torch.ops.kernels import decode_attention as da

    n_layers, b, h, dh, tpad, valid = 12, 128, 12, 64, 1536, 1500
    g = torch.Generator(device=dev).manual_seed(1)
    k4 = torch.empty((n_layers, b, h, dh, tpad // 2), dtype=torch.int8, device=dev)
    v4 = torch.empty((n_layers, b, h, tpad // 2, dh), dtype=torch.int8, device=dev)
    for l in range(n_layers):  # pack one layer at a time (bounded transient)
        k8 = torch.randint(-7, 8, (b, h, dh, tpad), device=dev, generator=g, dtype=torch.int8)
        v8 = torch.randint(-7, 8, (b, h, tpad, dh), device=dev, generator=g, dtype=torch.int8)
        k4[l], v4[l] = da.pack_int4_time(k8, v8)
    del k8, v8
    out = {"phase": "cross_attn_int4", "shape": [n_layers, b, h, dh, tpad], "valid_len": valid}
    worst = 0.0
    for tq in (1, 4):
        q = torch.randn(b, tq, h, dh, device=dev, generator=g) * 0.1
        for l in (0, n_layers - 1):
            got = da.cross_attention_int4_stacked(q, k4, v4, l, valid_len=valid)
            torch.cuda.synchronize()
            ref = da.cross_attention_int4_reference(q, k4[l], v4[l], valid_len=valid)
            err = (got - ref).abs().max().item()
            # integer-unit outputs (|x| <= 7), f32 sums over 1536 keys in
            # another order than the plain version's
            if not err <= 5e-4:
                fail(f"cross_attn_int4 tq={tq} layer={l}: max abs err {err} > 5e-4")
            worst = max(worst, err)
            out[f"max_abs_err_tq{tq}_l{l}"] = err

    q = torch.randn(b, 1, h, dh, device=dev, generator=g) * 0.1
    layer_iter = iter(range(10**9))

    def kernel():  # cycle the layers: each call streams one layer from HBM
        return da.cross_attention_int4_stacked(q, k4, v4, next(layer_iter) % n_layers, valid_len=valid)

    ms = time_ms(kernel, iters=48)
    plain = time_ms(lambda: da.cross_attention_int4_reference(q, k4[0], v4[0], valid_len=valid), iters=3)

    # yardstick: the same attention by SDPA on K/V dequantized to bf16 in
    # time order (valid positions only), one layer; never used by the port
    lo, hi = da._unpack_nibbles_u(k4[0])
    k_t = torch.stack([lo, hi], dim=-1).reshape(b, h, dh, tpad)[..., :valid] - 8
    lo, hi = da._unpack_nibbles_u(v4[0])
    v_t = torch.stack([lo, hi], dim=-2).reshape(b, h, tpad, dh)[:, :, :valid] - 8
    library = _sdpa_on_dequantized(q, k_t, v_t)
    lib_err = (library().float().transpose(1, 2)
               - da.cross_attention_int4_reference(q, k4[0], v4[0], valid_len=valid)).abs().max().item()
    lib = time_ms(library, iters=20)

    def needed(rows, tq=1):  # bytes (valid K/V nibbles, q in, out) and FLOPs of one call
        return (2 * rows * h * dh * math.ceil(valid / 2) + 2 * 4 * rows * tq * h * dh,
                4 * rows * tq * h * dh * valid)

    bms, by = bound_ms(*needed(b))
    out.update(kernel_ms=ms, kernel_device_ms=device_ms(kernel, iters=48), plain_ms=plain,
               library_ms=lib, library_max_abs_err=lib_err, bound_ms=bms, bound_by=by,
               timed="Tq=1, B=128, one layer per call")

    # the transcribe phase's own slab: 8 windows, a decode step (Tq=1) and a
    # prompted prefill (Tq=48)
    k4s, v4s = k4[:, :8].contiguous(), v4[:, :8].contiguous()
    for tq in (1, 48):
        qs = q[:8].contiguous() if tq == 1 else torch.randn(8, tq, h, dh, device=dev, generator=g) * 0.1
        got = da.cross_attention_int4_stacked(qs, k4s, v4s, 3, valid_len=valid)
        torch.cuda.synchronize()
        err = (got - da.cross_attention_int4_reference(qs, k4s[3], v4s[3], valid_len=valid)).abs().max().item()
        if not err <= 5e-4:
            fail(f"cross_attn_int4 B=8 tq={tq}: max abs err {err} > 5e-4")
        worst = max(worst, err)
        key = "b8" if tq == 1 else f"b8_tq{tq}"
        call = lambda qs=qs: da.cross_attention_int4_stacked(qs, k4s, v4s, 3, valid_len=valid)
        out.update({f"max_abs_err_{key}": err, f"bound_ms_{key}": bound_ms(*needed(8, tq))[0],
                    f"kernel_ms_{key}": device_ms(call, iters=48),  # device time
                    f"kernel_event_ms_{key}": time_ms(call, iters=48)})  # host launch included
    kernels["cross_attn_int4"] = dict(
        name="cross_attn_int4", route="cuda",
        source="audio_processor_tpu_torch/csrc/cross_attn_int4.cu",
        replaces="audio_processor_tpu/ops/pallas/decode_attention.py:411",
        max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
        shape=f"q ({b}, 1, {h}, {dh}) f32 vs layer of K/V ({n_layers}, {b}, {h}, ., {tpad // 2}) int4x2",
        ms_b8=out["kernel_ms_b8"], event_ms_b8=out["kernel_event_ms_b8"],
        bound_ms_b8=out["bound_ms_b8"], ms_b8_tq48=out["kernel_ms_b8_tq48"],
        event_ms_b8_tq48=out["kernel_event_ms_b8_tq48"], bound_ms_b8_tq48=out["bound_ms_b8_tq48"],
    )
    return out


def phase_encoder_attn(dev, kernels) -> dict:
    """Kernel #6 against its plain version at B=8 (bf16 and f32), timed at
    the default slab's B=128 in bf16 with SDPA on the same tensors as the
    yardstick."""
    from audio_processor_tpu_torch.ops.kernels import encoder_attention as ea

    t, h, dh = 1500, 12, 64
    g = torch.Generator(device=dev).manual_seed(6)
    out = {"phase": "encoder_attn", "shape": [t, h, dh]}

    def qkv(b, dtype):  # split-heads views of one projection, as in the encoder
        x = torch.randn(b, t, 3 * h * dh, device=dev, generator=g).to(dtype)
        return [y.reshape(b, t, h, dh) for y in x.split(h * dh, dim=-1)]

    # both sides keep the scores in f32 and round the normalised P to bf16:
    # bf16 outputs (|x| up to ~0.3) differ by an output ulp or two
    for dtype, tol in ((torch.bfloat16, 4e-3), (torch.float32, 1e-4)):
        q, k, v = qkv(8, dtype)
        got = ea.fused_self_attention(q, k, v)
        torch.cuda.synchronize()
        err = (got.float() - ea.attention_reference(q, k, v).float()).abs().max().item()
        name = str(dtype).split(".")[-1]
        if not err <= tol:
            fail(f"encoder_attn {name} B=8: max abs err {err} > {tol}")
        out[f"max_abs_err_{name}_b8"] = err
    del q, k, v, got

    b = 128
    q, k, v = qkv(b, torch.bfloat16)
    ms = time_ms(lambda: ea.fused_self_attention(q, k, v), iters=5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plain = time_ms(lambda: ea.attention_reference(q, k, v), iters=2, warmup=1)
    plain_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    lib = time_ms(lambda: sdpa(qh, kh, vh), iters=5)
    nbytes = 4 * b * t * h * dh * 2  # q, k, v in and out, bf16
    bms, by = bound_ms(nbytes, 4 * b * h * t * t * dh, PEAK_BF16_FLOPS)
    out.update(kernel_ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
               plain_peak_mem_gb=plain_peak_gb, timed="bf16, B=128, one layer per call",
               bound_share=bms / ms, kernel_over_library=ms / lib)
    kernels["encoder_attn"] = dict(
        name="encoder_attn", route="cuda", source="audio_processor_tpu_torch/csrc/encoder_attn.cu",
        replaces="audio_processor_tpu/ops/pallas/encoder_attention.py:80",
        max_abs_err=out["max_abs_err_bfloat16_b8"], max_abs_err_f32=out["max_abs_err_float32_b8"],
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
        shape=f"q, k, v ({b}, {t}, {h}, {dh}) bf16 -> ({b}, {t}, {h}, {dh}) bf16",
    )
    return out


def phase_cross_attn_int8(dev, kernels) -> dict:
    """Kernel #3 on whisper-small's int8 kernel-layout cache at B=128:
    layers 0 and 11, Tq 1 and 4, then timed one layer per call; and B=8."""
    from audio_processor_tpu_torch.ops.kernels import decode_attention as da

    n_layers, b, h, dh, tpad, valid = 12, 128, 12, 64, 1536, 1500
    g = torch.Generator(device=dev).manual_seed(7)
    k8 = torch.randint(-127, 128, (n_layers, b, h, dh, tpad), device=dev, generator=g, dtype=torch.int8)
    v8 = torch.randint(-127, 128, (n_layers, b, h, tpad, dh), device=dev, generator=g, dtype=torch.int8)
    k8[..., valid:] = 0  # init_cache zero-pads past Ta
    v8[:, :, :, valid:] = 0
    out = {"phase": "cross_attn_int8", "shape": [n_layers, b, h, dh, tpad], "valid_len": valid}
    worst = 0.0
    for tq in (1, 4):
        q = torch.randn(b, tq, h, dh, device=dev, generator=g) * 0.02
        for l in (0, n_layers - 1):
            got = da.cross_attention_int8(q, k8[l], v8[l], valid_len=valid)
            torch.cuda.synchronize()
            err = (got - da.cross_attention_int8_reference(q, k8[l], v8[l], valid_len=valid)).abs().max().item()
            # integer-unit outputs (|x| <= 127), f32 sums over 1500 keys in
            # another order than the plain version's
            if not err <= 1e-3:
                fail(f"cross_attn_int8 tq={tq} layer={l}: max abs err {err} > 1e-3")
            worst = max(worst, err)
            out[f"max_abs_err_tq{tq}_l{l}"] = err

    q = torch.randn(b, 1, h, dh, device=dev, generator=g) * 0.02
    layer_iter = iter(range(10**9))

    def kernel():  # cycle the layers: each call streams one layer from HBM
        l = next(layer_iter) % n_layers
        return da.cross_attention_int8(q, k8[l], v8[l], valid_len=valid)

    ms = time_ms(kernel, iters=48)
    plain = time_ms(lambda: da.cross_attention_int8_reference(q, k8[0], v8[0], valid_len=valid), iters=3)
    lib = time_ms(_sdpa_on_dequantized(q, k8[0][..., :valid], v8[0][:, :, :valid]), iters=20)

    def needed(rows):  # bytes (valid K/V bytes, q in, out) and FLOPs of one call
        return 2 * rows * h * dh * valid + 2 * 4 * rows * h * dh, 4 * rows * h * dh * valid

    bms, by = bound_ms(*needed(b))
    qs, k8s, v8s = q[:8].contiguous(), k8[3, :8].contiguous(), v8[3, :8].contiguous()
    got = da.cross_attention_int8(qs, k8s, v8s, valid_len=valid)
    torch.cuda.synchronize()
    err = (got - da.cross_attention_int8_reference(qs, k8s, v8s, valid_len=valid)).abs().max().item()
    if not err <= 1e-3:
        fail(f"cross_attn_int8 B=8: max abs err {err} > 1e-3")
    worst = max(worst, err)
    out.update(kernel_ms=ms, kernel_device_ms=device_ms(kernel, iters=48), plain_ms=plain,
               library_ms=lib, bound_ms=bms, bound_by=by, timed="Tq=1, B=128, one layer per call",
               max_abs_err_b8=err, bound_ms_b8=bound_ms(*needed(8))[0],
               kernel_ms_b8=device_ms(lambda: da.cross_attention_int8(qs, k8s, v8s, valid_len=valid), iters=48))
    kernels["cross_attn_int8"] = dict(
        name="cross_attn_int8", route="cuda", source="audio_processor_tpu_torch/csrc/cross_attn_int8.cu",
        replaces="audio_processor_tpu/ops/pallas/decode_attention.py:83",
        max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
        shape=f"q ({b}, 1, {h}, {dh}) f32 vs layer of K/V ({n_layers}, {b}, {h}, ., {tpad}) int8",
        ms_b8=out["kernel_ms_b8"], bound_ms_b8=out["bound_ms_b8"],
    )
    return out


def phase_cross_attn_int4_single(dev, kernels) -> dict:
    """Kernel #4 (kernel B's function on a single-layer cache, through kernel
    B's library) against its plain version at B=8."""
    from audio_processor_tpu_torch.ops.kernels import decode_attention as da

    b, h, dh, tpad, valid = 8, 12, 64, 1536, 1500
    g = torch.Generator(device=dev).manual_seed(8)
    k8 = torch.randint(-7, 8, (b, h, dh, tpad), device=dev, generator=g, dtype=torch.int8)
    v8 = torch.randint(-7, 8, (b, h, tpad, dh), device=dev, generator=g, dtype=torch.int8)
    k4, v4 = da.pack_int4_time(k8, v8)
    q = torch.randn(b, 1, h, dh, device=dev, generator=g) * 0.1
    got = da.cross_attention_int4(q, k4, v4, valid_len=valid)
    torch.cuda.synchronize()
    err = (got - da.cross_attention_int4_reference(q, k4, v4, valid_len=valid)).abs().max().item()
    if not err <= 5e-4:
        fail(f"cross_attn_int4_single B=8: max abs err {err} > 5e-4")
    ms = device_ms(lambda: da.cross_attention_int4(q, k4, v4, valid_len=valid), iters=48)
    plain = time_ms(lambda: da.cross_attention_int4_reference(q, k4, v4, valid_len=valid), iters=5)
    lib = time_ms(_sdpa_on_dequantized(q, k8[..., :valid], v8[:, :, :valid]), iters=20)
    bms, by = bound_ms(2 * b * h * dh * math.ceil(valid / 2) + 2 * 4 * b * h * dh,
                       4 * b * h * dh * valid)
    kernels["cross_attn_int4_single"] = dict(
        name="cross_attn_int4_single", route="cuda",
        source="audio_processor_tpu_torch/csrc/cross_attn_int4.cu",
        replaces="audio_processor_tpu/ops/pallas/decode_attention.py:277",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
        shape=f"q ({b}, 1, {h}, {dh}) f32 vs K/V ({b}, {h}, ., {tpad // 2}) int4x2",
        main_path=("none: no path of the JAX package calls this kernel; its launches are "
                   "counted over both warm transcribe runs and checked here alone"),
    )
    return {"phase": "cross_attn_int4_single", "batch": b, "max_abs_err": err,
            "kernel_device_ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bms,
            "bound_by": by}


def check_config():
    """The small reference config of the check phases (64-wide heads)."""
    from audio_processor_tpu_torch.models.whisper.config import WhisperConfig

    return WhisperConfig(name="check", n_mels=80, n_audio_ctx=1500, n_audio_state=128,
                         n_audio_head=2, n_audio_layer=2, n_vocab=1024, n_text_ctx=64,
                         n_text_state=128, n_text_head=2, n_text_layer=2)


def phase_check(dev) -> dict:
    """Small-config reference check of the whole chain on full 30 s
    windows, the card's kernels against the CPU's plain path, float32:
    kernel A -> encoder (plain, and through the encoder-attention kernel)
    -> int4 greedy (kernel B), int8-kernel greedy, beam search and prompted
    greedy with rows of mixed prompt lengths, one of them empty.  The
    tokens must be equal in every case, with the int8 self cache and on
    int8 decoder weights too.  Then word timestamps on the CPU's states and
    greedy tokens: the teacher-forced maps (pooled, and on hand-set
    alignment heads) within 1e-4 of the CPU's, and the words (C++ DTW on
    the card, the numpy twin on the CPU) equal."""
    from audio_processor_tpu_torch.models.whisper import align, decode, model, quantize
    from audio_processor_tpu_torch.ops.kernels.log_mel import log_mel

    cfg = check_config()
    params = model.init_params(cfg, torch.Generator().manual_seed(2))
    st = decode.SpecialTokens.for_config(cfg)
    sot = tuple(st.sot_sequence())
    audio = torch.from_numpy(np.stack([speech_like(30.0, s) for s in (3, 4, 9)]))
    rows, lens = decode.build_prompt_rows([[5, 6, 7, 8], [], [300]], sot, st, 4)
    decodes = {
        "greedy_int4": lambda p, x: decode.greedy_decode(
            p, cfg, x, sot_sequence=sot, max_new_tokens=24, quantize_cross_kv=True, kv_bits=4),
        "greedy_int8_kernel": lambda p, x: decode.greedy_decode(
            p, cfg, x, sot_sequence=sot, max_new_tokens=24, quantize_cross_kv=True, kv_bits=8,
            use_pallas_kernel=True),
        "beam3_int4": lambda p, x: decode.beam_decode(
            p, cfg, x, sot_sequence=sot, beam_size=3, max_new_tokens=24,
            quantize_cross_kv=True, kv_bits=4),
        "prompted_int4": lambda p, x: decode.prompted_greedy_decode(
            p, cfg, x, rows, lens, sot_len=len(sot), max_new_tokens=24,
            quantize_cross_kv=True, kv_bits=4),
        "greedy_int4_self_int8": lambda p, x: decode.greedy_decode(
            p, cfg, x, sot_sequence=sot, max_new_tokens=24, quantize_cross_kv=True, kv_bits=4,
            quantize_self_kv=True),
        "greedy_int4_int8_weights": lambda p, x: decode.greedy_decode(
            quantize.quantize_decoder(p), cfg, x, sot_sequence=sot, max_new_tokens=24,
            quantize_cross_kv=True, kv_bits=4),
    }
    res = {}
    for where in ("cpu", "cuda"):
        p = model.map_params(lambda t: t.to(where), params)
        mel = log_mel(audio.to(where), 80)
        states = model.encode(p, cfg, mel)
        fused = model.encode(p, cfg, mel, fused_attn=True)
        res[where] = {"states": states.cpu(), "fused": fused.cpu()}
        for name, fn in decodes.items():
            res[where][name] = fn(p, fused).tokens.cpu()
    enc_err = (res["cpu"]["states"] - res["cuda"]["states"]).abs().max().item()
    fused_err = (res["cpu"]["states"] - res["cuda"]["fused"]).abs().max().item()
    same = {name: torch.equal(res["cpu"][name], res["cuda"][name]) for name in decodes}
    if not (torch.isfinite(res["cuda"]["fused"]).all() and enc_err <= 2e-3 and fused_err <= 2e-3
            and all(same.values())):
        fail(f"check: encoder max abs err {enc_err}, fused encoder {fused_err}, "
             f"tokens equal: {same}")
    # word timestamps: the CPU's states and tokens through both devices
    tokens = res["cpu"]["greedy_int4"].numpy()
    _, _, forced = align._teacher_forced_rows(tokens, st, sot)
    words = {}
    for key, heads in (("pooled", None), ("alignment_heads", ((0, 1), (1, 0)))):
        hcfg = dataclasses.replace(cfg, alignment_heads=heads)
        out = {}
        for where in ("cpu", "cuda"):
            p = model.map_params(lambda t: t.to(where), params)
            x = res["cpu"]["states"].to(where)
            maps, _ = align.alignment_maps(p, hcfg, x, forced, st.eot, False)
            ws = align.word_timestamps(p, hcfg, x, tokens, st, letters, np.zeros(len(tokens)),
                                       with_probabilities=True, sot_sequence=sot)
            out[where] = (maps, [[(w["word"], w["start"], w["end"]) for w in row] for row in ws])
        words[key] = {"maps_max_abs_err_vs_cpu": float(np.abs(out["cpu"][0] - out["cuda"][0]).max()),
                      "words_equal_cpu": out["cpu"][1] == out["cuda"][1],
                      "words": sum(len(row) for row in out["cpu"][1])}
        if not (words[key]["maps_max_abs_err_vs_cpu"] <= 1e-4 and words[key]["words_equal_cpu"]
                and words[key]["words"]):
            fail(f"check: word timestamps ({key}) {words[key]}")
    return {"phase": "check", "encoder_max_abs_err_vs_cpu": enc_err,
            "fused_encoder_max_abs_err_vs_cpu": fused_err,
            "tokens_equal_cpu": same, "greedy_tokens_equal_cpu": same["greedy_int4"],
            "word_timestamps": words}


def letters(ids) -> str:
    """Random-weight token ids as text a word path can split: every fifth
    id a space, the others letters."""
    return "".join(" " if int(i) % 5 == 0 else chr(97 + int(i) % 26) for i in ids)


class LetterTokenizer:
    """encode: UTF-8 bytes; decode: ``letters``, so that random-weight
    decodes have words."""

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids) -> str:
        return letters(ids)


def phase_cross_attn_tp(dev, kernels) -> dict:
    """Kernel #5 at whisper-small's widths, B=128, Tq=1, for tp 2 and 4: each
    emulated model rank's contiguous slice of q and of the stacked cache
    (its heads) goes through the wrapper.  Concatenated along the heads,
    the ranks' outputs must equal kernel B's full-head output bit for bit
    (a (row, head)'s 64-column chunks and the order in which its last block
    combines them do not depend on the grid), and each rank's must lie within
    5e-4 of the plain version.  Timed per rank at tp=2, the transcribe_tp
    meshes' split, with SDPA on the rank's dequantized bf16 K/V beside."""
    from audio_processor_tpu_torch.ops.kernels import decode_attention as da
    from audio_processor_tpu_torch.parallel.mesh import Mesh, split_bounds

    n_layers, b, h, dh, tpad, valid = 12, 128, 12, 64, 1536, 1500
    g = torch.Generator(device=dev).manual_seed(11)
    k4 = torch.empty((n_layers, b, h, dh, tpad // 2), dtype=torch.int8, device=dev)
    v4 = torch.empty((n_layers, b, h, tpad // 2, dh), dtype=torch.int8, device=dev)
    for l in range(n_layers):
        k8 = torch.randint(-7, 8, (b, h, dh, tpad), device=dev, generator=g, dtype=torch.int8)
        v8 = torch.randint(-7, 8, (b, h, tpad, dh), device=dev, generator=g, dtype=torch.int8)
        k4[l], v4[l] = da.pack_int4_time(k8, v8)
    del k8, v8
    q = torch.randn(b, 1, h, dh, device=dev, generator=g) * 0.1
    out = {"phase": "cross_attn_int4_tp", "shape": [n_layers, b, h, dh, tpad], "valid_len": valid}
    worst, rank_tensors = 0.0, {}

    def rank_shard(tp, r, rows=slice(None)):  # what model rank r holds: its heads, contiguous
        mesh = Mesh(dp=1, tp=tp, data_rank=0, model_rank=r, device=dev)
        lo, hi = split_bounds(h, mesh)
        return (mesh, q[rows, :, lo:hi].contiguous(), k4[:, rows, lo:hi].contiguous(),
                v4[:, rows, lo:hi].contiguous())

    def call(shard, layer):
        mesh, ql, kl, vl = shard
        return da.cross_attention_int4_stacked_tp(mesh, ql, kl, vl, layer, valid_len=valid,
                                                  n_head=h)

    for tp in (2, 4):
        shards = [rank_shard(tp, r) for r in range(tp)]
        diffs = []
        for l in (0, n_layers - 1):
            full = da.cross_attention_int4_stacked(q, k4, v4, l, valid_len=valid)
            parts = [call(sh, l) for sh in shards]
            torch.cuda.synchronize()
            for (_, ql, kl, vl), got in zip(shards, parts):
                err = (got - da.cross_attention_int4_reference(ql, kl[l], vl[l], valid_len=valid)
                       ).abs().max().item()
                if not err <= 5e-4:
                    fail(f"cross_attn_int4_tp tp={tp} layer={l}: max abs err {err} > 5e-4")
                worst = max(worst, err)
            diffs.append((torch.cat(parts, dim=2) - full).abs().max().item())
        out[f"concat_vs_full_max_abs_diff_tp{tp}"] = max(diffs)
        if max(diffs) != 0.0:
            fail(f"cross_attn_int4_tp tp={tp}: rank outputs differ from kernel B's by {max(diffs)}")
        rank_tensors[tp] = shards[0]
        del shards
    out["max_abs_err"] = worst

    def needed(rows, heads):  # a rank's bytes (valid K/V nibbles, q in, out) and FLOPs
        return (2 * rows * heads * dh * math.ceil(valid / 2) + 2 * 4 * rows * heads * dh,
                4 * rows * heads * dh * valid)

    for tp, shard in rank_tensors.items():
        layer_iter = iter(range(10**9))
        ms = time_ms(lambda: call(shard, next(layer_iter) % n_layers), iters=48)
        out[f"kernel_ms_tp{tp}"] = ms
        out[f"bound_ms_tp{tp}"], by = bound_ms(*needed(b, h // tp))
        small = rank_shard(tp, 0, slice(0, 8))
        out[f"kernel_ms_b8_tp{tp}"] = device_ms(lambda: call(small, 3), iters=48)
        out[f"bound_ms_b8_tp{tp}"] = bound_ms(*needed(8, h // tp))[0]
    _, ql, kl, vl = rank_tensors[2]
    plain = time_ms(lambda: da.cross_attention_int4_reference(ql, kl[0], vl[0], valid_len=valid),
                    iters=3)
    lo, hi = da._unpack_nibbles_u(kl[0])
    k_t = torch.stack([lo, hi], dim=-1).reshape(b, h // 2, dh, tpad)[..., :valid] - 8
    lo, hi = da._unpack_nibbles_u(vl[0])
    v_t = torch.stack([lo, hi], dim=-2).reshape(b, h // 2, tpad, dh)[:, :, :valid] - 8
    lib = time_ms(_sdpa_on_dequantized(ql, k_t, v_t), iters=20)
    out.update(plain_ms_tp2=plain, library_ms_tp2=lib, bound_by=by,
               timed="per rank: Tq=1, B=128, H/tp heads, one layer per call")
    kernels["cross_attn_int4_tp"] = dict(
        name="cross_attn_int4_tp", route="cuda",
        source="audio_processor_tpu_torch/csrc/cross_attn_int4.cu",
        replaces="audio_processor_tpu/ops/pallas/decode_attention.py:471",
        max_abs_err=worst, ms=out["kernel_ms_tp2"], plain_ms=plain,
        bound_ms=out["bound_ms_tp2"], bound_by=by, library_ms=lib,
        shape=f"per rank at tp=2: q ({b}, 1, {h // 2}, {dh}) f32 vs layer of K/V "
              f"({n_layers}, {b}, {h // 2}, ., {tpad // 2}) int4x2",
        ms_tp4=out["kernel_ms_tp4"], bound_ms_tp4=out["bound_ms_tp4"],
        ms_b8=out["kernel_ms_b8_tp2"], bound_ms_b8=out["bound_ms_b8_tp2"],
    )
    return out


# P1's and P2's device ms a call in their first design (one block a row
# group and head, no split of the time axis), keyed by (label, batch, rows
# a block): the probe entry points (benchmarks/kernel_v32_probe,
# kernel_v34_probe, kernel_v4_probe) on an H100 80GB HBM3 at 700 W, the
# mean of two runs; the floors ("s/bb1", "s/bb8_joint") as call_ms over
# stream_share.  The probes phase prints them beside this run's times.
PROBES_FIRST_DESIGN_MS = {
    ("v3.1", 128, 1): 0.0986, ("a/bb1", 128, 1): 0.0913, ("s/bb1", 128, 1): 0.0533,
    ("a", 64, 8): 0.2238, ("b", 64, 8): 0.0589, ("c", 64, 8): 0.0589, ("d", 64, 8): 0.0589,
    ("e", 64, 8): 0.0589, ("s", 64, 8): 0.1281, ("s/bb8", 64, 8): 0.1281,
    ("s/bb8_joint", 64, 8): 0.0327, ("s/bb1", 64, 1): 0.0309, ("i4_bf16", 64, 1): 0.0723,
}


def phase_probes(dev, kernels) -> dict:
    """Kernel B's design probes (#7, #8, #9) at their default batches: every
    variant held to its plain version on layers 0 and 11 (exact functions
    5e-4, bf16 and int8-quantised ones 2e-3, the stream floor bit-equal at
    every rows a block it is timed at),
    then driven as its probe drives it (12 layers a step, the counts zeroed
    just before and read just after) and timed by the device a call, beside
    its byte bound, its plain version, the stream floor at its rows a block
    (``stream_share``) and SDPA on the dequantised bf16 K/V."""
    from audio_processor_tpu_torch.benchmarks import probe_common as pc
    from audio_processor_tpu_torch.ops.kernels import decode_attention as da
    from audio_processor_tpu_torch.ops.kernels import probe_attention as pa

    new = [pa.probe_stream, pa.int4_rows, pa.int8_dot]
    old = [da.cross_attention_int4_stacked, da.cross_attention_int8]
    by_name = {c.__name__: c for c in new + old}
    steps = 4
    out = {"phase": "probes", "steps_timed": steps, "valid_len": pc.VALID}
    rows = {c.__name__: [] for c in new}
    launches = dict.fromkeys(by_name, 0)
    worst = dict.fromkeys(rows, 0.0)
    for seed, (probe, batch) in enumerate((("v32", 128), ("v34", 64), ("v4", 64))):
        table = pc.variants(probe)  # the v34 probe at bb=8, its variants a-e and s
        if probe == "v32":  # the packed unpack at one row a block: v3.1's A/B partner
            table["a/bb1"] = dataclasses.replace(pc.variants("v34", bb=1)["a"], label="a/bb1")
        data = pc.make_inputs(batch, dev, int8=any(v.cache == "int8" for v in table.values()),
                              seed=20 + seed)
        errs = {}
        for x, v in table.items():
            try:
                errs[x] = pc.gate(v, data)
            except AssertionError as exc:
                fail(f"probes {probe} B={batch}: {exc}")
        # P1 at every rows a block it is timed at, bit-equal to its plain version
        for bb, joint in sorted({v.stream for v in table.values()}):
            for layer in (0, pc.L - 1):
                got = pa.probe_stream(data["q"], data["k4"], data["v4"], layer, bb=bb, joint=joint)
                if not torch.equal(got, pa.probe_stream_reference(data["q"], data["k4"], data["v4"],
                                                                  layer)):
                    fail(f"probes {probe} B={batch}: P1 at bb={bb}, joint={joint}, layer {layer} "
                         "is not bit-equal to its plain version")
        lib = time_ms(pc.sdpa_call(data, "int4"), iters=10)
        zero_counts(by_name.values())
        floors: dict = {}
        for bb, joint in sorted({v.stream for v in table.values()}):
            floors[(bb, joint)] = pc.device_call_ms(lambda layer, bb=bb, joint=joint: pa.probe_stream(
                data["q"], data["k4"], data["v4"], layer, bb=bb, joint=joint))
        res = {}
        for x, v in table.items():
            before = by_name[v.kernel].launches
            res[x] = pc.measure(v, data, steps, floors)
            res[x]["launches"] = by_name[v.kernel].launches - before
        for name, c in by_name.items():
            launches[name] += c.launches
        for x, v in table.items():
            k, vc = pc.cache_of(v, data)
            res[x].update(
                max_abs_err=errs[x], gate=v.tol if v.tol is not None else "bit-equal",
                plain_ms=time_ms(lambda v=v, k=k, vc=vc: v.plain(data["q"], k, vc, 0),
                                 iters=2, warmup=1),
                library_ms=lib, probe=probe, bb=v.stream[0])
            if v.kernel in rows:
                rows[v.kernel].append(res[x])
                worst[v.kernel] = max(worst[v.kernel], errs[x])
        out[probe] = {"batch": batch, "library_ms": lib, "stream_floor_ms": {
            f"bb{bb}{'_joint' if joint else ''}": ms for (bb, joint), ms in floors.items()},
            "variants": res}
        del data
        torch.cuda.empty_cache()
    if not all(launches[c.__name__] for c in new):
        fail(f"probes: a kernel of the path never launched: {launches}")
    out["launches"] = launches
    # P1 and P2 split the time axis across blocks: each instantiation's
    # time in its first design beside this run's and its bound
    split = [{"kernel": name, "label": r["label"], "batch": r["batch"], "bb": r["bb"],
              "first_design_ms": PROBES_FIRST_DESIGN_MS.get((r["label"], r["batch"], r["bb"])),
              "call_ms": r["call_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
              **{k: r[k] for k in ("i2f_bound_ms",) if k in r}}
             for name in ("probe_stream", "int4_rows") for r in rows[name]]
    for probe in ("v32", "v34", "v4"):
        batch = out[probe]["batch"]
        for key, ms in out[probe]["stream_floor_ms"].items():
            bb = int(key[2:].split("_")[0])
            split.append({"kernel": "probe_stream", "label": f"s/{key}", "batch": batch, "bb": bb,
                          "first_design_ms": PROBES_FIRST_DESIGN_MS.get((f"s/{key}", batch, bb)),
                          "call_ms": ms, "bound_ms": pc.bound_ms(pc.variants("v34")["s"], batch)[0],
                          "bound_by": "bytes"})
    emit({"phase": "probes_split", "card": card_line(), "variants": split})

    def entry(name, label, replaces):
        row = next(r for r in rows[name] if r["label"] == label)
        return dict(
            name=name, route="cuda", source="audio_processor_tpu_torch/csrc/cross_attn_probes.cu",
            replaces=replaces, launches=launches[name], max_abs_err=worst[name],
            ms=row["call_ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=None if name == "probe_stream" else row["library_ms"],
            **{k: row[k] for k in ("i2f_bound_ms",) if k in row},
            shape=f"{label} at B={row['batch']}: q (B, 1, 12, 64) f32 vs a layer of the stacked "
                  f"cache (12, B, 12, ., {pc.TPAD // 2}) int4x2",
            variants=[{k: r[k] for k in ("probe", "label", "counterpart", "replaces", "batch", "bb",
                                         "launches", "max_abs_err", "gate", "call_ms", "step_ms",
                                         "bound_ms", "bound_by", "plain_ms", "library_ms",
                                         "stream_ms", "stream_share")} for r in rows[name]])

    kernels["probe_stream"] = entry("probe_stream", "s", "benchmarks/kernel_v34_probe.py:264")
    kernels["int4_rows"] = entry("int4_rows", "v3.1", "benchmarks/kernel_v32_probe.py:117")
    kernels["int8_dot"] = entry("int8_dot", "v3.3mxu", "benchmarks/kernel_v32_probe.py:56")
    return out


def record_decodes(tr) -> list:
    """Wrap ``tr._run_decode`` so that every decode's tokens (the whole
    slab's, before the no-speech gate) are appended to the returned list."""
    seen: list = []
    run = tr._run_decode

    def wrapped(*args, **kw):
        res = run(*args, **kw)
        seen.append(res.tokens.cpu().numpy())
        return res

    tr._run_decode = wrapped
    return seen


def check_segments(out: dict, audio_s: float, phase: str) -> None:
    if not math.isclose(out["duration"], audio_s):
        fail(f"{phase}: duration {out['duration']}")
    for s in out["segments"]:
        if not (0.0 <= s["start"] <= s["end"] <= audio_s + 1e-6 and np.isfinite(s["avg_logprob"])):
            fail(f"{phase}: bad segment {s}")


TP_AUDIO_S = 240.0
# the worlds' transcription: 2 min (4 min before the mesh paths joined the
# worlds) at the default 224-token cap.  Random weights decode every window
# to the cap, and over gloo a mesh call's time is set by its decode steps
# (each one 36 all-reduces).  At 96 tokens, on H100 80GB HBM3 at 700 W, a
# dp2 x tp2 call took 8.45 s, the words call 7.39 s (dp1 x tp2) and 9.98 s
# (dp2 x tp2), serve_tp's three jobs 29.35 s, the whole run 656.8 s.  At
# 224 tokens those decodes take about 2.3 times as long: with transcribe_tp
# back at 224 the run would pass the 747 s it took before the mesh paths,
# so the mesh paths (transcribe_words_tp, serve_tp) decode to the bench's
# 96-token cap
TP_WORLD_AUDIO_S = 120.0
TP_WORLD_TOKENS = 224
MESH_PATH_TOKENS = 96
# the check config's word pass: 70 s (three windows: on dp2 the second data
# rank's second row is padding)
CHECK_WORDS_AUDIO_S = 70.0
INT8_DP_MODEL = "small"
INT8_DP_BATCH = 32  # the bench's int8 line


def check_words_kw() -> dict:
    """The check config's f32 Transcriber with words (card, CPU or mesh)."""
    return dict(cfg=check_config(), compute_dtype="float32", max_new_tokens=24,
                tokenizer=LetterTokenizer(), word_timestamps=True, enable_fallback=False,
                no_speech_threshold=None)


def check_params(int8: bool = False):
    from audio_processor_tpu_torch.models.whisper import model, quantize

    params = model.init_params(check_config(), torch.Generator().manual_seed(2))
    return quantize.quantize_decoder(params) if int8 else params


def word_rows(words) -> list:
    return [(w["word"], w["start"], w["end"]) for w in words]


def _check_decodes(cfg, params, audio, mesh=None) -> dict:
    """The check config's chain (kernel A -> encoder -> int4 greedy and
    beam 3) on ``audio`` (this data rank's rows), float32; token arrays."""
    from audio_processor_tpu_torch.models.whisper import decode, model
    from audio_processor_tpu_torch.ops.kernels.log_mel import log_mel

    st = decode.SpecialTokens.for_config(cfg)
    kw = dict(sot_sequence=tuple(st.sot_sequence()), max_new_tokens=24, quantize_cross_kv=True,
              kv_bits=4, mesh=mesh)
    states = model.encode(params, cfg, log_mel(audio, 80), mesh=mesh)
    return {"greedy_int4": decode.greedy_decode(params, cfg, states, **kw).tokens.cpu().numpy(),
            "beam3_int4": decode.beam_decode(params, cfg, states, beam_size=3, **kw)
            .tokens.cpu().numpy()}


def _check_audio() -> torch.Tensor:
    return torch.from_numpy(np.stack([speech_like(30.0, s) for s in (3, 4, 9, 12)]))


def _tp_rank(rank, world, tp, port, backend, results, profile) -> None:
    """One rank of a transcribe_tp world: (a) the check config on the mesh,
    (b) whisper-small's default transcription on the mesh, cold then warm,
    counting the warm run's kernel launches; with ``profile``, once more
    with rank 0 under the profiler (every rank runs it: the collectives
    need them all)."""
    try:
        import torch.distributed as dist

        from audio_processor_tpu_torch.models.whisper import model
        from audio_processor_tpu_torch.ops.kernels.decode_attention import (
            cross_attention_int4_stacked,
            cross_attention_int4_stacked_tp,
        )
        from audio_processor_tpu_torch.ops.kernels.log_mel import log_mel
        from audio_processor_tpu_torch.parallel import mesh as mesh_lib
        from audio_processor_tpu_torch.parallel import multihost, sharding
        from audio_processor_tpu_torch.pipeline.transcribe import Transcriber

        multihost.initialize(f"127.0.0.1:{port}", world, rank, backend=backend)
        mesh = mesh_lib.make_mesh(tp)
        res = {"rank": rank, "device": str(mesh.device), "backend": dist.get_backend()}
        cfg = check_config()
        params = sharding.shard_params(
            model.init_params(cfg, torch.Generator().manual_seed(2)), mesh, cfg)
        audio = _check_audio()
        rows = mesh.local_rows(audio.shape[0])
        res["check"] = _check_decodes(cfg, params, audio[rows].to(mesh.device), mesh)
        res["check_rows"] = (rows.start, rows.stop)

        # bf16, int4 cross-KV, fallback off
        tr = Transcriber.random_init("small", mesh=mesh, max_new_tokens=TP_WORLD_TOKENS)
        seen = record_decodes(tr)
        audio = speech_like(TP_WORLD_AUDIO_S, 5)
        cold = tr.transcribe(audio)
        torch.cuda.synchronize()
        counters = (log_mel, cross_attention_int4_stacked_tp, cross_attention_int4_stacked)
        for c in counters:
            c.launches = 0
        seen.clear()
        warm = tr.transcribe(audio)
        torch.cuda.synchronize()
        res["launches"] = {c.__name__: c.launches for c in counters}
        res["cold_rtf_x"], res["warm_rtf_x"] = cold["rtf_x"], warm["rtf_x"]
        res["warm"] = {k: v for k, v in warm.items() if k != "rtf_x"}
        res["tokens"] = np.concatenate(seen)
        if profile and rank == 0:
            res["profile"] = profile_decode(lambda: tr.transcribe(audio),
                                            1e3 * TP_WORLD_AUDIO_S / warm["rtf_x"])
        elif profile:
            tr.transcribe(audio)
        res["words_tp"] = _rank_words(tr, mesh, counters)
        if world == 4:  # the dp2 x tp2 world carries the data-axis paths
            res["int8_dp"] = _rank_int8_dp(mesh, counters)
            res["diarize_tp"] = _rank_diarize(mesh)
            res["serve_tp"] = _rank_serve(counters)
        results.put((rank, True, res))
        dist.destroy_process_group()
    except BaseException:  # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()[-3000:]))
        raise


def _rank_words(tr, mesh, counters) -> dict:
    """transcribe_words_tp on this rank: the check config's f32 words on
    the mesh, then the ``transcribe_words`` workload on the rank's shard of
    ``tr`` (words, the hallucination filter, the int8 self cache), its
    word pass timed apart by wrapping ``align``'s stages, the kernels
    counted over the call."""
    from audio_processor_tpu_torch.models.whisper import align
    from audio_processor_tpu_torch.pipeline.transcribe import Transcriber

    t = Transcriber(params=check_params(), mesh=mesh, **check_words_kw())
    check = t.transcribe(speech_like(CHECK_WORDS_AUDIO_S, 7), remove_silence=False)
    tw = dataclasses.replace(tr, word_timestamps=True, hallucination_silence_threshold=2.0,
                             quantize_self_kv=True, tokenizer=LetterTokenizer(),
                             max_new_tokens=MESH_PATH_TOKENS)
    audio = speech_like(TP_WORLD_AUDIO_S, 5)
    stages: dict[str, list] = {"maps": [], "costs": [], "dtw": []}
    real = {name: getattr(align, name) for name in ("alignment_maps", "alignment_costs",
                                                     "dtw_starts")}

    def timed(name, key):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = real[name](*args, **kw)
            stages[key].append(1e3 * (time.perf_counter() - t0))
            return out
        return run

    for name, key in (("alignment_maps", "maps"), ("alignment_costs", "costs"),
                      ("dtw_starts", "dtw")):
        setattr(align, name, timed(name, key))
    try:
        torch.cuda.synchronize()
        zero_counts(counters)
        t0 = time.perf_counter()
        out = tw.transcribe(audio)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for name, fn in real.items():
            setattr(align, name, fn)
    check_segments(out, TP_WORLD_AUDIO_S, "transcribe_words_tp")
    return {
        "check_words": [(*w, p["probability"]) for w, p in zip(word_rows(check["words"]),
                                                                check["words"])],
        "words": word_rows(out["words"]), "segments": len(out["segments"]),
        "wall_s": wall, "rtf_x": TP_WORLD_AUDIO_S / wall,
        "launches": {c.__name__: c.launches for c in counters},
        "teacher_forced_ms_per_slab": stages["maps"], "host_chain_ms_per_slab": stages["costs"],
        "dtw_ms_per_slab": stages["dtw"],
    }


def _rank_int8_dp(mesh_tp, counters) -> dict:
    """int8_weights_dp on this rank: a second mesh of the world, dp4 x tp1;
    the check config's f32 tokens on int8 decoder weights, then the bench's
    int8 line (whisper-small's decoder quantized, the int8 self cache, 96
    tokens with EOT suppressed) at a batch of 32 over the data ranks, through
    the Transcriber's own frontend and decode; int8 weights on the tp=2 mesh
    must raise ValueError."""
    from audio_processor_tpu_torch.models.whisper import quantize
    from audio_processor_tpu_torch.ops import frontend
    from audio_processor_tpu_torch.parallel import mesh as mesh_lib
    from audio_processor_tpu_torch.pipeline.transcribe import Transcriber

    mesh = mesh_lib.make_mesh(1)
    out: dict = {"mesh": mesh.shape}
    t8 = Transcriber(params=check_params(int8=True), mesh=mesh,
                     **dict(check_words_kw(), word_timestamps=False))
    seen = record_decodes(t8)
    t8.transcribe(np.concatenate([speech_like(30.0, s) for s in (3, 4, 9, 12)]),
                  remove_silence=False)
    out["check_tokens"] = np.concatenate(seen)
    try:
        Transcriber(params=check_params(int8=True), mesh=mesh_tp, **check_words_kw())
        out["tp2_refused"] = None
    except ValueError as exc:
        out["tp2_refused"] = str(exc)

    base = Transcriber.random_init(INT8_DP_MODEL, mesh=mesh)  # whole bf16 weights on every rank
    eot = base.special.eot
    tb = Transcriber(params=quantize.quantize_decoder(base.params), cfg=base.cfg, mesh=mesh,
                     quantize_self_kv=True, max_new_tokens=96, suppress_tokens=[eot])
    del base
    rng = np.random.default_rng(0)
    t = np.arange(frontend.N_SAMPLES) / frontend.SAMPLE_RATE
    wave = (0.3 * np.sin(2 * np.pi * 150 * t) * (np.sin(2 * np.pi * 1.1 * t) > -0.3)).astype(np.float32)
    batch = np.stack([wave + rng.normal(0, 0.01, frontend.N_SAMPLES).astype(np.float32)
                      for _ in range(INT8_DP_BATCH)])
    rows = mesh.local_rows(INT8_DP_BATCH)
    audio_i16 = torch.from_numpy(np.clip(batch[rows] * 32768.0, -32768, 32767)
                                 .astype(np.int16)).to(mesh.device)
    res = tb._run_decode(tb._frontend_encode(audio_i16))
    if int(res.lengths.min()) != 96 or res.tokens.shape[0] != INT8_DP_BATCH:
        fail(f"int8_weights_dp: the EOT-suppressed decode stopped early: {res.lengths.tolist()}")
    zero_counts(counters)
    enc_ms, dec_ms = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states = tb._frontend_encode(audio_i16)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tb._run_decode(states).tokens.cpu()
        enc_ms.append(1e3 * (t1 - t0))
        dec_ms.append(1e3 * (time.perf_counter() - t1))
    out["launches"] = {c.__name__: c.launches for c in counters}
    out["bench"] = {"batch": INT8_DP_BATCH, "rows_per_rank": rows.stop - rows.start,
                    "tokens": 96, "encode_ms": enc_ms, "decode_ms": dec_ms,
                    "ms_per_decode_step": float(np.median(dec_ms)) / 96,
                    "rtf_x": INT8_DP_BATCH * 30.0e3 / float(np.median(
                        [e + d for e, d in zip(enc_ms, dec_ms)]))}
    return out


def _diarize_check_meeting() -> np.ndarray:
    """The JAX suite's first held-out 20 s 3-speaker meeting (rng 13579)."""
    rng = np.random.default_rng(13579)
    f0s = (float(rng.uniform(95, 120)), float(rng.uniform(190, 240)), float(rng.uniform(320, 378)))
    return make_meeting(rng, f0s, 20.0)[0]


def _diarize_meeting() -> tuple[np.ndarray, list]:
    """The 30 min 4-speaker meeting of the diarize phase (seed 4)."""
    rng = np.random.default_rng(4)
    f0s = (float(rng.uniform(95, 120)), float(rng.uniform(150, 185)),
           float(rng.uniform(220, 270)), float(rng.uniform(320, 378)))
    return make_meeting(rng, f0s, DIARIZE_MEETING_S)


def diarize_f32_check(d) -> tuple[np.ndarray, list]:
    """The check-scale run in float32 (embedding convs too): the 20 s
    meeting's segmentation activations and turns."""
    from audio_processor_tpu_torch.models.diarization import embedding as emb_lib

    d._embed_all = lambda crops: d._batched(crops, lambda x: emb_lib.embed_crops(
        d.emb_params, d.emb_cfg, x, compute_dtype=torch.float32))
    try:
        audio = _diarize_check_meeting()
        return d._segment_all(d._windows(audio)[0]), d.diarize(audio)
    finally:
        del d._embed_all


def _rank_diarize(mesh) -> dict:
    """diarize_tp on this rank: the bundled Diarizer on the mesh, in f32 at
    the check scale (window step 2 s), then the 30 min meeting at its bf16
    default, cold then warm, stage by stage, kernel A counted."""
    from audio_processor_tpu_torch.ops.kernels.log_mel import log_mel
    from audio_processor_tpu_torch.pipeline.diarize import Diarizer

    probs, turns32 = diarize_f32_check(Diarizer.bundled(window_step_s=2.0, mesh=mesh))
    d = Diarizer.bundled(mesh=mesh)
    audio, ref = _diarize_meeting()
    cold, cold_st = timed_diarize(d, audio)
    torch.cuda.reset_peak_memory_stats()
    zero_counts([log_mel])
    warm, st = timed_diarize(d, audio)
    return {"check_probs": probs, "check_turns": turns32, "turns": warm, "ref": ref,
            "warm_equals_cold": warm == cold, "cold_s": cold_st["total_s"], "stages": st,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": {"log_mel": log_mel.launches}}


def _rank_serve(counters) -> dict:
    """serve_tp on this rank: ``build_services`` under APTPU_DISTRIBUTED=1
    at whisper-small width with the bundled diarizer (mesh dp2 x tp2).  The
    followers replay rank 0's calls until its stop message.  Rank 0 serves
    ``create_app`` on a local port: three 2 min meetings through the job API
    at once, one job held to direct mesh calls on its audio, and one
    word-granularity ``/v1`` request held to a direct call with words."""
    import shutil
    import statistics
    import tempfile
    import threading
    from wsgiref.simple_server import WSGIRequestHandler

    from audio_processor_tpu_torch.integrations.gemini import GeminiClient
    from audio_processor_tpu_torch.integrations.notion import NotionClient
    from audio_processor_tpu_torch.pipeline import ingest
    from audio_processor_tpu_torch.pipeline.fuse import fuse_segments, relabel_speakers
    from audio_processor_tpu_torch.runtime.services import build_services
    from audio_processor_tpu_torch.server.app import create_app
    from audio_processor_tpu_torch.utils import wavio

    os.environ.update(APTPU_DISTRIBUTED="1", APTPU_MODEL_PARALLEL="2",
                      CREDENTIAL_STORE_URL="memory://", APTPU_DYNAMIC_BATCH_WAIT_MS="0")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_tp_")
    svc = app = server = None
    zero_counts(counters)
    try:
        t0 = time.perf_counter()
        svc = build_services(model=SERVE_MODEL, store_url=f"sqlite://{tmp}/jobs.db",
                             max_workers=2, with_drive=False, with_llm=False)
        ctl = svc.controller
        out: dict = {"init_s": time.perf_counter() - t0, "mesh": ctl.mesh.shape}
        if not ctl.is_leader:
            ctl.follow()
            torch.cuda.synchronize()
            out.update(followed=True, launches={c.__name__: c.launches for c in counters})
            return out
        WSGIRequestHandler.log_message = lambda self, *a: None
        proc = svc.processor
        # the worlds' decode cap and ids rendered as letters (so that random
        # decodes have words), through the proxy: every call carries them,
        # and the followers rebuild their Transcriber with them
        proc.transcriber = proc.transcriber.replace(max_new_tokens=MESH_PATH_TOKENS,
                                                    tokenizer=LetterTokenizer())
        tr, d = proc.transcriber, proc.diarizer
        prompts, notion_calls = [], []
        proc.gemini = GeminiClient(api_key="k", http=fake_gemini_http(prompts))
        proc.notion = NotionClient(token="t", database_id="db", http=fake_notion_http(notion_calls),
                                   batch_pause_s=0)
        app = create_app(svc, secret_key="chip-smoke")
        port = free_port()
        server = threading.Thread(target=app.run, kwargs=dict(host="127.0.0.1", port=port),
                                  daemon=True)
        server.start()
        base = f"http://127.0.0.1:{port}"
        for _ in range(100):
            try:
                if http_call("GET", base + "/api/health")[0] == 200:
                    break
            except OSError:
                pass
            time.sleep(0.1)
        else:
            fail("serve_tp: the server never answered /api/health")
        wavs = {}
        for seed in SERVE_JOB_SEEDS:
            rng = np.random.default_rng(seed)
            f0s = (float(rng.uniform(95, 120)), float(rng.uniform(150, 185)),
                   float(rng.uniform(220, 270)), float(rng.uniform(320, 378)))
            wavs[seed] = os.path.join(tmp, f"REC_2026061{seed}_093000.wav")
            wavio.write_wav(wavs[seed], make_meeting(rng, f0s, SERVE_MEETING_S)[0], 16_000)
        busy0, calls0 = ctl.busy_s, ctl.calls
        ids, t_sub, done = {}, {}, {}
        t_all = time.perf_counter()
        for seed, path in wavs.items():
            status, data = http_call("POST", base + "/api/process", {"file_id": path})
            if status != 200 or not data.get("success"):
                fail(f"serve_tp: POST /api/process answered {status}: {data}")
            ids[seed], t_sub[seed] = data["job_id"], time.perf_counter()
        while len(done) < len(ids):
            for seed, jid in ids.items():
                if seed not in done:
                    data = http_call("GET", f"{base}/api/job/{jid}")[1]
                    if data["job"]["status"] in ("completed", "failed", "cancelled"):
                        done[seed] = (time.perf_counter() - t_sub[seed], data["job"])
            if time.perf_counter() - t_all > 600:
                fail(f"serve_tp: jobs still running after 600 s: {sorted(set(ids) - set(done))}")
            time.sleep(0.1)
        wall_all = time.perf_counter() - t_all
        torch.cuda.synchronize()
        out["launches_jobs"] = {c.__name__: c.launches for c in counters}
        results, stage_walls = {}, {s: [] for s in SERVE_STAGES}
        for seed, (wall, job) in done.items():
            res = job.get("result") or {}
            stages = svc.engine.store.get(ids[seed]).get("stage_timings") or {}
            if not (job["status"] == "completed" and res.get("success")
                    and res.get("diarizer") == "bundled-synthetic"
                    and set(stages) == set(SERVE_STAGES)):
                fail(f"serve_tp: job {seed} ended {job['status']}: {job.get('error')}, "
                     f"stages {sorted(stages)}")
            results[seed] = res
            for s in SERVE_STAGES:
                stage_walls[s].append(stages[s])
        out["jobs"] = {
            "count": len(done), "audio_s": SERVE_MEETING_S, "workers": 2,
            "wall_s": [done[s][0] for s in SERVE_JOB_SEEDS],
            "processing_s": [results[s]["processing_s"] for s in SERVE_JOB_SEEDS],
            "queue_wait_s": [done[s][0] - results[s]["processing_s"] for s in SERVE_JOB_SEEDS],
            "wall_s_median": statistics.median(done[s][0] for s in SERVE_JOB_SEEDS),
            "all_three_wall_s": wall_all,
            "stage_s_median": {s: statistics.median(v) for s, v in stage_walls.items()},
            "mesh_calls": ctl.calls - calls0,
            "rank0_mesh_busy_share": (ctl.busy_s - busy0) / wall_all,
            "segments": [len(results[s]["segments"]) for s in SERVE_JOB_SEEDS],
        }
        # one job against direct mesh calls (through the proxies) on its audio
        seed = SERVE_JOB_SEEDS[0]
        audio = ingest.load_audio(wavs[seed])
        direct = tr.transcribe(audio)
        direct_turns = d.diarize(audio)
        fused = relabel_speakers(fuse_segments(direct["segments"], direct_turns),
                                 results[seed]["identified_speakers"])
        out["job_equals_direct"] = fused == results[seed]["segments"] and bool(direct_turns)
        if not out["job_equals_direct"]:
            fail(f"serve_tp: job {seed}'s segments differ from direct mesh calls")
        # one word-granularity /v1 request against a direct call with words
        path = os.path.join(tmp, "v1.wav")
        wavio.write_wav(path, speech_like(SERVE_V1_S[0], 20), 16_000)
        with open(path, "rb") as f:
            body = f.read()
        status, word = http_call("POST", base + "/v1/audio/transcriptions", *multipart(
            {"response_format": "verbose_json", "timestamp_granularities[]": "word"},
            "a.wav", body))
        direct = tr.replace(word_timestamps=True).transcribe(ingest.load_audio(path))
        want = [{"word": w["word"], "start": w["start"], "end": w["end"]}
                for seg in direct["segments"] for w in seg["words"]]
        if status != 200 or word.get("words") != want or not want:
            fail(f"serve_tp: the word granularity answered {status}: {word}")
        out["v1_words"] = len(want)
        torch.cuda.synchronize()
        out["launches"] = {c.__name__: c.launches for c in counters}
        return out
    finally:
        if app is not None:
            app.shutdown()
        if server is not None:
            server.join(timeout=30)
        if svc is not None and svc.controller is not None:
            svc.controller.stop()
        if svc is not None and svc.engine is not None:
            svc.engine.shutdown(wait=True)
        for k in ("APTPU_DISTRIBUTED", "APTPU_MODEL_PARALLEL"):
            os.environ.pop(k, None)
        shutil.rmtree(tmp, ignore_errors=True)


def run_world(world: int, tp: int, timeout_s: float, profile: bool,
              target=_tp_rank) -> tuple[list[dict], str]:
    """Spawn ``world`` ranks of ``target`` and collect their results.  A
    rank that fails or exits early, or a world past ``timeout_s``, fails the
    run; every process is stopped on the way out."""
    ctx = torch.multiprocessing.get_context("spawn")
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    results = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, world, tp, port, backend, results, profile))
             for r in range(world)]
    for p in procs:
        p.start()
    got: dict[int, dict] = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) < world:
            if time.monotonic() > deadline:
                fail(f"{target.__name__} world={world}: timed out after {timeout_s} s")
            try:
                rank, ok, value = results.get(timeout=5)
            except queue.Empty:
                dead = {i: p.exitcode for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and i not in got}
                if dead:
                    fail(f"{target.__name__} world={world}: ranks exited {dead}")
                continue
            if not ok:
                fail(f"{target.__name__} world={world}: rank {rank} failed:\n{value}")
            got[rank] = value
        for p in procs:
            p.join(timeout=60)
        codes = {i: p.exitcode for i, p in enumerate(procs) if p.exitcode != 0}
        if codes:
            fail(f"{target.__name__} world={world}: ranks exited {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)], backend


def phase_transcribe_tp(dev, tr) -> tuple[dict, int, list[dict], dict]:
    """Sharded serving, one process a rank: worlds of 2 (dp1 x tp2) and 4
    (dp2 x tp2).  Gates: (a) the check config's greedy and beam-3 tokens
    equal the single-card decode's; (b) whisper-small, bf16, default
    options, 2 min of speech-like audio: every rank returns the same
    transcript and tokens, kernel #5 and log-mel launch on every rank and
    kernel B never does, the schema holds.  Reports the share of decode
    tokens equal to the single card's ``tr`` on the same audio, the warm
    RTFx and, for dp2 x tp2, rank 0's kernel profile (a profiled run costs
    several unprofiled ones, so the smaller world goes without).

    The mesh paths ride in the same worlds, each printed as a phase of its
    own: ``transcribe_words_tp`` in both, ``int8_weights_dp``,
    ``diarize_tp`` and ``serve_tp`` in the 4-rank one (``phase_mesh_paths``
    holds them to the single card's references made here).
    Returns (summary, kernel #5's launches summed over the dp2 x tp2 ranks,
    the mesh paths' phase lines, their launches by kernel)."""
    from audio_processor_tpu_torch.models.whisper import model
    from audio_processor_tpu_torch.pipeline.diarize import Diarizer
    from audio_processor_tpu_torch.pipeline.transcribe import Transcriber

    cfg = check_config()
    params = model.map_params(lambda t: t.to(dev),
                              model.init_params(cfg, torch.Generator().manual_seed(2)))
    single = _check_decodes(cfg, params, _check_audio().to(dev))
    # the single card on the worlds' workload, warm (``tr`` has run): the
    # one-process numbers the meshes are printed beside
    one = dataclasses.replace(tr, max_new_tokens=TP_WORLD_TOKENS)
    seen = record_decodes(one)
    audio = speech_like(TP_WORLD_AUDIO_S, 5)
    single_rtf = one.transcribe(audio)["rtf_x"]
    single_tokens = np.concatenate(seen)
    t0 = time.perf_counter()
    dataclasses.replace(one, word_timestamps=True, hallucination_silence_threshold=2.0,
                        quantize_self_kv=True, tokenizer=LetterTokenizer(),
                        max_new_tokens=MESH_PATH_TOKENS).transcribe(audio)
    torch.cuda.synchronize()
    single_words_rtf = TP_WORLD_AUDIO_S / (time.perf_counter() - t0)
    del one
    # the single card's references of the mesh paths
    refs: dict = {"single_card_rtf_x_with_words": single_words_rtf}
    t = Transcriber(params=check_params(), device=dev, **check_words_kw())
    refs["check_words"] = t.transcribe(speech_like(CHECK_WORDS_AUDIO_S, 7),
                                       remove_silence=False)["words"]
    t8 = Transcriber(params=check_params(int8=True), device=dev,
                     **dict(check_words_kw(), word_timestamps=False))
    seen8 = record_decodes(t8)
    t8.transcribe(np.concatenate([speech_like(30.0, s) for s in (3, 4, 9, 12)]),
                  remove_silence=False)
    refs["int8_tokens"] = np.concatenate(seen8)
    refs["diarize_probs"], refs["diarize_turns"] = diarize_f32_check(
        Diarizer.bundled(window_step_s=2.0, device=dev))
    refs["diarize_bf16_turns"] = Diarizer.bundled(device=dev).diarize(_diarize_meeting()[0])
    del t, t8
    torch.cuda.empty_cache()

    out = {"phase": "transcribe_tp", "model": "small (random weights)",
           "audio_s": TP_WORLD_AUDIO_S, "windows": math.ceil(TP_WORLD_AUDIO_S / 30.0),
           "max_new_tokens": TP_WORLD_TOKENS, "single_card_warm_rtf_x": single_rtf}
    worlds = {}
    for world, tp in ((2, 2), (4, 2)):
        t0 = time.perf_counter()
        ranks, backend = run_world(world, tp, timeout_s=420.0 if world == 2 else 900.0,
                                   profile=world == 4)
        name = f"dp{world // tp}xtp{tp}"
        worlds[name] = (ranks, backend)
        for r in ranks:
            lo, hi = r["check_rows"]
            for k, toks in r["check"].items():
                if not np.array_equal(toks, single[k][lo:hi]):
                    fail(f"transcribe_tp {name} rank {r['rank']}: {k} tokens differ from one card's")
            check_segments(r["warm"], TP_WORLD_AUDIO_S, f"transcribe_tp {name}")
            if r["warm"] != ranks[0]["warm"] or not np.array_equal(r["tokens"], ranks[0]["tokens"]):
                fail(f"transcribe_tp {name}: rank {r['rank']}'s transcript differs from rank 0's")
            launches = r["launches"]
            if not (launches["cross_attention_int4_stacked_tp"] and launches["log_mel"]) \
                    or launches["cross_attention_int4_stacked"]:
                fail(f"transcribe_tp {name} rank {r['rank']}: launches {launches}")
        tokens = ranks[0]["tokens"]
        out[name] = {
            "backend": backend, "devices": [r["device"] for r in ranks],
            "seconds": time.perf_counter() - t0,
            "check_tokens_equal_single_card": True,
            "launches_per_rank": [r["launches"] for r in ranks],
            "cold_rtf_x": ranks[0]["cold_rtf_x"], "warm_rtf_x": ranks[0]["warm_rtf_x"],
            "segments": len(ranks[0]["warm"]["segments"]),
            "language": ranks[0]["warm"].get("language"),
            "profile_rank0": ranks[0].get("profile", "not run for this world"),
            "decode_tokens_equal_single_card_share": (
                float(np.mean(tokens == single_tokens)) if tokens.shape == single_tokens.shape
                else f"shapes differ: {tokens.shape} vs {single_tokens.shape}"),
        }
    kernel5 = sum(l["cross_attention_int4_stacked_tp"] for l in out["dp2xtp2"]["launches_per_rank"])
    phases, launches = phase_mesh_paths(worlds, refs)
    return out, kernel5, phases, launches


def _words_match(got, want, tol: float = 1e-4) -> bool:
    """(word, start, end) equal, probabilities within ``tol``."""
    return len(got) == len(want) and all(
        g[:3] == (w["word"], w["start"], w["end"]) and abs(g[3] - w["probability"]) <= tol
        for g, w in zip(got, want))


def phase_mesh_paths(worlds: dict, refs: dict) -> tuple[list[dict], dict]:
    """The mesh paths' gates and phase lines, from the ranks of the
    transcribe_tp worlds and the single card's references.
    ``transcribe_words_tp`` (dp1 x tp2, dp2 x tp2): every rank's words equal
    rank 0's; the check config's f32 words equal the single card's (probabilities
    within 1e-4); #5 and kernel A launch on every rank and kernel B never.
    ``int8_weights_dp`` (dp4 x tp1): the check config's f32 tokens on int8
    weights equal the single card's; kernel B launches on every rank and #5
    never; tp=2 raised ValueError.  ``diarize_tp`` (dp2 x tp2): every rank's
    turns equal rank 0's; in f32 at the check scale the activations lie
    within 1e-4 of the single card's and the turns are equal; kernel A
    launches on every rank.  ``serve_tp`` (dp2 x tp2): the jobs' gates on
    rank 0 (9 stages, one job equal to direct mesh calls, the /v1 words
    equal a direct call's), the followers exited after the stop message.
    Returns (phase lines, launches by kernel and path, summed over ranks)."""
    from audio_processor_tpu_torch.utils.metrics import diarization_error_rate_detailed

    phases, launches = [], {}
    words = {"phase": "transcribe_words_tp", "model": "small (random weights)",
             "options": "word_timestamps, hallucination_silence_threshold=2.0, quantize_self_kv",
             "audio_s": TP_WORLD_AUDIO_S, "max_new_tokens": MESH_PATH_TOKENS,
             "single_card_rtf_x_with_words": refs["single_card_rtf_x_with_words"]}
    for name, (ranks, backend) in worlds.items():
        for r in ranks:
            w = r["words_tp"]
            if w["words"] != ranks[0]["words_tp"]["words"] or not w["words"]:
                fail(f"transcribe_words_tp {name}: rank {r['rank']}'s words differ from rank 0's")
            if not _words_match(w["check_words"], refs["check_words"]):
                fail(f"transcribe_words_tp {name} rank {r['rank']}: the check config's words "
                     "differ from the single card's")
            lw = w["launches"]
            if not (lw["cross_attention_int4_stacked_tp"] and lw["log_mel"]) \
                    or lw["cross_attention_int4_stacked"]:
                fail(f"transcribe_words_tp {name} rank {r['rank']}: launches {lw}")
        words[name] = {
            "backend": backend, "check_words_equal_single_card": True,
            "check_words": len(refs["check_words"]),
            "words": len(ranks[0]["words_tp"]["words"]),
            "segments": ranks[0]["words_tp"]["segments"],
            "warm_rtf_x_with_words": ranks[0]["words_tp"]["rtf_x"],
            "warm_wall_s_with_words": ranks[0]["words_tp"]["wall_s"],
            "per_rank": [{k: r["words_tp"][k] for k in (
                "teacher_forced_ms_per_slab", "host_chain_ms_per_slab", "dtw_ms_per_slab",
                "wall_s", "launches")} for r in ranks],
        }
    phases.append(words)
    ranks, backend = worlds["dp2xtp2"]
    for key in ("log_mel", "cross_attention_int4_stacked_tp", "cross_attention_int4_stacked"):
        launches[(key, "words_tp")] = sum(r["words_tp"]["launches"][key]
                                          for rs, _ in worlds.values() for r in rs)

    int8 = {"phase": "int8_weights_dp", "backend": backend, "mesh": ranks[0]["int8_dp"]["mesh"],
            "model": f"{INT8_DP_MODEL} (random weights), decoder int8"}
    for r in ranks:
        i8 = r["int8_dp"]
        if not np.array_equal(i8["check_tokens"], refs["int8_tokens"]):
            fail(f"int8_weights_dp rank {r['rank']}: the check config's tokens differ from the "
                 "single card's")
        if not (i8["tp2_refused"] and "model_parallel=1" in i8["tp2_refused"]):
            fail(f"int8_weights_dp rank {r['rank']}: tp=2 was not refused: {i8['tp2_refused']}")
        li = i8["launches"]
        if not li["cross_attention_int4_stacked"] or li["cross_attention_int4_stacked_tp"]:
            fail(f"int8_weights_dp rank {r['rank']}: launches {li}")
    int8.update(check_tokens_equal_single_card=True, tp2_raises_value_error=True,
                bench=ranks[0]["int8_dp"]["bench"],
                launches_per_rank=[r["int8_dp"]["launches"] for r in ranks])
    phases.append(int8)
    for key in ("log_mel", "cross_attention_int4_stacked", "cross_attention_int4_stacked_tp"):
        launches[(key, "int8_dp")] = sum(r["int8_dp"]["launches"][key] for r in ranks)

    d0 = ranks[0]["diarize_tp"]
    for r in ranks:
        dz = r["diarize_tp"]
        err = float(np.abs(dz["check_probs"] - refs["diarize_probs"]).max())
        if not (dz["turns"] == d0["turns"] and dz["turns"] and err <= 1e-4
                and dz["check_turns"] == refs["diarize_turns"] and dz["launches"]["log_mel"]):
            fail(f"diarize_tp rank {r['rank']}: turns equal rank 0's {dz['turns'] == d0['turns']}, "
                 f"f32 activations max abs err {err}, f32 turns equal "
                 f"{dz['check_turns'] == refs['diarize_turns']}, launches {dz['launches']}")
    phases.append({
        "phase": "diarize_tp", "backend": backend, "model": "bundled", "mesh": "dp2xtp2",
        "audio_s": DIARIZE_MEETING_S, "check_f32_turns_equal_single_card": True,
        "check_f32_activations_max_abs_err": max(
            float(np.abs(r["diarize_tp"]["check_probs"] - refs["diarize_probs"]).max())
            for r in ranks),
        "cold_s": d0["cold_s"], "stages": d0["stages"],
        "warm_rtf_x": DIARIZE_MEETING_S / d0["stages"]["total_s"],
        "peak_mem_gb_rank0": d0["peak_mem_gb"], "turns": len(d0["turns"]),
        "warm_equals_cold": d0["warm_equals_cold"],
        "der_vs_reference": diarization_error_rate_detailed(d0["ref"], d0["turns"],
                                                            collar_s=0.25),
        "der_vs_single_card_bf16": diarization_error_rate_detailed(
            refs["diarize_bf16_turns"], d0["turns"], collar_s=0.0),
        "launches_per_rank": [r["diarize_tp"]["launches"] for r in ranks],
    })
    launches[("log_mel", "diarize_tp")] = sum(r["diarize_tp"]["launches"]["log_mel"] for r in ranks)

    s0 = ranks[0]["serve_tp"]
    if not all(r["serve_tp"].get("followed") for r in ranks[1:]):
        fail("serve_tp: a follower did not leave on the stop message")
    for r in ranks:
        ls = r["serve_tp"]["launches"]
        if not (ls["log_mel"] and ls["cross_attention_int4_stacked_tp"]) \
                or ls["cross_attention_int4_stacked"]:
            fail(f"serve_tp rank {r['rank']}: launches {ls}")
    phases.append({
        "phase": "serve_tp", "backend": backend, "model": f"{SERVE_MODEL} (random weights, seed 0)",
        "max_new_tokens": MESH_PATH_TOKENS, "mesh": s0["mesh"], "init_s": s0["init_s"],
        "jobs": s0["jobs"],
        "job_equals_direct_mesh_calls": s0["job_equals_direct"], "v1_words": s0["v1_words"],
        "followers_left_on_stop": True,
        "launches_jobs_rank0": s0["launches_jobs"],
        "launches_per_rank": [r["serve_tp"]["launches"] for r in ranks],
    })
    for key in ("log_mel", "cross_attention_int4_stacked_tp", "cross_attention_int4_stacked"):
        launches[(key, "serve_tp")] = sum(r["serve_tp"]["launches"][key] for r in ranks)
    return phases, launches


def zero_counts(counters) -> None:
    for c in counters:
        c.launches = 0


def read_counts(counters, off_path, phase: str) -> dict:
    """Launches since zero_counts; every kernel in ``counters`` must have
    launched, those in ``off_path`` (on no path) are read as they are."""
    launches = {c.__name__: c.launches for c in counters}
    if not all(launches.values()):
        fail(f"{phase}: a kernel of the path never launched: {launches}")
    return {**launches, **{c.__name__: c.launches for c in off_path}}


def phase_transcribe(dev, counters, off_path=()) -> tuple[dict, object]:
    from audio_processor_tpu_torch.pipeline.transcribe import Transcriber

    t0 = time.perf_counter()
    tr = Transcriber.random_init("small", device=dev)  # bf16, int4 cross-KV, fallback off
    init_s = time.perf_counter() - t0
    seen = record_decodes(tr)
    audio = speech_like(TP_AUDIO_S, 5)
    cold = tr.transcribe(audio)
    torch.cuda.synchronize()
    zero_counts([*counters, *off_path])
    seen.clear()
    warm = tr.transcribe(audio)
    torch.cuda.synchronize()
    launches = read_counts(counters, off_path, "transcribe")
    for out in (cold, warm):
        check_segments(out, TP_AUDIO_S, "transcribe")
    tr.tokens = np.concatenate(seen)  # the warm run's decode, for transcribe_tp
    return {
        "phase": "transcribe", "model": "small (random weights)", "audio_s": TP_AUDIO_S,
        "windows": math.ceil(len(audio) / 480_000), "init_s": init_s,
        "cold_rtf_x": cold["rtf_x"], "warm_rtf_x": warm["rtf_x"],
        "segments": len(warm["segments"]), "language": warm.get("language"),
        "launches": launches,
    }, tr


def phase_transcribe_openai(dev, counters, off_path=()) -> dict:
    """openai-whisper's CLI defaults on the port: beam 5, conditioned on the
    previous text, an initial prompt carried to every window, through the
    fused encoder; 2 min of speech-like audio (4 windows), cold then warm.
    Every counted kernel must launch in the warm run."""
    from audio_processor_tpu_torch.pipeline.transcribe import Transcriber

    tr = Transcriber.random_init(
        "small", device=dev, beam_size=5, condition_on_previous_text=True,
        initial_prompt="Minutes of the weekly planning meeting.", carry_initial_prompt=True,
        use_pallas_encoder_attn=True,
    )
    audio = speech_like(120.0, 10)
    cold = tr.transcribe(audio)
    torch.cuda.synchronize()
    zero_counts([*counters, *off_path])
    warm = tr.transcribe(audio)
    torch.cuda.synchronize()
    launches = read_counts(counters, off_path, "transcribe_openai_defaults")
    for out in (cold, warm):
        if not math.isclose(out["duration"], 120.0):
            fail(f"transcribe_openai_defaults: duration {out['duration']}")
        for seg in out["segments"]:
            if not (0.0 <= seg["start"] <= seg["end"] <= 120.0 + 1e-6
                    and np.isfinite(seg["avg_logprob"])):
                fail(f"transcribe_openai_defaults: bad segment {seg}")
    return {
        "phase": "transcribe_openai_defaults", "model": "small (random weights)",
        "options": "beam_size=5, condition_on_previous_text, initial_prompt + carry, fused encoder",
        "audio_s": 120.0, "windows": math.ceil(len(audio) / 480_000),
        "cold_rtf_x": cold["rtf_x"], "warm_rtf_x": warm["rtf_x"],
        "segments": len(warm["segments"]), "launches": launches,
    }


WORDS_MODEL = "small"
WORDS_AUDIO_S = 240.0


def phase_transcribe_words(dev, counters, card: str) -> dict:
    """The ``transcribe`` cell with word_timestamps=True,
    hallucination_silence_threshold=2.0 and quantize_self_kv=True
    (whisper-small, random weights from seed 0, 4 min: one slab of 8
    windows; ids rendered as letters, so that random decodes have words),
    cold then warm, and warm once more without words on the same
    weights.  The word pass's parts are timed in the warm run by wrapping
    ``align``'s stages: the teacher-forced pass (device, read back), the
    host chain (crop, z-score, median filter) and the DTW; the C++ DTW and
    its numpy twin are then timed on the run's own costs and must give
    equal starts.  Kernels A and B must launch in the warm run."""
    from audio_processor_tpu_torch.models.whisper import align
    from audio_processor_tpu_torch.ops.kernels import dtw
    from audio_processor_tpu_torch.pipeline.transcribe import Transcriber

    t_phase = time.perf_counter()
    tr = Transcriber.random_init(WORDS_MODEL, device=dev, word_timestamps=True,
                                 hallucination_silence_threshold=2.0, quantize_self_kv=True,
                                 tokenizer=LetterTokenizer())
    plain = dataclasses.replace(tr, word_timestamps=False, hallucination_silence_threshold=None)
    audio = speech_like(WORDS_AUDIO_S, 5)
    stages: dict[str, list] = {"maps": [], "costs": [], "dtw": []}
    real = {name: getattr(align, name) for name in ("alignment_maps", "alignment_costs",
                                                     "dtw_starts")}

    def timed(name, key):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = real[name](*args, **kw)
            stages[key].append((1e3 * (time.perf_counter() - t0), out, args))
            return out
        return run

    cold = tr.transcribe(audio)
    torch.cuda.synchronize()
    for name, key in (("alignment_maps", "maps"), ("alignment_costs", "costs"),
                      ("dtw_starts", "dtw")):
        setattr(align, name, timed(name, key))
    try:
        zero_counts(counters)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        warm = tr.transcribe(audio)
        torch.cuda.synchronize()
        words_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launches = read_counts(counters, (), "transcribe_words")
    finally:
        for name, fn in real.items():
            setattr(align, name, fn)
    t0 = time.perf_counter()
    without = plain.transcribe(audio)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    for out in (cold, warm, without):
        check_segments(out, WORDS_AUDIO_S, "transcribe_words")
    if not all(0.0 <= w["start"] <= w["end"] <= WORDS_AUDIO_S + 1e-6 for w in warm["words"]):
        fail("transcribe_words: a word outside the recording")
    # the C++ DTW against its twin on this run's costs
    dtw_native_ms, dtw_twin_ms, equal = [], [], True
    for _, (cost, rows, frames), _ in stages["costs"]:
        t0 = time.perf_counter()
        native = dtw.dtw_native(cost, rows, frames)
        dtw_native_ms.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        twin = dtw.dtw_wavefront(cost, rows, frames)
        dtw_twin_ms.append(1e3 * (time.perf_counter() - t0))
        equal &= bool(np.array_equal(native, twin))
    if not (stages["costs"] and equal):
        fail(f"transcribe_words: C++ DTW starts equal the twin's: {equal} "
             f"over {len(stages['costs'])} slabs")
    cost_shapes = [list(c[1][0].shape) for c in stages["costs"]]
    return {
        "phase": "transcribe_words", "card": card, "model": f"{WORDS_MODEL} (random weights)",
        "options": "word_timestamps, hallucination_silence_threshold=2.0, quantize_self_kv",
        "audio_s": WORDS_AUDIO_S, "windows": math.ceil(len(audio) / 480_000),
        "slabs": len(stages["maps"]), "dtw_cost_shapes": cost_shapes,
        "teacher_forced_ms_per_slab": [m[0] for m in stages["maps"]],
        "host_chain_ms_per_slab": [m[0] for m in stages["costs"]],
        "dtw_ms_per_slab_in_run": [m[0] for m in stages["dtw"]],
        "dtw_native_ms_per_slab": dtw_native_ms, "dtw_twin_ms_per_slab": dtw_twin_ms,
        "dtw_native_equals_twin": equal,
        "cold_wall_s": audio.size / 16_000 / cold["rtf_x"],
        "warm_wall_s_with_words": words_s, "warm_wall_s_without_words": plain_s,
        "warm_rtf_x_with_words": WORDS_AUDIO_S / words_s,
        "warm_rtf_x_without_words": WORDS_AUDIO_S / plain_s,
        "words": len(warm["words"]), "segments": len(warm["segments"]),
        "peak_mem_gb": peak_gb, "launches": launches,
        "seconds": time.perf_counter() - t_phase,
    }


def phase_bench(dev, tr, bs: int, n_timed: int, profile: bool, *, fused_encoder: bool = False,
                decoder: str = "int4", counters=()) -> dict:
    """The JAX package's bench.py headline workload on the port: int16 30 s
    chunks -> log-mel -> encode -> 96-token decode, EOT suppressed, bf16,
    ``bs`` windows a batch (bench.py and the Transcriber's default slab use
    128).  ``decoder``: "int4" greedy (kernel B, the default), "int8-kernel"
    greedy (the int8 kernel), "beam5" (beam search over the int4 cache) or
    "int4-self-int8-w8" (int4 greedy with the int8 self cache on int8
    decoder weights, bench.py's --self-kv-int8 --int8-weights: the bf16
    weights quantized, their scales float32);
    ``fused_encoder`` runs encoder attention through its kernel (bench.py
    --fused-encoder).  ``counters`` are zeroed before the timed batches and
    read after them."""
    from audio_processor_tpu_torch.models.whisper import decode, model, quantize
    from audio_processor_tpu_torch.ops import frontend
    from audio_processor_tpu_torch.ops.kernels.log_mel import log_mel

    tokens = 96
    cfg, st = tr.cfg, tr.special
    rng = np.random.default_rng(0)
    t = np.arange(frontend.N_SAMPLES) / frontend.SAMPLE_RATE
    base = (0.3 * np.sin(2 * np.pi * 150 * t) * (np.sin(2 * np.pi * 1.1 * t) > -0.3)).astype(np.float32)
    batch = np.stack([base + rng.normal(0, 0.01, frontend.N_SAMPLES).astype(np.float32) for _ in range(bs)])
    audio_i16 = torch.from_numpy(np.clip(batch * 32768.0, -32768, 32767).astype(np.int16)).to(dev)
    suppress = torch.zeros(cfg.n_vocab, dtype=torch.bool, device=dev)
    suppress[st.eot] = True

    def encode():
        mel = log_mel(audio_i16.float() / 32768.0, cfg.n_mels)
        return model.encode(tr.params, cfg, mel, compute_dtype=torch.bfloat16,
                            fused_attn=fused_encoder)

    kw = dict(sot_sequence=tuple(st.sot_sequence()), max_new_tokens=tokens, use_timestamps=True,
              suppress_mask=suppress, dtype_name="bfloat16", quantize_cross_kv=True)

    params8 = quantize.quantize_decoder(tr.params) if decoder == "int4-self-int8-w8" else None

    def run_decode(states):
        if decoder == "beam5":
            return decode.beam_decode(tr.params, cfg, states, beam_size=5, kv_bits=4, **kw)
        if decoder == "int8-kernel":
            return decode.greedy_decode(tr.params, cfg, states, kv_bits=8, use_pallas_kernel=True, **kw)
        if params8 is not None:
            return decode.greedy_decode(params8, cfg, states, kv_bits=4, quantize_self_kv=True, **kw)
        return decode.greedy_decode(tr.params, cfg, states, kv_bits=4, **kw)

    # warm-up, which also reads the peak memory of each half at this batch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    states = encode()
    torch.cuda.synchronize()
    enc_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    res = run_decode(states)
    torch.cuda.synchronize()
    dec_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del states
    if not (res.tokens.shape[0] == bs and int(res.lengths.min()) == tokens):
        fail(f"bench B={bs} {decoder}: EOT-suppressed decode stopped early: {res.lengths.tolist()}")
    # the decode loop is host-bound, and host time varies from call to call:
    # time several batches and report the median with its range
    zero_counts(counters)
    enc_ms, dec_ms = [], []
    for _ in range(n_timed):
        t0 = time.perf_counter()
        states = encode()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        run_decode(states).tokens.cpu()
        t2 = time.perf_counter()
        enc_ms.append(1e3 * (t1 - t0))
        dec_ms.append(1e3 * (t2 - t1))
    launches = read_counts(counters, (), f"bench B={bs} {decoder}")
    batch_ms = [e + d for e, d in zip(enc_ms, dec_ms)]
    med = float(np.median(batch_ms))
    out = {
        "phase": "bench", "model": "small", "batch": bs, "tokens": tokens, "dtype": "bfloat16",
        "decoder": decoder, "fused_encoder": fused_encoder,
        "batches_timed": len(batch_ms), "rtf_x": bs * 30.0 / (med / 1e3),
        "rtf_x_range": [bs * 30.0e3 / max(batch_ms), bs * 30.0e3 / min(batch_ms)],
        "encode_ms_per_batch": float(np.median(enc_ms)),
        "decode_ms_per_batch": float(np.median(dec_ms)),
        "ms_per_decode_step": float(np.median(dec_ms)) / tokens,
        "ms_per_decode_step_range": [min(dec_ms) / tokens, max(dec_ms) / tokens],
        "weights_gb": base_gb, "encode_peak_mem_gb": enc_peak_gb,
        "decode_peak_mem_gb": dec_peak_gb, "launches": launches,
    }
    if profile:
        out["profile"] = profile_decode(lambda: run_decode(encode()).tokens.cpu(), med)
    return out


def profile_decode(fn, unprofiled_ms: float) -> dict | str:
    """Device time by kernel over one encode+decode batch (the card's
    activity alone).  The busy share divides the kernel time by the
    UNPROFILED wall time of the same work, since the profiler slows the
    host."""
    rows = kernel_rows(fn, cpu_ops=False)
    if not rows:
        return "not measured (the profiler recorded no kernel time)"
    total = sum(r[0] for r in rows)
    return {
        "kernel_ms": total, "unprofiled_wall_ms": unprofiled_ms,
        "device_busy_share": total / unprofiled_ms,
        "top": [{"name": k[:90], "ms": ms, "calls": n} for ms, k, n in rows[:14]],
    }


def make_meeting(rng, f0s, duration_s: float, sr: int = 16_000) -> tuple[np.ndarray, list]:
    """The JAX suite's held-out meeting generator (``tests/test_bundled_diarizer.py``)
    on the port's ``synth_voice``: speakers in rotation, turns of 1.2-2 s,
    gaps of 0.3-0.6 s, a 0.003 noise floor.  Returns (audio, reference turns)."""
    from audio_processor_tpu_torch.models.diarization.checkpoint import synth_voice

    audio = rng.normal(0, 0.003, int(duration_s * sr)).astype(np.float32)
    ref = []
    t, i = 0.3, 0
    while t < duration_s - 2.0:
        spk = i % len(f0s)
        dur = float(rng.uniform(1.2, 2.0))
        a, b = int(t * sr), int(min(t + dur, duration_s) * sr)
        audio[a:b] += synth_voice(rng, f0s[spk], b - a, sr)
        ref.append({"start": round(t, 3), "end": round(t + dur, 3), "speaker": f"REF_{spk}"})
        t += dur + float(rng.uniform(0.3, 0.6))
        i += 1
    return audio, ref


def timed_diarize(d, audio: np.ndarray) -> tuple[list, dict]:
    """``d.diarize(audio)`` with the wall seconds of its stages: windows +
    segmentation (the slabs come back to the host, so the card is done),
    crop gather (host), embedding (the slabs come back), clustering (host
    AHC), stitch + binarise (host).  The stages are read by wrapping the
    Diarizer's two net calls and the clustering function for this call."""
    from audio_processor_tpu_torch.models.diarization import clustering

    marks: dict = {}
    seg_all, embed_all, cluster = d._segment_all, d._embed_all, clustering.agglomerative_cluster

    def wrap(name, fn):
        def run(*args, **kw):
            marks[name + "_start"] = time.perf_counter()
            res = fn(*args, **kw)
            marks[name + "_end"] = time.perf_counter()
            marks[name + "_rows"] = len(args[0])
            return res
        return run

    d._segment_all, d._embed_all = wrap("segment", seg_all), wrap("embed", embed_all)
    clustering.agglomerative_cluster = wrap("cluster", cluster)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        turns = d.diarize(audio)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        del d._segment_all, d._embed_all
        clustering.agglomerative_cluster = cluster
    if "cluster_end" not in marks:
        fail(f"diarize: no speech reached the embedding net ({len(turns)} turns)")
    return turns, {
        "total_s": t1 - t0, "windows": marks["segment_rows"], "crops": marks["embed_rows"],
        "windows_segment_s": marks["segment_end"] - t0,
        "crop_gather_s": marks["embed_start"] - marks["segment_end"],
        "embed_s": marks["embed_end"] - marks["embed_start"],
        "cluster_s": marks["cluster_end"] - marks["cluster_start"],
        "stitch_binarize_s": t1 - marks["cluster_end"],
    }


# ---------------------------------------------------------------------------
# serve: the meeting-notes service over HTTP
# ---------------------------------------------------------------------------

SERVE_MODEL = "small"
SERVE_MEETING_S = 120.0
SERVE_JOB_SEEDS = (4, 5, 6)
SERVE_V1_S = (30.0, 40.0, 50.0, 60.0)
# the job's stage marks (JobContext.stage messages): the 9 stages, stage 4
# in two marks (decode, then transcribe + diarize + fuse)
SERVE_STAGES = (
    "Fetching file metadata...", "Downloading attachments...", "Downloading audio file...",
    "Decoding audio...", "Transcribing on the device...", "Identifying speakers...",
    "Building transcript...", "Generating summary...", "Creating Notion page...",
    "Organizing Drive files...",
)


def fake_gemini_http(prompts: list):
    """A Gemini transport that answers each of the job's three prompts
    (speaker names, summary, notes) as the API would, recording them."""
    def http(url, headers, payload, timeout):
        prompt = payload["contents"][0]["parts"][0]["text"]
        prompts.append(prompt)
        if "mapping each speaker code" in prompt:
            text = '{"SPEAKER_00": "Alice", "SPEAKER_01": "Bob"}'
        elif '"todos"' in prompt:
            text = json.dumps({"title": "Weekly sync", "summary": "We planned the week.",
                               "todos": ["ship the port"]})
        else:
            text = "# Notes\n- point one"
        return 200, {"candidates": [{"content": {"parts": [{"text": text}]}}]}

    return http


def fake_notion_http(calls: list):
    """A Notion transport that creates the page and accepts its blocks."""
    def http(method, url, headers, payload, timeout):
        calls.append((method, url))
        if method == "POST" and url.endswith("/pages"):
            return 200, {"id": "page-7", "url": "https://notion.so/page-7"}
        return 200, {}

    return http


def http_call(method: str, url: str, body=None, ctype: str = "application/json"):
    """One request to the local server, no proxy; returns (status, JSON or text)."""
    import urllib.error
    import urllib.request

    data = json.dumps(body).encode() if isinstance(body, dict) else body
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": ctype} if data is not None else {})
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        with opener.open(req, timeout=900) as resp:
            status, raw = resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        status, raw = exc.code, exc.read()
    try:
        return status, json.loads(raw)
    except ValueError:
        return status, raw.decode()


def multipart(fields: dict, filename: str, payload: bytes) -> tuple[bytes, str]:
    boundary = "chipsmoke7"
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
             for k, v in fields.items()]
    parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="file"; '
                 f'filename="{filename}"\r\nContent-Type: audio/wav\r\n\r\n'.encode()
                 + payload + b"\r\n")
    return b"".join(parts) + f"--{boundary}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_serve(dev, card: str, mesh_jobs: dict | None = None) -> tuple[dict, dict]:
    """The port's service on the card, over real HTTP: ``build_services``
    at whisper-small width (random weights, seed 0) with the bundled
    diarizer, an sqlite store and 2 job workers, Gemini and Notion on fake
    transports; ``create_app`` served from a thread.  Three 2 min 4-speaker
    meetings go through ``POST /api/process`` at once and are polled to
    the end (every stage timed; one job's decoded tokens, turns and fused
    segments held to direct calls on the same audio; kernels A and B
    counted); then 4 concurrent ``/v1`` uploads, which must coalesce and
    each equal its own ``transcribe``, an srt request and a word-granularity
    request, whose words must equal a direct ``transcribe`` with
    word_timestamps.  The three jobs run again at the mesh paths' 96-token
    cap, printed beside ``mesh_jobs`` (``serve_tp``'s jobs, the same three
    at that cap on dp2 x tp2), and once more under the profiler for the
    card's busy share."""
    import shutil
    import statistics
    import tempfile
    import threading
    from wsgiref.simple_server import WSGIRequestHandler

    from audio_processor_tpu_torch.integrations.gemini import GeminiClient
    from audio_processor_tpu_torch.integrations.notion import NotionClient
    from audio_processor_tpu_torch.ops.kernels.decode_attention import cross_attention_int4_stacked
    from audio_processor_tpu_torch.ops.kernels.log_mel import log_mel
    from audio_processor_tpu_torch.pipeline import ingest
    from audio_processor_tpu_torch.pipeline.fuse import fuse_segments, relabel_speakers
    from audio_processor_tpu_torch.runtime.services import build_services
    from audio_processor_tpu_torch.server import openai_api
    from audio_processor_tpu_torch.server.app import create_app
    from audio_processor_tpu_torch.utils import wavio

    counters = [log_mel, cross_attention_int4_stacked]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    saved_env = {k: os.environ.get(k) for k in ("CREDENTIAL_STORE_URL", "APTPU_DYNAMIC_BATCH_WAIT_MS")}
    os.environ["CREDENTIAL_STORE_URL"] = "memory://"
    # the dev server logs every request to stderr: the polls would bury the log
    log_request = WSGIRequestHandler.log_message
    WSGIRequestHandler.log_message = lambda self, *a: None
    svc = app = server = None
    out: dict = {"phase": "serve", "card": card, "model": f"{SERVE_MODEL} (random weights, seed 0)"}
    try:
        t0 = time.perf_counter()
        svc = build_services(model=SERVE_MODEL, store_url=f"sqlite://{tmp}/jobs.db", max_workers=2,
                             with_drive=False, with_llm=False, device=dev)
        out["init_s"] = time.perf_counter() - t0
        proc = svc.processor
        tr, d = proc.transcriber, proc.diarizer
        if tr.device != dev:
            fail(f"serve: the Transcriber is on {tr.device}, not {dev}")
        if d is None or d.provenance != "bundled-synthetic":
            fail(f"serve: the served diarizer is not the bundled one: {d and d.provenance}")
        prompts, notion_calls = [], []
        proc.gemini = GeminiClient(api_key="k", http=fake_gemini_http(prompts))
        proc.notion = NotionClient(token="t", database_id="db", http=fake_notion_http(notion_calls),
                                   batch_pause_s=0)
        # per job: every decode's tokens and the diarizer's turns, keyed by
        # the job the worker thread runs
        job_of = threading.local()
        decodes: dict = {}
        turns_of: dict = {}
        run_decode, diarize, process = tr._run_decode, d.diarize, proc.process

        def rec_decode(*a, **kw):
            res = run_decode(*a, **kw)
            decodes.setdefault(getattr(job_of, "id", None), []).append(res.tokens.cpu().numpy())
            return res

        def rec_diarize(*a, **kw):
            turns_of[getattr(job_of, "id", None)] = turns = diarize(*a, **kw)
            return turns

        def rec_process(ctx, *a, **kw):
            job_of.id = ctx.job_id
            try:
                return process(ctx, *a, **kw)
            finally:
                job_of.id = None

        tr._run_decode, d.diarize, proc.process = rec_decode, rec_diarize, rec_process

        app = create_app(svc, secret_key="chip-smoke")
        port = free_port()
        server = threading.Thread(target=app.run, kwargs=dict(host="127.0.0.1", port=port),
                                  daemon=True)
        server.start()
        base = f"http://127.0.0.1:{port}"
        for _ in range(100):
            try:
                if http_call("GET", base + "/api/health")[0] == 200:
                    break
            except OSError:
                pass
            time.sleep(0.1)
        else:
            fail("serve: the server never answered /api/health")

        wavs = {}
        for seed in SERVE_JOB_SEEDS:
            rng = np.random.default_rng(seed)
            f0s = (float(rng.uniform(95, 120)), float(rng.uniform(150, 185)),
                   float(rng.uniform(220, 270)), float(rng.uniform(320, 378)))
            audio, _ = make_meeting(rng, f0s, SERVE_MEETING_S)
            wavs[seed] = os.path.join(tmp, f"REC_2026061{seed}_093000.wav")
            wavio.write_wav(wavs[seed], audio, 16_000)

        def run_jobs() -> tuple[dict, dict, float]:
            """Submit every meeting at once, poll each to its end; returns
            (job ids, (client wall s, final status) by seed, wall s of all)."""
            ids, t_sub, done = {}, {}, {}
            t_all = time.perf_counter()
            for seed, path in wavs.items():
                status, data = http_call("POST", base + "/api/process", {"file_id": path})
                if status != 200 or not data.get("success"):
                    fail(f"serve: POST /api/process answered {status}: {data}")
                ids[seed], t_sub[seed] = data["job_id"], time.perf_counter()
            deadline = time.perf_counter() + 600
            while len(done) < len(ids):
                for seed, jid in ids.items():
                    if seed not in done:
                        status, data = http_call("GET", f"{base}/api/job/{jid}")
                        if data["job"]["status"] in ("completed", "failed", "cancelled"):
                            done[seed] = (time.perf_counter() - t_sub[seed], data["job"])
                if time.perf_counter() > deadline:
                    fail(f"serve: jobs still running after 600 s: {sorted(set(ids) - set(done))}")
                time.sleep(0.1)
            return ids, done, time.perf_counter() - t_all

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(counters)
        ids, done, wall_all = run_jobs()
        torch.cuda.synchronize()
        launches = read_counts(counters, (), "serve jobs")
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        stage_walls: dict = {s: [] for s in SERVE_STAGES}
        for seed, (wall, job) in done.items():
            res = job.get("result") or {}
            if not (job["status"] == "completed" and job["progress"] == 100 and res.get("success")
                    and res.get("diarizer") == "bundled-synthetic"
                    and res.get("notion_page_id") == "page-7"):
                fail(f"serve: job {seed} ended {job['status']}: {job.get('error')} {res}")
            stages = svc.engine.store.get(ids[seed]).get("stage_timings") or {}
            if set(stages) != set(SERVE_STAGES):
                fail(f"serve: job {seed} timed the stages {sorted(stages)}")
            for s in SERVE_STAGES:
                stage_walls[s].append(stages[s])
        results = {seed: done[seed][1]["result"] for seed in done}
        out["jobs"] = {
            "count": len(done), "audio_s": SERVE_MEETING_S, "speakers": 4, "workers": 2,
            "wall_s": [done[s][0] for s in SERVE_JOB_SEEDS],
            "processing_s": [results[s]["processing_s"] for s in SERVE_JOB_SEEDS],
            "rtf_x": [results[s]["rtf_x"] for s in SERVE_JOB_SEEDS],
            "wall_s_median": statistics.median(done[s][0] for s in SERVE_JOB_SEEDS),
            "rtf_x_median": statistics.median(results[s]["rtf_x"] for s in SERVE_JOB_SEEDS),
            "all_three_wall_s": wall_all,
            "stage_s_median": {s: statistics.median(v) for s, v in stage_walls.items()},
            "segments": [len(results[s]["segments"]) for s in SERVE_JOB_SEEDS],
            "decode_rows": [sum(len(t) for t in decodes.get(ids[s], [])) for s in SERVE_JOB_SEEDS],
            "turns": [len(turns_of.get(ids[s], [])) for s in SERVE_JOB_SEEDS],
            "gemini_prompts": len(prompts), "notion_requests": len(notion_calls),
        }
        out["launches_jobs"] = launches

        # one job against direct calls on the same audio, on the card
        seed = SERVE_JOB_SEEDS[0]
        jid = ids[seed]
        audio = ingest.load_audio(wavs[seed])
        job_of.id = "direct"
        direct = tr.transcribe(audio)
        direct_turns = d.diarize(audio)
        job_of.id = None
        job_tokens, direct_tokens = decodes.get(jid, []), decodes.get("direct", [])
        tokens_equal = bool(job_tokens) and len(job_tokens) == len(direct_tokens) and all(
            np.array_equal(a, b) for a, b in zip(job_tokens, direct_tokens))
        fused = relabel_speakers(fuse_segments(direct["segments"], direct_turns),
                                 results[seed]["identified_speakers"])
        out["job_vs_direct"] = {"tokens_equal": tokens_equal,
                                "turns_equal": turns_of.get(jid) == direct_turns,
                                "segments_equal": fused == results[seed]["segments"],
                                "decodes": len(job_tokens), "turns": len(direct_turns)}
        if not (tokens_equal and direct_turns and all(out["job_vs_direct"].values())):
            fail(f"serve: job {seed} differs from the direct calls: {out['job_vs_direct']}")

        # /v1: 4 concurrent uploads through the dynamic batcher
        os.environ["APTPU_DYNAMIC_BATCH_WAIT_MS"] = "50"
        openai_api._batch_stats.update(batches=0, files=0)
        clips = []
        for i, secs in enumerate(SERVE_V1_S):
            path = os.path.join(tmp, f"v1_{i}.wav")
            wavio.write_wav(path, speech_like(secs, 20 + i), 16_000)
            with open(path, "rb") as f:
                clips.append((path, f.read()))
        bodies = [multipart({}, os.path.basename(p), b) for p, b in clips]
        v1 = [None] * len(bodies)
        barrier = threading.Barrier(len(bodies))

        def upload(i):
            barrier.wait()
            v1[i] = http_call("POST", base + "/v1/audio/transcriptions", *bodies[i])

        zero_counts(counters)
        t0 = time.perf_counter()
        threads = [threading.Thread(target=upload, args=(i,)) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        v1_wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        v1_launches = read_counts(counters, (), "serve /v1")
        stats = openai_api.dynamic_batch_stats()
        if not all(r and r[0] == 200 for r in v1):
            fail(f"serve: /v1 uploads answered {[r and r[0] for r in v1]}")
        if not (stats["batches"] >= 1 and stats["files"] > stats["batches"]):
            fail(f"serve: the /v1 uploads did not coalesce: {stats}")
        os.environ["APTPU_DYNAMIC_BATCH_WAIT_MS"] = "0"
        own = [tr.transcribe(ingest.load_audio(p))["text"].strip() for p, _ in clips]
        if [r[1]["text"] for r in v1] != own:
            fail("serve: a /v1 text differs from its own transcribe")
        srt_status, srt = http_call("POST", base + "/v1/audio/transcriptions",
                                    *multipart({"response_format": "srt"}, "a.wav", clips[0][1]))
        if srt_status != 200 or not isinstance(srt, str):
            fail(f"serve: the srt request answered {srt_status}")
        status, word = http_call("POST", base + "/v1/audio/transcriptions", *multipart(
            {"response_format": "verbose_json", "timestamp_granularities[]": "word"},
            "a.wav", clips[0][1]))
        direct = dataclasses.replace(tr, word_timestamps=True).transcribe(
            ingest.load_audio(clips[0][0]))
        want = [{"word": w["word"], "start": w["start"], "end": w["end"]}
                for seg in direct["segments"] for w in seg["words"]]
        if status != 200 or word.get("words") != want:
            fail(f"serve: the word granularity answered {status}: {word}")
        out["v1"] = {"uploads": len(clips), "audio_s": list(SERVE_V1_S), "wall_s": v1_wall,
                     "batch_stats": stats, "texts_equal_own_transcribe": True,
                     "srt_status": srt_status, "word_status": status, "v1_words": len(want)}
        out["launches_v1"] = v1_launches

        # the same three jobs at the mesh paths' cap, as serve_tp runs them
        proc.transcriber = dataclasses.replace(tr, max_new_tokens=MESH_PATH_TOKENS,
                                               tokenizer=LetterTokenizer())
        try:
            _, cap_done, cap_wall = run_jobs()
        finally:
            proc.transcriber = tr
        cap = {seed: job.get("result") or {} for seed, (_, job) in cap_done.items()}
        if not all(job["status"] == "completed" and cap[seed].get("success")
                   for seed, (_, job) in cap_done.items()):
            fail(f"serve: a job at {MESH_PATH_TOKENS} tokens failed: "
                 f"{[job.get('error') for _, job in cap_done.values()]}")
        walls = ("wall_s", "processing_s", "queue_wait_s", "all_three_wall_s")
        out["jobs_at_mesh_cap"] = {
            "max_new_tokens": MESH_PATH_TOKENS,
            "one_process": {
                "wall_s": [cap_done[s][0] for s in SERVE_JOB_SEEDS],
                "processing_s": [cap[s]["processing_s"] for s in SERVE_JOB_SEEDS],
                "queue_wait_s": [cap_done[s][0] - cap[s]["processing_s"] for s in SERVE_JOB_SEEDS],
                "all_three_wall_s": cap_wall},
            "serve_tp_dp2xtp2": None if mesh_jobs is None else {k: mesh_jobs[k] for k in walls},
        }

        # the same three jobs again, under the profiler: the card's busy share
        out["profile_jobs"] = profile_decode(lambda: run_jobs(), 1e3 * wall_all)
        if isinstance(out["profile_jobs"], dict):
            out["device_busy_share"] = out["profile_jobs"]["device_busy_share"]
        return out, {"log_mel": launches["log_mel"],
                     "cross_attn_int4": launches["cross_attention_int4_stacked"]}
    finally:
        if app is not None:
            app.shutdown()
        if server is not None:
            server.join(timeout=30)
        if svc is not None:
            svc.engine.shutdown(wait=True)
        WSGIRequestHandler.log_message = log_request
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


INGEST_WAV_S = 600.0  # a 10 min 44.1 kHz stereo 16-bit WAV
INGEST_M4A_S = 240.0  # a 4 min speech-like .m4a
INGEST_JOB_S = 120.0  # a 2 min meeting .m4a through the 9 stages
INGEST_REPS = 3
INGEST_WAV_GATE = 2e-7


def host_cpu() -> str:
    """The host CPU as /proc/cpuinfo names it, and its cores (ingest is
    host work)."""
    keys = ("model name", "vendor_id", "cpu family", "model", "cpu MHz")
    seen: dict = {}
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                k, _, v = ln.partition(":")
                if k.strip() in keys:
                    seen.setdefault(k.strip(), v.strip())
    except OSError:
        pass
    named = "; ".join(f"{k} {seen[k]}" for k in keys if k in seen) or "not named"
    return f"{named}; {os.cpu_count()} cores"


def host_ms(fn, reps: int = INGEST_REPS):
    """(median wall ms of ``reps`` calls, the last call's result)."""
    import statistics

    walls, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        walls.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(walls), out


def twin_gates(ref: np.ndarray, got: np.ndarray) -> dict:
    """The JAX media test's criteria for a lossy decode against its WAV
    twin (``tests/test_native_media.py``): length within 60 ms, the same
    spectral peak within 2 bins, the twin's two strongest bins above a
    tenth of the decode's peak, RMS within 15 %."""
    def spectrum(y, n=32768, skip=4000):
        return np.abs(np.fft.rfft(y[skip: skip + n] * np.hanning(n)))

    fr, fg = spectrum(ref), spectrum(got)
    top = np.argsort(fr)[-2:]
    rms_r, rms_g = float(np.sqrt(np.mean(ref ** 2))), float(np.sqrt(np.mean(got ** 2)))
    return {
        "length": abs(len(got) - len(ref)) < 0.06 * 16_000,
        "peak": abs(int(np.argmax(fr)) - int(np.argmax(fg))) <= 2,
        "bins_survive": all(fg[max(b - 4, 0): b + 5].max() > 0.1 * fg.max() for b in top),
        "rms": abs(rms_g - rms_r) <= 0.15 * rms_r,
    }


def phase_ingest(dev, tr, counters) -> tuple[list[dict], dict]:
    """The port's native ingest on the card machine's host.  (a) WAV: the
    C++ decoder builds with g++ (a failure fails the run), then a seeded
    10 min 44.1 kHz stereo 16-bit WAV decodes through ``ingest.load_audio``
    (the native path, checked by a count of its calls) and through the
    Python reader + ``resample_host`` on the CPU, gated at 2e-7 and timed,
    with each C entry point timed alone.  (b) Media: where the compiler
    finds no libav headers, one line says so and the phase goes on; where
    it finds them, a failed build fails the run, and a 4 min .m4a made by
    ``encode_m4a`` is gated against its WAV twin, its decode timed, the
    ``transcribe`` cell run from its path (tokens equal to the call on the
    decoded array) and a 2 min meeting .m4a run through the 9 stages at
    96 tokens with fake integrations, kernels A and B counted in both.
    Returns (lines, launches by run)."""
    import ctypes
    import shutil

    from audio_processor_tpu_torch.native import audio_io, media
    from audio_processor_tpu_torch.ops import frontend
    from audio_processor_tpu_torch.pipeline import ingest
    from audio_processor_tpu_torch.utils import wavio

    status = audio_io.build_status()
    if not status["built"]:
        fail(f"ingest: the native audio library did not build: {status['why']}")
    lib = audio_io._load()
    out: dict = {"phase": "ingest", "host_cpu": host_cpu(), "library": status["library"],
                 "wav": {"audio_s": INGEST_WAV_S, "rate": 44_100, "channels": 2, "bits": 16}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ingest_")
    try:
        sr = 44_100
        wav = os.path.join(tmp, "REC_20260617_093000.wav")
        # the right channel: the left 10 ms later, softer, with noise of its own
        left = speech_like(INGEST_WAV_S, 40, sr)
        right = 0.8 * np.roll(left, sr // 100) + np.random.default_rng(41).normal(
            0, 0.01, len(left)).astype(np.float32)
        wavio.write_wav(wav, np.stack([left, right], axis=1), sr)
        minutes = INGEST_WAV_S / 60.0
        calls = []
        decode = audio_io.decode
        audio_io.decode = lambda *a: calls.append(a) or decode(*a)
        try:
            native_ms, native = host_ms(lambda: ingest.load_audio(wav))
        finally:
            audio_io.decode = decode
        if len(calls) != INGEST_REPS:
            fail(f"ingest: load_audio took the native decoder {len(calls)} of {INGEST_REPS} times")

        def plain():
            samples, rate = wavio.read_wav_mono(wav)
            return frontend.resample_host(samples, rate, 16_000)

        plain_ms, ref = host_ms(plain)
        err = float(np.abs(native - ref).max()) if native.shape == ref.shape else math.inf
        if not err <= INGEST_WAV_GATE:
            fail(f"ingest: native WAV decode vs reader + resample_host: shapes {native.shape} "
                 f"{ref.shape}, max |diff| {err} > {INGEST_WAV_GATE}")
        with open(wav, "rb") as f:
            data = f.read()
        n = lib.aptpu_wav_out_size(data, len(data), 16_000)
        buf = np.empty(n, np.float32)
        ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        rate, channels, bits = ctypes.c_int64(), ctypes.c_int(), ctypes.c_int()
        entry = {
            "aptpu_wav_info": host_ms(lambda: lib.aptpu_wav_info(
                data, len(data), ctypes.byref(rate), ctypes.byref(channels),
                ctypes.byref(bits)))[0],
            "aptpu_wav_out_size": host_ms(lambda: lib.aptpu_wav_out_size(data, len(data),
                                                                         16_000))[0],
            "aptpu_decode_wav": host_ms(lambda: lib.aptpu_decode_wav(data, len(data), 16_000,
                                                                     ptr, n))[0],
        }
        mono_ms, (mono, _) = host_ms(lambda: wavio.read_wav_mono(wav))
        # the C entry alone, into a buffer of the size it returned; the
        # binding calls it twice (a size query that resamples, then the fill)
        binding_ms, rs = host_ms(lambda: audio_io.resample(mono, sr, 16_000))
        rs_ptr = rs.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        mono_ptr = mono.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        entry["aptpu_resample"], _ = host_ms(lambda: lib.aptpu_resample(
            mono_ptr, len(mono), sr, 16_000, rs_ptr, len(rs)))
        resample_host_ms, _ = host_ms(lambda: frontend.resample_host(mono, sr, 16_000))
        np.testing.assert_array_equal(buf, native)
        out["wav"].update({
            "load_audio_native_ms": native_ms, "reader_plus_resample_host_ms": plain_ms,
            "max_abs_err": err, "gate": INGEST_WAV_GATE, "samples_out": int(len(native)),
            "entry_ms": entry, "python_reader_ms": mono_ms, "resample_binding_ms": binding_ms,
            "resample_host_ms": resample_host_ms,
            "ms_per_audio_min": {
                **{k: v / minutes for k, v in entry.items()},
                "load_audio_native": native_ms / minutes,
                "reader_plus_resample_host": plain_ms / minutes,
                "python_reader": mono_ms / minutes, "resample_binding": binding_ms / minutes,
                "resample_host": resample_host_ms / minutes},
        })

        mstat = media.build_status()
        lines = [out]
        launches: dict = {}
        if not mstat["headers"]:
            lines.append({"phase": "media", "built": False, "why": mstat["why"]})
            return lines, launches
        if not mstat["built"]:
            fail(f"ingest: the libav headers are present ({mstat['headers_at']}) but the media "
                 f"library failed: {mstat['why']}")
        media_line, launches = phase_ingest_media(dev, tr, counters, tmp, mstat)
        lines.append(media_line)
        return lines, launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_ingest_media(dev, tr, counters, tmp: str, mstat: dict) -> tuple[dict, dict]:
    """The media half of ``phase_ingest``, where the library built."""
    from audio_processor_tpu_torch.integrations.gemini import GeminiClient
    from audio_processor_tpu_torch.integrations.notion import NotionClient
    from audio_processor_tpu_torch.native import audio_io, media
    from audio_processor_tpu_torch.pipeline import ingest
    from audio_processor_tpu_torch.pipeline.diarize import Diarizer
    from audio_processor_tpu_torch.pipeline.meeting import MeetingProcessor, build_failure_result
    from audio_processor_tpu_torch.runtime.job_engine import JobEngine
    from audio_processor_tpu_torch.utils import wavio

    sr = 44_100
    minutes = INGEST_M4A_S / 60.0
    out: dict = {"phase": "media", "built": True, "headers_at": mstat["headers_at"],
                 "library": mstat["library"], "m4a": {"audio_s": INGEST_M4A_S, "rate": sr}}
    speech = speech_like(INGEST_M4A_S, 42, sr)
    twin = os.path.join(tmp, "twin.wav")
    wavio.write_wav(twin, speech, sr)
    m4a = os.path.join(tmp, "REC_20260618_100000.m4a")
    encode_ms, _ = host_ms(lambda: media.encode_m4a(speech, sr, m4a), reps=1)
    decode_ms, got = host_ms(lambda: media.decode(m4a)[0])
    prefix_ms, _ = host_ms(lambda: media.decode(m4a, max_samples=30 * 16_000)[0])
    info_ms, info = host_ms(lambda: media.media_info(m4a))
    gates = twin_gates(ingest.load_audio(twin), got)
    if not all(gates.values()) or info["codec"] != "aac":
        fail(f"ingest: the .m4a decode fails its WAV twin's gates: {gates} {info}")
    out["m4a"].update({
        "entry_ms": {"aptpu_encode_m4a": encode_ms, "aptpu_decode_media": decode_ms,
                     "aptpu_decode_media_prefix_30s": prefix_ms, "aptpu_media_info": info_ms},
        "ms_per_audio_min": {"aptpu_encode_m4a": encode_ms / minutes,
                             "aptpu_decode_media": decode_ms / minutes,
                             "aptpu_decode_media_prefix": prefix_ms / 0.5},
        "twin_gates": gates, "info": info,
    })

    # the transcribe cell from the .m4a's path, tokens held to the array's
    run = tr._run_decode
    seen = record_decodes(tr)
    try:
        torch.cuda.synchronize()
        zero_counts(counters)
        t0 = time.perf_counter()
        from_path = tr.transcribe(m4a)
        torch.cuda.synchronize()
        path_s = time.perf_counter() - t0
        launches = {"transcribe": read_counts(counters, (), "ingest m4a transcribe")}
        path_tokens = list(seen)
        seen.clear()
        tr.transcribe(got)
        array_tokens = list(seen)
    finally:
        tr._run_decode = run
    check_segments(from_path, len(got) / 16_000, "ingest m4a transcribe")
    equal = bool(path_tokens) and len(path_tokens) == len(array_tokens) and all(
        np.array_equal(a, b) for a, b in zip(path_tokens, array_tokens))
    if not equal:
        fail("ingest: transcribe(.m4a path) decoded other tokens than transcribe(array)")
    out["transcribe"] = {"model": f"{tr.cfg.name} (random weights)", "wall_s": path_s,
                         "rtf_x": from_path["rtf_x"], "decodes": len(path_tokens),
                         "tokens_equal_array_call": True, "launches": launches["transcribe"]}

    # one 2 min meeting .m4a through the 9 stages
    rng = np.random.default_rng(SERVE_JOB_SEEDS[0])
    f0s = (float(rng.uniform(95, 120)), float(rng.uniform(150, 185)),
           float(rng.uniform(220, 270)), float(rng.uniform(320, 378)))
    meeting, _ = make_meeting(rng, f0s, INGEST_JOB_S)
    job_m4a = os.path.join(tmp, "REC_20260619_140000.m4a")
    media.encode_m4a(audio_io.resample(meeting, 16_000, sr), sr, job_m4a)
    prompts, notion_calls = [], []
    proc = MeetingProcessor(
        transcriber=dataclasses.replace(tr, max_new_tokens=MESH_PATH_TOKENS,
                                        tokenizer=LetterTokenizer()),
        diarizer=Diarizer.bundled(device=dev),
        gemini=GeminiClient(api_key="k", http=fake_gemini_http(prompts)),
        notion=NotionClient(token="t", database_id="db", http=fake_notion_http(notion_calls),
                            batch_pause_s=0),
    )
    engine = JobEngine(max_workers=1)
    try:
        torch.cuda.synchronize()
        zero_counts(counters)
        t0 = time.perf_counter()
        engine.create_job("m4a", file_id=job_m4a)
        engine.submit("m4a", lambda ctx: proc.process(ctx, job_m4a),
                      failure_result=build_failure_result)
        while True:
            st = engine.get_job_status("m4a")
            if st["status"] in ("completed", "failed", "cancelled"):
                break
            if time.perf_counter() - t0 > 600:
                fail("ingest: the .m4a job still runs after 600 s")
            time.sleep(0.05)
        torch.cuda.synchronize()
        job_s = time.perf_counter() - t0
        launches["job"] = read_counts(counters, (), "ingest m4a job")
        stages = engine.store.get("m4a").get("stage_timings") or {}
    finally:
        engine.shutdown(wait=True)
    res = st.get("result") or {}
    if not (st["status"] == "completed" and res.get("success")
            and res.get("diarizer") == "bundled-synthetic"
            and res.get("notion_page_id") == "page-7" and set(stages) == set(SERVE_STAGES)):
        fail(f"ingest: the .m4a job ended {st['status']}: {st.get('error')} {sorted(stages)}")
    out["job"] = {"audio_s": INGEST_JOB_S, "max_new_tokens": MESH_PATH_TOKENS, "wall_s": job_s,
                  "decode_stage_s": stages["Decoding audio..."],
                  "stage_s": stages, "segments": len(res["segments"]),
                  "drive_filename": res.get("drive_filename"), "launches": launches["job"]}
    return out, launches


# config 2 of the JAX benchmarks (``benchmarks/run_configs.py:78-187``):
# resample + silence trim + log-mel on 10 min of 44.1 kHz mono, host chain
# against device chain
DF_AUDIO_S = 600.0
DF_SR = 44_100
DF_REPS = 3
DF_MASK_GATE_DB = 0.01  # a keep flag may differ card vs CPU only this near the cut
DF_MEL_GATE = 1e-4
DF_STAGES = ("upload", "resample", "mask", "mask_to_host", "intervals", "gather", "log_mel")


def config2_signal() -> np.ndarray:
    """Config 2's own signal (``run_configs.py:100-105``, seed 0): a 160 Hz
    tone gated at 0.9 Hz, amplitude 0.3, over a noise floor of 0.01 (27 dB
    under the peak, so the -40 dB cut keeps every frame)."""
    rng = np.random.default_rng(0)
    tt = np.arange(int(DF_AUDIO_S * DF_SR)) / DF_SR
    return (np.sin(2 * np.pi * 160 * tt) * (np.sin(2 * np.pi * 0.9 * tt) > -0.4) * 0.3
            + rng.normal(0, 0.01, len(tt))).astype(np.float32)


def paused_recording(seed: int = 51) -> np.ndarray:
    """10 min at 44.1 kHz: ``speech_like`` bursts of 2-8 s between pauses of
    0.5-4 s at a Gaussian floor of 1e-4; a pause longer than 1.5 s (the
    1 s minimum gap and 0.25 s of padding each side) is cut.  Seed 51 keeps
    56 intervals, so the table padded to K = 64 ends in 8 empty ones."""
    rng = np.random.default_rng(seed)
    n = int(DF_AUDIO_S * DF_SR)
    out = rng.normal(0, 1e-4, n).astype(np.float32)
    pos, k = int(rng.uniform(0.5, 4.0) * DF_SR), 0
    while pos < n:
        burst = speech_like(rng.uniform(2.0, 8.0), seed * 1000 + k, DF_SR)[: n - pos]
        out[pos: pos + len(burst)] += burst
        pos += len(burst) + int(rng.uniform(0.5, 4.0) * DF_SR)
        k += 1
    return out


def pow2_windows(n_samples: int) -> int:
    """Config 2's bucket: 30 s windows, rounded up to a power of two."""
    from audio_processor_tpu_torch.ops import frontend

    return 1 << max(0, -(-n_samples // frontend.N_SAMPLES) - 1).bit_length()


def host_frontend(audio44: np.ndarray, dev) -> dict:
    """Config 2's ``preprocess`` (``run_configs.py:122-139``) on the port:
    the native resampler and ``trim_silence_host`` on the host, int16
    windows in a power-of-two bucket to the card, kernel A; synced on the
    mel's sum."""
    from audio_processor_tpu_torch.native import audio_io
    from audio_processor_tpu_torch.ops import frontend
    from audio_processor_tpu_torch.ops.kernels.log_mel import log_mel

    trimmed, _ = frontend.trim_silence_host(audio_io.resample(audio44, DF_SR, 16_000))
    b = pow2_windows(len(trimmed))
    chunks = np.zeros((b, frontend.N_SAMPLES), np.float32)
    chunks.reshape(-1)[: len(trimmed)] = trimmed
    ci16 = np.clip(chunks * 32767.0, -32768, 32767).astype(np.int16)
    windows = torch.from_numpy(ci16).to(dev).to(torch.float32) / 32768.0
    return {"sum": float(log_mel(windows).sum()), "n_kept": len(trimmed), "b": b}


def device_frontend(audio44_i16: np.ndarray, dev) -> dict:
    """Config 2's ``preprocess_device`` (``run_configs.py:154-172``) on the
    port: the raw int16 to the card, resample and keep mask there, the mask
    to the host for ``mask_to_intervals``, the padded int32 table back,
    ``gather_kept_intervals`` into the bucket's windows, kernel A; synced
    on the mel's sum, as the host chain is (config 2's JAX variant pulls
    the whole mel back instead).  Each stage ends at a CUDA event."""
    from audio_processor_tpu_torch.ops import frontend
    from audio_processor_tpu_torch.ops.kernels.log_mel import log_mel

    events = []

    def mark():
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()

    t0 = time.perf_counter()
    mark()
    x = torch.from_numpy(audio44_i16).to(dev).to(torch.float32) / 32768.0
    mark()
    a = frontend.resample(x, DF_SR, 16_000)
    mark()
    mask = frontend.silence_mask(a)
    mark()
    mask_np = mask.cpu().numpy()
    mark()
    n16 = int(a.shape[-1])
    bounds = frontend.mask_to_intervals(mask_np, n16, min_gap_frames=100) or [(0, n16)]
    lens = np.array([e - s for s, e in bounds], np.int64)
    n_kept = int(lens.sum())
    b = pow2_windows(n_kept)
    k_pad = 1 << max(0, len(bounds) - 1).bit_length()
    starts = np.full(k_pad, bounds[-1][0], np.int32)
    cum = np.full(k_pad, n_kept, np.int32)
    starts[: len(bounds)] = [s for s, _ in bounds]
    cum[: len(bounds)] = np.cumsum(lens)
    mark()
    windows = frontend.gather_kept_intervals(
        a, torch.from_numpy(starts).to(dev), torch.from_numpy(cum).to(dev),
        b * frontend.N_SAMPLES).reshape(b, frontend.N_SAMPLES)
    mark()
    mel_sum = log_mel(windows).sum()
    mark()
    out = {"sum": float(mel_sum), "wall_s": time.perf_counter() - t0}
    out["stages_ms"] = {name: e0.elapsed_time(e1)
                        for name, e0, e1 in zip(DF_STAGES, events, events[1:])}
    out.update(a=a, mask=mask, bounds=bounds, n_kept=n_kept, b=b, k_pad=k_pad, windows=windows)
    return out


def log_mel_f64(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """The plain log-mel's steps (``frontend.log_mel_spectrogram``) in
    float64, on audio's device: gate 3's reference.  On config 2's 160 Hz
    tone the float32 plain version's 400-term DFT sums cancel at the lowest
    mel bin and land further from this than kernel A's four-step FFT does,
    so the float32 plain version is printed beside it, not gated."""
    import torch.nn.functional as F

    from audio_processor_tpu_torch.ops import frontend

    x = audio.to(torch.float64)
    n_frames = x.shape[-1] // frontend.HOP_LENGTH
    half = frontend.N_FFT // 2
    frames = F.pad(x[:, None], (half, half), mode="reflect")[:, 0].unfold(
        -1, frontend.N_FFT, frontend.HOP_LENGTH)[:, :n_frames]
    window = torch.hann_window(frontend.N_FFT, periodic=True, dtype=torch.float64,
                               device=x.device)
    power = torch.fft.rfft(frames * window).abs().square()
    filters = torch.from_numpy(frontend.mel_filterbank(n_mels)).to(x.device, torch.float64)
    log_spec = torch.log10(torch.clamp(power @ filters.T, min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(-2, -1), keepdim=True) - 8.0)
    return ((log_spec + 4.0) / 4.0).transpose(-1, -2)


def frame_db64(a: np.ndarray) -> np.ndarray:
    """Each ``silence_mask`` frame's level in dB, in float64."""
    from audio_processor_tpu_torch.ops import frontend

    x = torch.from_numpy(np.pad(a.astype(np.float64), (200, 200)))
    frames = frontend.frame_signal(x, max(len(a) // frontend.HOP_LENGTH, 1))
    return (20.0 * torch.log10(torch.sqrt((frames * frames).mean(-1) + 1e-12) + 1e-12)).numpy()


def device_frontend_gates(res: dict, name: str) -> dict:
    """Gates 1-3 of the device chain on one run's outputs: (1) the card's
    keep mask equals ``silence_mask`` on the CPU on the same resampled
    audio, save frames within 0.01 dB of the cut in float64 (and dilated
    flags within pad_frames of such a frame); (2) the gathered windows are
    bit-equal to a numpy concatenation of the kept intervals, zero past
    them; (3) kernel A on them is within 1e-4 of the plain log-mel's steps
    in float64 (``log_mel_f64``)."""
    from audio_processor_tpu_torch.ops import frontend
    from audio_processor_tpu_torch.ops.kernels.log_mel import log_mel

    a_np = res["a"].cpu().numpy()
    a_cpu = torch.from_numpy(a_np)
    raw_card = frontend.silence_mask(res["a"], pad_frames=0).cpu().numpy()
    raw_cpu = frontend.silence_mask(a_cpu, pad_frames=0).numpy()
    db = frame_db64(a_np)
    margin = np.abs(db - (db.max() - 40.0))
    raw_diff = np.flatnonzero(raw_card != raw_cpu)
    if not (margin[raw_diff] <= DF_MASK_GATE_DB).all():
        fail(f"device_frontend {name}: {len(raw_diff)} raw keep flags differ card vs CPU, "
             f"margins {margin[raw_diff][:10].tolist()} dB from the cut > {DF_MASK_GATE_DB}")
    dil_diff = np.flatnonzero(res["mask"].cpu().numpy() != frontend.silence_mask(a_cpu).numpy())
    if len(dil_diff) and (not len(raw_diff) or (np.abs(dil_diff[:, None] - raw_diff[None, :])
                                                .min(axis=1) > 25).any()):
        fail(f"device_frontend {name}: {len(dil_diff)} keep flags differ card vs CPU away "
             f"from the {len(raw_diff)} frames at the cut")
    kept = np.concatenate([a_np[s:e] for s, e in res["bounds"]])
    flat = res["windows"].reshape(-1).cpu().numpy()
    if not (np.array_equal(flat[: len(kept)], kept) and not flat[len(kept):].any()):
        fail(f"device_frontend {name}: the gather is not the host concatenation")
    got = log_mel(res["windows"])
    torch.cuda.synchronize()
    exact = log_mel_f64(res["windows"])
    plain = frontend.log_mel_spectrogram(res["windows"])
    err = (got - exact).abs().max().item()
    if not err <= DF_MEL_GATE:
        fail(f"device_frontend {name}: kernel A vs the float64 plain log-mel {err} > {DF_MEL_GATE}")
    plain_err = (plain - exact).abs().max().item()
    vs_plain = (got - plain).abs().max().item()
    del exact, plain
    # printed, not gated: the host trim's intervals on the same 16 kHz audio
    _, seconds = frontend.trim_silence_host(a_np)
    host = [(round(s * 16_000), round(e * 16_000)) for s, e in seconds]
    shift = (max(abs(p - q) for hb, db_ in zip(host, res["bounds"]) for p, q in zip(hb, db_))
             / frontend.HOP_LENGTH if len(host) == len(res["bounds"]) else None)
    return {"mask_flags_differing": int(len(raw_diff)), "mask_flags_differing_dilated":
            int(len(dil_diff)), "mask_gate_db": DF_MASK_GATE_DB, "gather_bit_equal": True,
            "log_mel_max_abs_err_vs_f64": err, "log_mel_gate": DF_MEL_GATE,
            "plain_f32_max_abs_err_vs_f64": plain_err, "log_mel_max_abs_err_vs_plain_f32": vs_plain,
            "intervals_equal_host_trim": host == res["bounds"],
            "host_trim_intervals": len(host), "max_boundary_shift_frames": shift}


def phase_device_frontend(dev, card: str) -> tuple[list[dict], dict]:
    """Config 2 on the port at its full size, both chains on two signals:
    config 2's own and ``paused_recording``, whose pauses reach the cut.
    Each chain is timed as a median of 3 runs after a warm run (RTFx =
    600 s over it); the device chain's stages by CUDA events; kernel A's
    launches counted on each chain apart; gates 1-3 on the device chain's
    last run (``device_frontend_gates``), gate 4: kernel A launched on it.
    Returns (a line a signal, launches by chain)."""
    import statistics

    from audio_processor_tpu_torch.ops.kernels.log_mel import log_mel

    lines, launches = [], {"device_frontend": 0, "host_frontend": 0}
    for name, make in (("config2", config2_signal), ("paused", paused_recording)):
        t_signal = time.perf_counter()
        audio44 = make()
        audio44_i16 = np.clip(audio44 * 32767.0, -32768, 32767).astype(np.int16)
        out = {"phase": "device_frontend", "signal": name, "card": card, "audio_s": DF_AUDIO_S,
               "rate": DF_SR, "sync": "scalar (the mel's sum) on both chains"}
        chains = {}
        for chain, fn, arg in (("host", host_frontend, audio44), ("device", device_frontend,
                                                                     audio44_i16)):
            zero_counts([log_mel])
            fn(arg, dev)  # warm
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated() / 1e9  # by earlier phases, not the chain
            walls, runs = [], []
            for _ in range(DF_REPS):
                t0 = time.perf_counter()
                res = fn(arg, dev)
                walls.append(time.perf_counter() - t0)
                runs.append(res)
            peak = torch.cuda.max_memory_allocated() / 1e9
            n = read_counts([log_mel], (), f"device_frontend {name} {chain}")["log_mel"]
            launches[f"{chain}_frontend"] += n
            med = statistics.median(walls)
            chains[chain] = {"rtfx": DF_AUDIO_S / med, "median_s": med, "walls_s": walls,
                             "peak_gb": peak, "held_at_start_gb": held,
                             "peak_over_start_gb": peak - held, "windows": res["b"],
                             "kept_share": res["n_kept"] / (DF_AUDIO_S * 16_000),
                             "log_mel_launches": n}
            if chain == "device":
                chains[chain].update(
                    intervals=len(res["bounds"]), k_pad=res["k_pad"],
                    stages_ms={k: statistics.median(r["stages_ms"][k] for r in runs)
                               for k in DF_STAGES})
            del runs
        out.update(chains)
        out["gates"] = device_frontend_gates(res, name)
        del res
        out["seconds"] = time.perf_counter() - t_signal
        lines.append(out)
        torch.cuda.empty_cache()
    return lines, launches


DIARIZE_MEETING_S = 1800.0
DIARIZE_SLAB = 128  # the Diarizer's max_batch


def phase_diarize(dev, kernels) -> dict:
    """Diarization on the card: kernel A at the two segmentation windows;
    the bundled Diarizer against the port's CPU path in float32; the JAX
    suite's quality gates at the bundled default (bf16 convs); fusion of
    card and CPU turns; then a 30 min 4-speaker meeting through
    ``Diarizer.bundled()`` at its defaults (stage walls, kernel A's
    launches, peak memory, busy share, DER printed) and through the
    configs' published widths with random weights and onset 0 (every
    (window, speaker) pair a crop: the embedding stage's most work)."""
    from audio_processor_tpu_torch.models.diarization import embedding as emb_lib
    from audio_processor_tpu_torch.ops import frontend
    from audio_processor_tpu_torch.ops.kernels.log_mel import log_mel
    from audio_processor_tpu_torch.pipeline.diarize import Diarizer
    from audio_processor_tpu_torch.pipeline.fuse import fuse_segments
    from audio_processor_tpu_torch.utils.metrics import (
        diarization_error_rate,
        diarization_error_rate_detailed,
    )

    slab, meeting_s = DIARIZE_SLAB, DIARIZE_MEETING_S
    out: dict = {"phase": "diarize"}
    # kernel A at the windows it sees here: 10 s (the published config) and
    # 6 s (the bundled checkpoint), a slab of 128 with a zero-padded (silent)
    # row and quiet rows
    g = torch.Generator(device=dev).manual_seed(8)
    for label, n in (("10s", 160_000), ("6s", 96_000)):
        audio = torch.randn(slab, n, device=dev, generator=g) * 0.2
        audio[::9] *= 1e-3
        audio[-1] = 0.0
        got = log_mel(audio, 80)
        torch.cuda.synchronize()
        ref = frontend.log_mel_spectrogram(audio, 80)
        err = (got - ref).abs().max().item()
        if not (got.shape == ref.shape == (slab, 80, n // 160) and err <= 1e-4):
            fail(f"diarize: log_mel at ({slab}, {n}): max abs err {err} > 1e-4 or bad shape")
        bms, by, _, _ = log_mel_bounds(slab, n)
        out[f"log_mel_{label}"] = {
            "shape": [slab, n], "max_abs_err": err, "ms": time_ms(lambda: log_mel(audio, 80), 20),
            "plain_ms": time_ms(lambda: frontend.log_mel_spectrogram(audio, 80), 3),
            "library_ms": time_ms(lambda: library_log_mel(audio), 5),
            "bound_ms": bms, "bound_by": by,
        }
        del audio, got, ref
    torch.cuda.empty_cache()

    # the card against the CPU: bundled weights, float32 convs, the JAX
    # suite's first held-out 20 s 3-speaker meeting (rng 13579, 2 s step)
    rng = np.random.default_rng(13579)
    meetings = []
    for _ in range(2):
        f0s = (float(rng.uniform(95, 120)), float(rng.uniform(190, 240)),
               float(rng.uniform(320, 378)))
        meetings.append(make_meeting(rng, f0s, 20.0))
    res = {}
    for where in ("cpu", dev):
        d = Diarizer.bundled(window_step_s=2.0, device=where)
        seen: dict = {}

        def embed_f32(crops, d=d, seen=seen):
            seen["crops"] = crops
            seen["emb"] = d._batched(crops, lambda x: emb_lib.embed_crops(
                d.emb_params, d.emb_cfg, x, compute_dtype=torch.float32))
            return seen["emb"]

        d._embed_all = embed_f32
        turns = d.diarize(meetings[0][0])
        res[where] = (d, turns, d._segment_all(d._windows(meetings[0][0])[0]), seen)
    d_cpu, cpu_turns, cpu_probs, _ = res["cpu"]
    d_card, card_turns, card_probs, card_seen = res[dev]
    if {p.device for net in (d_card.seg_params, d_card.emb_params) for p in net.parameters()} != {dev}:
        fail("diarize: the card's Diarizer holds its nets off the card")
    seg_err = float(np.abs(card_probs - cpu_probs).max())
    emb_cpu = d_cpu._embed_all(card_seen["crops"])  # the card's crops, embedded on the CPU
    cos = float((emb_cpu * card_seen["emb"]).sum(axis=1).min())
    if not (seg_err <= 1e-4 and cos >= 0.9999 and card_turns == cpu_turns and card_turns):
        fail(f"diarize: card vs CPU (f32): segmentation max abs err {seg_err}, embedding "
             f"min cosine {cos}, turns equal {card_turns == cpu_turns} ({len(card_turns)} turns)")
    rows = [{"start": float(t), "end": float(t) + 1.7, "text": f"row {i}"}
            for i, t in enumerate(np.arange(0.0, 20.0, 1.3))]
    fused_equal = fuse_segments(rows, card_turns, 0.5) == fuse_segments(rows, cpu_turns, 0.5)
    if not fused_equal:
        fail("diarize: fuse_segments on the card's turns differs from the CPU's")
    out["vs_cpu_f32"] = {"segmentation_max_abs_err": seg_err, "embedding_min_cosine": cos,
                         "turns_equal": True, "turns": len(card_turns),
                         "crops": len(card_seen["crops"]), "fused_equal": fused_equal}
    del res, d_cpu, d_card

    # quality on the card at the bundled default (bf16 convs): the JAX suite's gates
    d = Diarizer.bundled(window_step_s=2.0, device=dev)
    ders = [diarization_error_rate(ref, d.diarize(a), collar_s=0.25) for a, ref in meetings]
    rng = np.random.default_rng(24680)
    f0s = tuple(float(f) for f in np.exp(np.linspace(np.log(100), np.log(360), 5)))
    a5, ref5 = make_meeting(rng, f0s, 60.0)
    det = diarization_error_rate_detailed(ref5, d.diarize(a5), collar_s=0.25)
    out["quality_bf16"] = {"der_20s": ders, "der_60s_5spk": det}
    if not (min(ders) <= 0.30 and det["der"] <= 0.45
            and abs(det["hyp_speakers"] - det["ref_speakers"]) <= 1):
        fail(f"diarize: quality gates: 20 s DERs {ders} (min must be <= 0.30), 60 s {det}")

    # the realistic run: 30 min, 4 speakers, Diarizer.bundled() at its defaults
    rng = np.random.default_rng(4)
    t0 = time.perf_counter()
    f0s = (float(rng.uniform(95, 120)), float(rng.uniform(150, 185)),
           float(rng.uniform(220, 270)), float(rng.uniform(320, 378)))
    audio, ref = make_meeting(rng, f0s, meeting_s)
    out["meeting"] = {"audio_s": meeting_s, "speakers": 4, "f0s": f0s,
                      "synthesis_s": time.perf_counter() - t0}
    for name, make in (
        ("bundled", lambda: Diarizer.bundled(device=dev)),
        ("published_widths_random_onset0",
         lambda: Diarizer.random_init(segmentation="tpu", device=dev, onset=0.0)),
    ):
        d = make()
        cold, cold_st = timed_diarize(d, audio)
        torch.cuda.reset_peak_memory_stats()
        zero_counts([log_mel])
        warm, st = timed_diarize(d, audio)
        launches = read_counts([log_mel], (), f"diarize {name}")
        entry = {
            "window_s": d.seg_cfg.window_s, "window_step_s": d.window_step_s,
            "seg": f"d={d.seg_cfg.d_model} heads={d.seg_cfg.n_head} layers={d.seg_cfg.n_layer}",
            "emb": f"base={d.emb_cfg.base_channels} blocks={list(d.emb_cfg.blocks)} "
                   f"dim={d.emb_cfg.embed_dim} crop_s={d.emb_cfg.crop_s}",
            "cold_s": cold_st["total_s"], "warm_rtf_x": meeting_s / st["total_s"],
            "stages": st, "slabs": launches["log_mel"], "launches": launches,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "turns": len(warm), "speakers": len({t["speaker"] for t in warm}),
            "warm_equals_cold": warm == cold,
        }
        for t in warm:
            if not (0.0 <= t["start"] <= t["end"] <= meeting_s + 1e-6):
                fail(f"diarize {name}: bad turn {t}")
        if name == "bundled":
            if not warm:
                fail("diarize bundled: no turns on the 30 min meeting")
            entry["der"] = diarization_error_rate_detailed(ref, warm, collar_s=0.25)
            entry["profile"] = profile_decode(lambda: d.diarize(audio), 1e3 * st["total_s"])
        out[name] = entry
        del d
        torch.cuda.empty_cache()

    k = kernels["log_mel"]
    k["max_abs_err"] = max(k["max_abs_err"], out["log_mel_10s"]["max_abs_err"],
                           out["log_mel_6s"]["max_abs_err"])
    k["launches_diarize"] = out["bundled"]["launches"]["log_mel"]
    k["launches_diarize_published_widths"] = out["published_widths_random_onset0"]["launches"]["log_mel"]
    for label in ("10s", "6s"):
        r = out[f"log_mel_{label}"]
        k.update({f"ms_{label}_b128": r["ms"], f"plain_ms_{label}_b128": r["plain_ms"],
                  f"library_ms_{label}_b128": r["library_ms"], f"bound_ms_{label}_b128": r["bound_ms"]})
    return out


# ---------------------------------------------------------------------------
# convert and train: checkpoint conversion and the three trainers
# ---------------------------------------------------------------------------

CONVERT_MODEL = "small"
CONVERT_HEADS = ((7, 3), (10, 5))  # two alignment heads carried by the HF directory
TRAIN_WAVS = 8


def perturbed_whisper_params(cfg, seed: int) -> dict:
    """Seeded random float32 params on the CPU, every leaf moved by a little
    noise so the biases and norm scales are off their 0/1 init and every
    leaf's bits are tested."""
    from audio_processor_tpu_torch.models.whisper import model
    from audio_processor_tpu_torch.training.train_step import tree_leaves

    g = torch.Generator().manual_seed(seed)
    params = model.init_params(cfg, g)
    for t in tree_leaves(params):
        t.add_(torch.randn(t.shape, generator=g) * 0.02)
    return params


def whisper_state_dict(params, cfg, style: str) -> dict:
    """The port's params under openai-whisper's names (style "openai") or
    HuggingFace's ("hf"), in torch's layouts: the inverse of the converters,
    written out here so the converters are held to an independent mapping."""
    hf = style == "hf"
    attn_names = ("q_proj", "k_proj", "v_proj", "out_proj") if hf else ("query", "key", "value", "out")
    sd: dict = {}

    def put(key, t):
        sd[("model." if hf else "") + key] = t.contiguous()

    def norm(key, p, i=None):
        put(f"{key}.weight", p["scale"] if i is None else p["scale"][i])
        put(f"{key}.bias", p["bias"] if i is None else p["bias"][i])

    def lin(key, p, i):
        put(f"{key}.weight", p["w"][i].T)
        if "b" in p:
            put(f"{key}.bias", p["b"][i])

    for side, n in (("encoder", cfg.n_audio_layer), ("decoder", cfg.n_text_layer)):
        blocks = params[side]["blocks"]
        parts = [("attn_ln", "self_attn_layer_norm", "attn_ln"), ("attn", "self_attn", "attn"),
                 ("mlp_ln", "final_layer_norm", "mlp_ln"), ("fc1", "fc1", "mlp.0"),
                 ("fc2", "fc2", "mlp.2")]
        if side == "decoder":
            parts += [("cross_attn_ln", "encoder_attn_layer_norm", "cross_attn_ln"),
                      ("cross_attn", "encoder_attn", "cross_attn")]
        for i in range(n):
            base = f"{side}.{'layers' if hf else 'blocks'}.{i}"
            for ours, hf_name, oa_name in parts:
                key, p = f"{base}.{hf_name if hf else oa_name}", blocks[ours]
                if ours.endswith("_ln"):
                    norm(key, p, i)
                elif ours.startswith("fc"):
                    lin(key, p, i)
                else:
                    for sub, name in zip(("q", "k", "v", "out"), attn_names):
                        lin(f"{key}.{name}", p[sub], i)
    enc, dec = params["encoder"], params["decoder"]
    for conv in ("conv1", "conv2"):
        put(f"encoder.{conv}.weight", enc[conv]["w"])
        put(f"encoder.{conv}.bias", enc[conv]["b"])
    if hf:
        put("encoder.embed_positions.weight", enc["pos_emb"])
        put("decoder.embed_tokens.weight", dec["token_emb"])
        put("decoder.embed_positions.weight", dec["pos_emb"])
        norm("encoder.layer_norm", enc["ln_post"])
        norm("decoder.layer_norm", dec["ln"])
    else:
        put("encoder.positional_embedding", enc["pos_emb"])
        put("decoder.token_embedding.weight", dec["token_emb"])
        put("decoder.positional_embedding", dec["pos_emb"])
        norm("encoder.ln_post", enc["ln_post"])
        norm("decoder.ln", dec["ln"])
    return sd


def write_safetensors(path: str, tensors: dict) -> None:
    """A float32 ``.safetensors`` file: 8-byte little-endian header length,
    the JSON header (dtype, shape, byte offsets), then the raw bytes."""
    import struct

    header, offset, blobs = {}, 0, []
    for name, t in tensors.items():
        blob = t.detach().cpu().float().contiguous().numpy().astype("<f4").tobytes()
        header[name] = {"dtype": "F32", "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        offset += len(blob)
        blobs.append(blob)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for blob in blobs:
            f.write(blob)


def write_hf_directory(d: str, params, cfg) -> None:
    """An HF Whisper checkpoint directory: config, generation config with
    two alignment heads, ``model.safetensors``, a byte-level vocab."""
    from audio_processor_tpu_torch.models.whisper.tokenizer import _bytes_to_unicode

    os.makedirs(d)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"num_mel_bins": cfg.n_mels, "max_source_positions": cfg.n_audio_ctx,
                   "d_model": cfg.n_audio_state, "encoder_attention_heads": cfg.n_audio_head,
                   "encoder_layers": cfg.n_audio_layer, "vocab_size": cfg.n_vocab,
                   "max_target_positions": cfg.n_text_ctx,
                   "decoder_attention_heads": cfg.n_text_head,
                   "decoder_layers": cfg.n_text_layer}, f)
    with open(os.path.join(d, "generation_config.json"), "w") as f:
        json.dump({"alignment_heads": [list(h) for h in CONVERT_HEADS]}, f)
    enc = _bytes_to_unicode()
    with open(os.path.join(d, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump({enc[b]: b for b in range(256)}, f, ensure_ascii=False)
    with open(os.path.join(d, "merges.txt"), "w") as f:
        f.write("#version: byte-level\n")
    write_safetensors(os.path.join(d, "model.safetensors"), whisper_state_dict(params, cfg, "hf"))


def pyannet_state_dict(net) -> dict:
    """The port's PyanNet under pyannote.audio's module names."""
    sd = {"sincnet.wav_norm1d.weight": net.wav_norm["scale"],
          "sincnet.wav_norm1d.bias": net.wav_norm["bias"],
          "sincnet.conv1d.0.low_hz_": net.sinc["low_hz"][:, None],
          "sincnet.conv1d.0.band_hz_": net.sinc["band_hz"][:, None]}
    for i in range(3):
        norm = getattr(net, f"norm{i}")
        sd[f"sincnet.norm1d.{i}.weight"], sd[f"sincnet.norm1d.{i}.bias"] = norm["scale"], norm["bias"]
    for i in (1, 2):
        conv = getattr(net, f"conv{i}")
        sd[f"sincnet.conv1d.{i}.weight"], sd[f"sincnet.conv1d.{i}.bias"] = conv.weight, conv.bias
    sd.update({f"lstm.{k}": v for k, v in net.lstm.state_dict().items()})
    for ours, theirs in (("linear1", "linear.0"), ("linear2", "linear.1"), ("classifier", "classifier")):
        lin = getattr(net, ours)
        sd[f"{theirs}.weight"], sd[f"{theirs}.bias"] = lin.weight, lin.bias
    return {k: v.detach().cpu().clone() for k, v in sd.items()}


def resnet_state_dict(net) -> dict:
    """The port's ResNet under torchvision's names, the embedding linear as
    WeSpeaker's ``seg_1``."""
    sd = {}

    def bn(key, p):
        for ours, theirs in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                             ("var", "running_var")):
            sd[f"{key}.{theirs}"] = p[ours]

    sd["conv1.weight"] = net.stem_conv
    bn("bn1", net.stem_bn)
    for si, stage in enumerate(net.stages, start=1):
        for bi, block in enumerate(stage):
            base = f"layer{si}.{bi}"
            sd[f"{base}.conv1.weight"], sd[f"{base}.conv2.weight"] = block.conv1, block.conv2
            bn(f"{base}.bn1", block.bn1)
            bn(f"{base}.bn2", block.bn2)
            if hasattr(block, "down_conv"):
                sd[f"{base}.downsample.0.weight"] = block.down_conv
                bn(f"{base}.downsample.1", block.down_bn)
    sd["seg_1.weight"], sd["seg_1.bias"] = net.fc["w"].T, net.fc["b"]
    return {k: v.detach().cpu().clone() for k, v in sd.items()}


def cli_run(argv: list[str]) -> str:
    """One port CLI subcommand in this process; its standard output."""
    import contextlib
    import io

    from audio_processor_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return buf.getvalue()


def leaves_equal(a, b) -> bool:
    from audio_processor_tpu_torch.training.train_step import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x.cpu(), y.cpu())
        for x, y in zip(la, lb))


def phase_convert(dev, counters, work: str) -> tuple[dict, str]:
    """Checkpoint conversion at whisper-small's published widths from seeded
    random params: an openai ``.pt`` and an HF directory (safetensors
    written above) through ``convert-whisper``; every leaf bit-equal to the
    source; the ``transcribe`` cell's 4 min from the converted ``.npz``,
    tokens equal to a Transcriber built on the source params (kernels A
    and B counted).  The diarizer: a PyanNet and a ResNet34 at the
    published widths (seeded) mapped to pyannote/torchvision state dicts,
    through ``convert-diarizer``; the 30 min meeting's turns from
    ``Diarizer.from_npz`` equal those of a Diarizer on the source nets (soft
    decode, onset 0: every (window, speaker) pair a crop; 4 speakers).  The
    bundled nets mapped back and converted give their own leaves.
    Returns (summary, the HF-converted .npz)."""
    from audio_processor_tpu_torch.models.diarization import convert as dconvert
    from audio_processor_tpu_torch.models.diarization import embedding as emb_lib
    from audio_processor_tpu_torch.models.diarization import segmentation as seg_lib
    from audio_processor_tpu_torch.models.diarization import segmentation_tpu as seg_tpu
    from audio_processor_tpu_torch.models.whisper import convert
    from audio_processor_tpu_torch.models.whisper.config import get_config
    from audio_processor_tpu_torch.models.whisper.tokenizer import BPETokenizer
    from audio_processor_tpu_torch.pipeline.diarize import Diarizer
    from audio_processor_tpu_torch.pipeline.transcribe import Transcriber

    out: dict = {"phase": "convert", "model": f"{CONVERT_MODEL} (seeded random weights)"}
    cfg = get_config(CONVERT_MODEL)
    t0 = time.perf_counter()
    src = perturbed_whisper_params(cfg, seed=11)
    pt, hf_dir = os.path.join(work, "small.pt"), os.path.join(work, "small-hf")
    dims = {k: getattr(cfg, k) for k in ("n_mels", "n_audio_ctx", "n_audio_state", "n_audio_head",
                                         "n_audio_layer", "n_vocab", "n_text_ctx", "n_text_state",
                                         "n_text_head", "n_text_layer")}
    torch.save({"dims": dims, "model_state_dict": whisper_state_dict(src, cfg, "openai")}, pt)
    write_hf_directory(hf_dir, src, cfg)
    out["write_s"] = time.perf_counter() - t0
    npz = {}
    for tag, path in (("openai", pt), ("hf", hf_dir)):
        npz[tag] = os.path.join(work, f"small-{tag}.npz")
        t0 = time.perf_counter()
        printed = cli_run(["convert-whisper", path, npz[tag]])
        took = time.perf_counter() - t0
        params, got = convert.load_params(npz[tag], "cpu")
        if not leaves_equal(params, src):
            fail(f"convert: convert-whisper from {tag}: a leaf differs from the source")
        heads = CONVERT_HEADS if tag == "hf" else None
        if got.alignment_heads != heads or (convert.load_tokenizer(npz[tag]) is None) == (tag == "hf"):
            fail(f"convert: {tag}: heads {got.alignment_heads} / tokenizer sidecars wrong")
        out[tag] = {"convert_s": took, "printed": printed.strip(), "leaves_bit_equal": True,
                    "npz_mb": os.path.getsize(npz[tag]) / 1e6}
        del params
    # the transcribe cell from the converted checkpoint, against the source params
    audio = speech_like(TP_AUDIO_S, 5)
    tok = BPETokenizer.from_vocab_files(os.path.join(hf_dir, "vocab.json"),
                                        os.path.join(hf_dir, "merges.txt"))
    direct = Transcriber(params=src, cfg=dataclasses.replace(cfg, alignment_heads=CONVERT_HEADS),
                         tokenizer=tok, device=dev, enable_fallback=False)
    seen_direct = record_decodes(direct)
    ref = direct.transcribe(audio)
    del direct
    tr = Transcriber.from_npz(npz["hf"], device=dev, enable_fallback=False)
    seen = record_decodes(tr)
    torch.cuda.synchronize()
    zero_counts(counters)
    t0 = time.perf_counter()
    got = tr.transcribe(audio)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(counters, (), "convert transcribe")
    check_segments(got, TP_AUDIO_S, "convert")
    tokens, ref_tokens = np.concatenate(seen), np.concatenate(seen_direct)
    def spans(res):
        return [(seg["start"], seg["end"], seg["text"]) for seg in res["segments"]]

    if not (np.array_equal(tokens, ref_tokens) and spans(got) == spans(ref)):
        fail("convert: the converted checkpoint's transcript differs from the source params'")
    out["transcribe"] = {"audio_s": TP_AUDIO_S, "tokens_equal": True, "segments": len(got["segments"]),
                         "decode_tokens": int(tokens.size), "wall_s": wall, "launches": launches}
    del tr
    torch.cuda.empty_cache()

    # the diarizer: published-width nets -> pyannote/torchvision state dicts -> the CLI
    g = torch.Generator().manual_seed(12)
    seg_cfg, emb_cfg = seg_lib.SegmentationConfig(), emb_lib.EmbeddingConfig()
    seg_net, emb_net = seg_lib.init_params(seg_cfg, g), emb_lib.init_params(emb_cfg, g)
    with torch.no_grad():  # biases and norms off their 0/1 init, as above
        for net in (seg_net, emb_net):
            for p in net.parameters():
                if p.ndim == 1:
                    p.add_(torch.randn(p.shape, generator=g) * 0.02)
    seg_pt, emb_pt = os.path.join(work, "seg.ckpt"), os.path.join(work, "emb.pt")
    torch.save({"state_dict": pyannet_state_dict(seg_net)}, seg_pt)
    torch.save(resnet_state_dict(emb_net), emb_pt)
    pack = os.path.join(work, "diarizer.npz")
    t0 = time.perf_counter()
    cli_run(["convert-diarizer", seg_pt, emb_pt, pack])
    took = time.perf_counter() - t0
    seg_tree, emb_tree = dconvert.load_diarizer_params(pack)
    if not (leaves_equal(seg_lib.params_from_jax(seg_tree, seg_cfg), seg_net)
            and leaves_equal(emb_lib.params_from_jax(emb_tree, emb_cfg), emb_net)):
        fail("convert: convert-diarizer: a leaf differs from the source nets")
    bundled = Diarizer.bundled(device="cpu")
    b_tree, _ = dconvert.from_resnet_state_dict(resnet_state_dict(bundled.emb_params),
                                                bundled.emb_cfg)
    bundled_equal = (leaves_equal(emb_lib.params_from_jax(b_tree, bundled.emb_cfg), bundled.emb_params)
                     and leaves_equal(seg_tpu.params_from_jax(seg_tpu.params_to_jax(
                         bundled.seg_params), bundled.seg_cfg), bundled.seg_params))
    if not bundled_equal:
        fail("convert: the bundled nets mapped back and converted differ from themselves")
    rng = np.random.default_rng(4)
    f0s = (float(rng.uniform(95, 120)), float(rng.uniform(150, 185)),
           float(rng.uniform(220, 270)), float(rng.uniform(320, 378)))
    meeting, _ = make_meeting(rng, f0s, DIARIZE_MEETING_S)
    # random nets: the soft decode at onset 0 makes every (window, speaker)
    # pair a crop, and 4 clusters are asked for (random embeddings all fall
    # in one), so the turns rest on every embedding and the clustering
    knobs = dict(hard_decode=False, onset=0.0, device=dev)
    direct = Diarizer(seg_params=seg_net, seg_cfg=seg_cfg, emb_params=emb_net, emb_cfg=emb_cfg,
                      **knobs)
    ref_turns = direct.diarize(meeting, num_speakers=4)
    del direct
    d = Diarizer.from_npz(pack, **knobs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    turns = d.diarize(meeting, num_speakers=4)
    torch.cuda.synchronize()
    if not turns or turns != ref_turns:
        fail(f"convert: the converted diarizer's turns ({len(turns)}) differ from the source "
             f"nets' ({len(ref_turns)})")
    out["diarizer"] = {"convert_s": took, "leaves_bit_equal": True,
                       "bundled_mapped_back_bit_equal": True, "audio_s": DIARIZE_MEETING_S,
                       "turns": len(turns), "speakers": len({t["speaker"] for t in turns}),
                       "turns_equal": True, "diarize_s": time.perf_counter() - t0}
    del d
    torch.cuda.empty_cache()
    return out, npz["hf"]


def whisper_train_flops(cfg, b: int, t: int) -> float:
    """Operations of one training step (forward and backward, 3x the
    forward's products) at batch b and t tokens: the conv stem, every
    linear, both attentions, the cross K/V over the encoder states and the
    logits."""
    d, ta, tm = cfg.n_audio_state, cfg.n_audio_ctx, 2 * cfg.n_audio_ctx
    enc = (2 * cfg.n_mels * 3 * d * tm + 2 * d * 3 * d * ta
           + cfg.n_audio_layer * (2 * 12 * d * d * ta + 4 * ta * ta * d))
    e = cfg.n_text_state
    dec = (cfg.n_text_layer * (2 * 14 * e * e * t + 2 * 2 * e * e * ta + 4 * t * t * e + 4 * t * ta * e)
           + 2 * t * e * cfg.n_vocab)
    return 3.0 * b * (enc + dec)


class StepTimer:
    """Wraps ``module.<name>`` (a train step returning (state, loss)) for
    the length of a ``with``: each call is timed between two synchronises
    and its loss kept; ``first(*args)`` runs once, before the first step.
    ``profile()`` then runs one more step, on the last step's arguments,
    under the profiler."""

    def __init__(self, module, name: str, first=None):
        self.module, self.name, self.first = module, name, first
        self.ms: list[float] = []
        self.losses: list[float] = []

    def __enter__(self):
        step = self.fn = getattr(self.module, self.name)

        def timed(*args, **kw):
            if self.first is not None and not self.ms:
                self.first(*args, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(*args, **kw)
            torch.cuda.synchronize()
            self.ms.append(1e3 * (time.perf_counter() - t0))
            self.losses.append(float(loss))
            self.last = (state, *args[1:]), kw
            return state, loss

        setattr(self.module, self.name, timed)
        torch.cuda.reset_peak_memory_stats()
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)

    def summary(self) -> dict:
        ms = sorted(self.ms)
        return {"steps": len(ms), "ms_step_median": float(np.median(ms)), "ms_step_range": [ms[0], ms[-1]],
                "ms_steps": self.ms, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "loss_first": self.losses[0], "loss_last": self.losses[-1], "losses": self.losses}

    def profile(self) -> dict | str:
        """Kernel time by kernel over one more step, and its share of the
        unprofiled median step (the device's busy share)."""
        args, kw = self.last
        del self.last
        return profile_decode(lambda: self.fn(*args, **kw), float(np.median(self.ms)))


def phase_train(dev, npz: str, work: str, card: str) -> tuple[dict, dict]:
    """The three trainers through their CLI subcommands, on the card:
    ``finetune-whisper`` from the converted whisper-small checkpoint
    (float32, TF32 off, batch 8, 128 tokens, 5 steps on 8 seeded 30 s
    WAVs; step 0's loss held to the CPU's on its first row; --out, then a
    transcribe from the saved .npz), ``train-segmentation`` (10 s, d=192)
    and ``train-embedding`` (ResNet34, 3 s crops) at their default batches
    for 5 steps, and ``calibrate-alignment-heads --write`` on a copy of the
    converted checkpoint with a 30 s recording.  Each trainer's ms a step
    (median, range), peak GB and loss from first to last; kernel A's
    launches on the finetune and segmentation paths, kernel B's on the
    calibration; each trainer's kernels over one more step under the
    profiler.  Returns (summary, launches by path)."""
    import shutil

    from audio_processor_tpu_torch.models.diarization import segmentation_tpu as seg_tpu
    from audio_processor_tpu_torch.models.whisper import convert, model
    from audio_processor_tpu_torch.ops.kernels.decode_attention import cross_attention_int4_stacked
    from audio_processor_tpu_torch.ops.kernels.log_mel import log_mel
    from audio_processor_tpu_torch.pipeline.transcribe import Transcriber
    from audio_processor_tpu_torch.training import diarization_trainer as dt
    from audio_processor_tpu_torch.training import embedding_trainer as et
    from audio_processor_tpu_torch.training import train_step as ts
    from audio_processor_tpu_torch.utils import wavio

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("train: TF32 is on")
    out: dict = {"phase": "train", "card": card}
    launches: dict = {}
    wavs, lines = [], []
    for i in range(TRAIN_WAVS):
        path = os.path.join(work, f"train{i}.wav")
        wavio.write_wav(path, speech_like(30.0, 100 + i), 16_000)
        wavs.append(path)
        lines.append(json.dumps({"audio": path, "text": f"the meeting notes number {i} say hello"}))
    manifest = os.path.join(work, "manifest.jsonl")
    with open(manifest, "w") as f:
        f.write("\n".join(lines) + "\n")

    # finetune-whisper; step 0's first row on the card and on the CPU, f32
    step0: dict = {}

    def cpu_check(state, cfg, batch, lr=1e-4, mesh=None):
        row = ts.Batch(*(x[:1] for x in batch))
        with torch.no_grad():
            card_loss = float(ts.loss_fn(state.params, cfg, row))
            t0 = time.perf_counter()
            cpu_loss = float(ts.loss_fn(model.map_params(lambda t: t.cpu(), state.params), cfg,
                                        ts.Batch(*(x.cpu() for x in row))))
        step0.update(card=card_loss, cpu=cpu_loss, cpu_s=time.perf_counter() - t0,
                     rel_err=abs(card_loss - cpu_loss) / abs(cpu_loss))

    tuned = os.path.join(work, "tuned.npz")
    zero_counts([log_mel])
    with StepTimer(ts, "train_step", first=cpu_check) as timer:
        t0 = time.perf_counter()
        printed = cli_run(["finetune-whisper", manifest, "--model-path", npz, "--steps", "5",
                           "--batch", "8", "--max-tokens", "128", "--out", tuned])
        wall = time.perf_counter() - t0
    launches["finetune"] = read_counts([log_mel], (), "train finetune")
    if step0["rel_err"] > 1e-5 or not all(np.isfinite(timer.losses)):
        fail(f"train: finetune step 0's loss on the card vs the CPU: {step0}; losses {timer.losses}")
    cfg = convert.load_params(npz, "cpu")[1]
    flops = whisper_train_flops(cfg, 8, 128)
    fin = timer.summary()
    fin["profile"] = timer.profile()
    fin.update(wall_s=wall, printed=printed.strip().splitlines(), step0_row0=step0,
               launches=launches["finetune"], flops_step=flops,
               bound_ms_fp32=1e3 * flops / PEAK_FP32_FLOPS)
    fin["bound_share"] = fin["bound_ms_fp32"] / fin["ms_step_median"]
    tr = Transcriber.from_npz(tuned, device=dev, enable_fallback=False)
    res = tr.transcribe(speech_like(30.0, 100))
    check_segments(res, 30.0, "train finetune transcribe")
    fin["transcribe_from_saved"] = {"segments": len(res["segments"]), "rtf_x": res["rtf_x"]}
    out["finetune_whisper"] = fin
    del tr
    torch.cuda.empty_cache()

    # train-segmentation at the published widths; step 0 on the CPU as well
    seg0: dict = {}

    def seg_cpu(state, cfg, audio, targets, member, lut, lr=3e-4):
        net = seg_tpu.params_from_jax(seg_tpu.params_to_jax(state.params), cfg, "cpu")
        with torch.no_grad():
            seg0["cpu"] = float(dt.permutation_invariant_loss(
                net(audio.cpu()), targets.cpu(), member.cpu(), lut.cpu()))

    zero_counts([log_mel])
    with StepTimer(dt, "train_step", first=seg_cpu) as timer:
        printed = cli_run(["train-segmentation", "--steps", "5"])
    launches["train_segmentation"] = read_counts([log_mel], (), "train segmentation")
    seg = timer.summary()
    seg["profile"] = timer.profile()
    seg0["card"] = seg["loss_first"]
    seg0["rel_err"] = abs(seg0["card"] - seg0["cpu"]) / abs(seg0["cpu"])
    if seg0["rel_err"] > 1e-5:
        fail(f"train: segmentation step 0's loss on the card vs the CPU: {seg0}")
    seg.update(config="10 s, d=192, 4 heads, 4 layers, batch 8", step0=seg0,
               launches=launches["train_segmentation"])
    out["train_segmentation"] = seg
    torch.cuda.empty_cache()

    with StepTimer(et, "train_step") as timer:
        printed = cli_run(["train-embedding", "--steps", "5"])
    emb = timer.summary()
    emb["profile"] = timer.profile()
    if not all(np.isfinite(emb["losses"])):
        fail(f"train: embedding losses {emb['losses']}")
    emb.update(config="ResNet34 (base 32, blocks 3/4/6/3), 3 s crops, batch 16, bf16 convs")
    out["train_embedding"] = emb
    torch.cuda.empty_cache()

    # calibrate-alignment-heads --write on a copy of the converted checkpoint
    cal = os.path.join(work, "calibrate.npz")
    shutil.copyfile(npz, cal)
    zero_counts([cross_attention_int4_stacked])
    t0 = time.perf_counter()
    printed = cli_run(["calibrate-alignment-heads", cal, wavs[0], "--write"])
    wall = time.perf_counter() - t0
    launches["calibrate"] = read_counts([cross_attention_int4_stacked], (), "train calibrate")
    heads = tuple(tuple(h) for h in json.loads(printed)["alignment_heads"])
    got = convert.load_params(cal, "cpu")[1]
    if not heads or got.alignment_heads != heads or convert.load_tokenizer(cal) is None:
        fail(f"train: calibrate-alignment-heads wrote {got.alignment_heads}, printed {heads}")
    out["calibrate_alignment_heads"] = {"heads": heads, "wall_s": wall, "vocab_kept": True,
                                        "launches": launches["calibrate"]}
    return out, launches


BD_TRAIN_STEPS = 20
BD_TRIALS = 5  # the builder's own validation trials
BD_SEEDED_MODEL = "test"  # the smallest preset convert-whisper and the Transcriber take
BD_SEEDED_TRANSCRIBER = {"compute_dtype": "float32", "enable_fallback": False,
                         "max_new_tokens": 16}


def quiet(fn, *args, **kw):
    """fn's result, its standard output kept out of the run's (the
    builder prints a line a step and a trial); when fn raises, what it
    printed goes to standard error and the exception on (a failed gate's
    ``SystemExit`` ends the run)."""
    import contextlib
    import io

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            return fn(*args, **kw)
    except BaseException:
        print(buf.getvalue(), file=sys.stderr, flush=True)
        raise


def write_rank_file(path: str, n_text: int) -> None:
    """A tiktoken rank file covering every text id of a tiny vocab: the 256
    bytes, then pairs (a space, a digit or a letter, then a letter)."""
    import base64
    import itertools

    letters = "abcdefghijklmnopqrstuvwxyz"
    toks = [bytes([b]) for b in range(256)]
    toks += [(a + b).encode() for a, b in itertools.product(" 0123456789" + letters, letters)]
    with open(path, "wb") as f:
        for rank, tok in enumerate(toks[:n_text]):
            f.write(base64.b64encode(tok) + b" " + str(rank).encode() + b"\n")


def phase_bundled_diarizer(dev, work: str) -> tuple[dict, dict]:
    """The bundled diarizer's builder and the parity tool on the card.
    (a) ``make_bundled_diarizer.validate`` on the port's committed assets
    at the tool's settings (5 trials a split, the two 21 min meetings, the
    assets' onset, threshold and decode knobs): a failed gate raises
    ``SystemExit`` and ends the run; each split's median DER and
    decomposition, host synthesis and ``diarize`` seconds, the count
    accuracy, kernel A's launches.  (b) The builder's two trainers for 20
    steps each at its batches (12; 32 crops, a bank of 32): ms a step,
    peak GB, losses, kernel A's launches (one a segmentation step and one
    for ``calibrate_onset``'s slab), then the ``--from-cache`` round trip,
    leaves bit-equal.  (c) ``verify_parity`` on a seeded Whisper case at
    the "test" preset's widths (an openai ``.pt`` through
    ``convert-whisper``, a rank file covering its text ids, the expected
    text from the CPU Transcriber): the card's transcript passes, a
    changed text fails, and ``main`` records what it finds."""
    from audio_processor_tpu_torch.models.whisper.config import get_config
    from audio_processor_tpu_torch.models.whisper.decode import SpecialTokens
    from audio_processor_tpu_torch.models.whisper.tokenizer import BPETokenizer
    from audio_processor_tpu_torch.ops.kernels.decode_attention import cross_attention_int4_stacked
    from audio_processor_tpu_torch.ops.kernels.log_mel import log_mel
    from audio_processor_tpu_torch.pipeline.diarize import ASSETS_DIR, Diarizer
    from audio_processor_tpu_torch.pipeline.ingest import load_audio
    from audio_processor_tpu_torch.pipeline.transcribe import Transcriber
    from audio_processor_tpu_torch.tools import make_bundled_diarizer as tool
    from audio_processor_tpu_torch.tools import verify_parity as vp
    from audio_processor_tpu_torch.training import diarization_trainer as dt
    from audio_processor_tpu_torch.training import embedding_trainer as et
    from audio_processor_tpu_torch.utils import wavio

    t_phase = time.perf_counter()
    out: dict = {"phase": "bundled_diarizer"}
    launches: dict = {}
    held_gb = torch.cuda.memory_allocated() / 1e9

    # (a) the held-out gates on the committed assets
    seg_path = os.path.join(ASSETS_DIR, Diarizer.BUNDLED_SEG)
    emb_path = os.path.join(ASSETS_DIR, Diarizer.BUNDLED_EMB)
    seg, _ = dt.load_params(seg_path, dev)
    onset, decode = dt.load_onset(seg_path) or 0.5, dt.load_decode_meta(seg_path)
    emb, _ = et.load_params(emb_path, dev)
    thr = et.load_cluster_threshold(emb_path)
    report: dict = {}
    zero_counts([log_mel])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    quiet(tool.validate, seg, onset, emb, thr, decode, trials=BD_TRIALS, report=report)
    wall = time.perf_counter() - t0
    launches["bundled_validate"] = read_counts([log_mel], (), "bundled_diarizer validate")["log_mel"]
    out["validate"] = {
        "assets": {"onset": onset, "cluster_threshold": thr, "decode": decode},
        "trials": BD_TRIALS, "wall_s": wall, "gates_passed": True,
        "splits": {name: {"median_der": sp["median"], "gate": sp["gate"], "ders": sp["ders"],
                          **{f"{k}_median": float(np.median(sp[k]))
                             for k in ("miss", "false_alarm", "confusion")},
                          "speakers": [f"{h}/{r}" for h, r in zip(sp["hyp_speakers"],
                                                                   sp["ref_speakers"])],
                          "synth_s": sp["synth_s"], "diarize_s": sp["diarize_s"]}
                   for name, sp in report["splits"].items()},
        "count": report["count"], "launches_log_mel": launches["bundled_validate"],
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "held_gb_before": held_gb}
    del seg, emb
    torch.cuda.empty_cache()

    # (b) a short build at the builder's widths and batches
    rng = np.random.default_rng(20260817)  # the builder's training seed
    build: dict = {}

    def timed_training(module, train):
        zero_counts([log_mel])
        t0 = time.perf_counter()
        with StepTimer(module, "train_step") as timer:
            result = quiet(train)
        wall = time.perf_counter() - t0
        return result, {**timer.summary(), "wall_s": wall,
                        "host_ms_per_step": 1e3 * (wall - sum(timer.ms) / 1e3) / BD_TRAIN_STEPS,
                        "launches_log_mel": log_mel.launches}

    (seg, seg_onset), build["segmentation"] = timed_training(
        dt, lambda: tool.train_segmentation(rng, BD_TRAIN_STEPS, 12, device=dev))
    emb, build["embedding"] = timed_training(
        et, lambda: tool.train_embedding(rng, BD_TRAIN_STEPS, 32, n_bank=32, device=dev))
    build["segmentation"].update(batch=12, calibrated_onset=seg_onset)
    build["embedding"].update(batch=32, n_bank=32)
    launches["bundled_train"] = build["segmentation"]["launches_log_mel"]
    if launches["bundled_train"] != BD_TRAIN_STEPS + 1:
        fail(f"bundled_diarizer: kernel A launched {launches['bundled_train']} times in "
             f"{BD_TRAIN_STEPS} segmentation steps and calibrate_onset, not {BD_TRAIN_STEPS + 1}")
    if not all(np.isfinite(part["losses"]).all() for part in build.values()):
        fail(f"bundled_diarizer: training losses {build}")
    cache = os.path.join(work, "bundled_cache")
    quiet(tool._cache_candidates, cache, seg, seg_onset, emb)
    seg2, onset2, emb2 = quiet(tool._load_candidates, cache, dev)
    build["reload_bit_equal"] = (leaves_equal(seg, seg2) and leaves_equal(emb, emb2)
                                 and onset2 == seg_onset)
    if not build["reload_bit_equal"]:
        fail("bundled_diarizer: the --from-cache reload differs from the trained pair")
    out["build"] = build
    del seg, seg2, emb, emb2
    torch.cuda.empty_cache()

    # (c) the parity tool's flow on a seeded Whisper case
    pdir = os.path.join(work, "parity")
    os.makedirs(pdir)
    cfg = get_config(BD_SEEDED_MODEL)
    params = perturbed_whisper_params(cfg, seed=16)
    dims = {k: getattr(cfg, k) for k in ("n_mels", "n_audio_ctx", "n_audio_state", "n_audio_head",
                                         "n_audio_layer", "n_vocab", "n_text_ctx", "n_text_state",
                                         "n_text_head", "n_text_layer")}
    pt, npz = os.path.join(pdir, "seeded.pt"), os.path.join(pdir, "seeded.npz")
    ranks, wav = os.path.join(pdir, "seeded.tiktoken"), os.path.join(pdir, "speech.wav")
    torch.save({"dims": dims, "model_state_dict": whisper_state_dict(params, cfg, "openai")}, pt)
    write_rank_file(ranks, SpecialTokens.for_config(cfg).eot)
    cli_run(["convert-whisper", pt, npz, "--tokenizer", ranks])
    wavio.write_wav(wav, speech_like(10.0, 16), 16_000)
    ref = Transcriber.from_npz(npz, tokenizer=BPETokenizer.from_tiktoken(ranks), device="cpu",
                               **BD_SEEDED_TRANSCRIBER)
    expected = ref.transcribe(load_audio(wav), remove_silence=False)["text"]
    if not expected.strip():
        fail("bundled_diarizer: the seeded Whisper case transcribes to no text on the CPU")
    case = {"model_npz": npz, "tokenizer": ranks, "wav": wav, "expected_text": expected,
            "transcriber": BD_SEEDED_TRANSCRIBER}
    with open(os.path.join(pdir, "case-seeded.json"), "w") as f:
        json.dump(case, f)
    counters = [log_mel, cross_attention_int4_stacked]
    zero_counts(counters)
    try:
        got = vp.check_transcript_case(os.path.join(pdir, "case-seeded.json"), dev)
    except vp.ParityFailure as e:
        fail(f"bundled_diarizer: the seeded Whisper case failed on the card: {e}")
    launches["parity_seeded"] = read_counts(counters, (), "bundled_diarizer parity")
    try:
        vp.check_transcript_case(dict(case, expected_text=expected + " x"), dev)
        fail("bundled_diarizer: a changed expected text passed the Whisper gate")
    except vp.ParityFailure:
        pass
    records = {}
    for name, argv in (("no_case", ["--out", os.path.join(work, "parity_none"), "--whisper", "tiny"]),
                       ("seeded", ["--out", pdir, "--whisper", "seeded"])):
        rc = quiet(vp.main, argv)
        with open(os.path.join(argv[1], "PARITY_TORCH.json")) as f:
            records[name] = {k: r["status"] for k, r in json.load(f).items()}
        records[name]["rc"] = rc
    if records != {"no_case": {"whisper:tiny": "skipped", "diarization": "skipped", "rc": 0},
                   "seeded": {"whisper:seeded": "passed", "diarization": "skipped", "rc": 0}}:
        fail(f"bundled_diarizer: verify_parity.main recorded {records}")
    out["parity"] = {"model": f"{BD_SEEDED_MODEL} (seeded .pt through convert-whisper)",
                     "expected_text": expected, "card_text": got["text"], "passed": True,
                     "changed_text_failed": True, "main_records": records,
                     "launches": launches["parity_seeded"]}
    out["seconds"] = time.perf_counter() - t_phase
    return out, launches


def _train_rank(rank, world, tp, port, backend, results, profile) -> None:
    """One rank of a train_tp world: the dry run's dp x tp step (the port's
    ``train_step.dryrun_multichip``), and the same step in this process
    alone on the whole batch, compared on this rank's slices."""
    try:
        import torch.distributed as dist

        from audio_processor_tpu_torch.models.whisper import model
        from audio_processor_tpu_torch.parallel import mesh as mesh_lib
        from audio_processor_tpu_torch.parallel import multihost
        from audio_processor_tpu_torch.training import train_step as ts

        multihost.initialize(f"127.0.0.1:{port}", world, rank, backend=backend)
        loss, state = ts.dryrun_multichip(world, tp)
        mesh = mesh_lib.make_mesh(tp)
        cfg = ts.DRYRUN_CONFIG
        params = model.map_params(lambda t: t.to(mesh.device),
                                  ts.init_train_state(cfg, torch.Generator().manual_seed(0)).params)
        ref = ts.TrainState(params, ts.make_optimizer().init(ts.tree_leaves(params)), 0)
        ref, ref_loss = ts.train_step(ref, cfg, ts.local_batch(ts.dryrun_batch(mesh.dp), None, mesh.device))
        ref = ts.shard_train_state(ref, mesh, cfg)
        diff = max(float((a - b).abs().max()) for a, b in zip(
            ts.tree_leaves(state.params) + state.opt_state.mu + state.opt_state.nu,
            ts.tree_leaves(ref.params) + ref.opt_state.mu + ref.opt_state.nu))
        results.put((rank, True, {"rank": rank, "device": str(mesh.device), "loss": loss,
                                  "one_process_loss": float(ref_loss), "max_param_diff": diff}))
        dist.destroy_process_group()
    except BaseException:  # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()[-3000:]))
        raise


def phase_train_tp() -> dict:
    """One sharded train step at the dry run's tiny config (2+2 layers,
    d=64, vocab 512) on dp1 x tp2 and dp2 x tp2, one process a rank: the
    loss equals one process's on the whole batch within 1e-5, and every
    rank's params and moments its slices of that process's within 1e-5."""
    out: dict = {"phase": "train_tp", "config": "dryrun: 2+2 layers, d=64, 4 heads, vocab 512"}
    for world, tp in ((2, 2), (4, 2)):
        t0 = time.perf_counter()
        ranks, backend = run_world(world, tp, timeout_s=300.0, profile=False, target=_train_rank)
        name = f"dp{world // tp}xtp{tp}"
        for r in ranks:
            if not (abs(r["loss"] - r["one_process_loss"]) <= 1e-5 * abs(r["one_process_loss"])
                    and r["max_param_diff"] <= 1e-5 and r["loss"] == ranks[0]["loss"]):
                fail(f"train_tp {name} rank {r['rank']}: {r}")
        out[name] = {"backend": backend, "seconds": time.perf_counter() - t0, "ranks": ranks}
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tp-only", action="store_true",
                    help="run only transcribe_tp and the single-card transcription it is "
                         "held to (on a machine with a card per rank: the NCCL worlds)")
    ap.add_argument("--probes-only", action="store_true",
                    help="run only the build (its SASS gates) and the probes phase")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU", 2)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from audio_processor_tpu_torch.ops.kernels import build
        from audio_processor_tpu_torch.ops.kernels.decode_attention import (
            cross_attention_int4,
            cross_attention_int4_stacked,
            cross_attention_int4_stacked_tp,
            cross_attention_int8,
        )
        from audio_processor_tpu_torch.ops.kernels.encoder_attention import fused_self_attention
        from audio_processor_tpu_torch.ops.kernels.log_mel import log_mel
        from audio_processor_tpu_torch.runtime.device import resolve_device
    except ImportError as exc:
        fail(f"the port (audio_processor_tpu_torch) is not beside this script: {exc}", 3)
    t_start = time.perf_counter()
    dev = resolve_device("cuda")  # also turns TF32 off
    card = card_line()
    emit({"phase": "device", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0)})
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    logs = build.build(["log_mel", "cross_attn_int4", "cross_attn_int8", "encoder_attn",
                        "cross_attn_probes", "dtw"], ptxas_report=True)
    # per kernel: its name, then its registers and its spills; kernel B's
    # library must convert nibbles without an int-to-float instruction
    i2f = sass_i2f(build, "cross_attn_int4")
    if isinstance(i2f, dict):
        i2f = sum(i2f.values())
        if i2f:
            fail(f"build: cross_attn_int4's SASS holds {i2f} I2F instructions")
    # the probes' library: int-to-float only in the byte-wise unpack (v3.1)
    probe_i2f = sass_i2f(build, "cross_attn_probes")
    if isinstance(probe_i2f, dict):
        byte = [k for k in probe_i2f if "int4_rows_kernelILb1E" in k]
        stray = {k: n for k, n in probe_i2f.items() if n and k not in byte}
        if len(byte) != 1 or not probe_i2f[byte[0]] or stray:
            fail(f"build: cross_attn_probes' I2F by kernel {probe_i2f}")
        probe_i2f = {"byte_unpack": probe_i2f[byte[0]], "other_kernels": sum(probe_i2f.values())
                     - probe_i2f[byte[0]], "kernels": len(probe_i2f)}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "cross_attn_int4_sass_i2f": i2f,
          "cross_attn_probes_sass_i2f": probe_i2f,
          "ptxas": {k: [ln.strip() for ln in v.splitlines()
                        if any(w in ln for w in ("Function properties", "registers", "spill"))]
                    for k, v in logs.items()}})
    if args.tp_only:
        summary, tr = phase_transcribe(dev, [log_mel, cross_attention_int4_stacked])
        emit(summary)
        tp_summary, _, mesh_phases, _ = phase_transcribe_tp(dev, tr)
        for line in (tp_summary, *mesh_phases):
            emit(line)
        emit(phase_train_tp())
        emit({"phase": "total", "seconds": time.perf_counter() - t_start})
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return
    kernels: dict[str, dict] = {}
    if args.probes_only:
        emit(phase_probes(dev, kernels))
        emit({"phase": "total", "seconds": time.perf_counter() - t_start})
        print(card, flush=True)
        emit({"kernels": list(kernels.values())})
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return
    emit(phase_log_mel(dev, kernels))
    emit(phase_cross_attn(dev, kernels))
    emit(phase_cross_attn_int8(dev, kernels))
    emit(phase_cross_attn_int4_single(dev, kernels))
    emit(phase_encoder_attn(dev, kernels))
    emit(phase_cross_attn_tp(dev, kernels))
    torch.cuda.empty_cache()
    emit(phase_probes(dev, kernels))
    emit(phase_check(dev))
    # kernels #4 and #5 are on no single-card path: their counters are
    # zeroed and read beside the others
    summary, tr = phase_transcribe(dev, [log_mel, cross_attention_int4_stacked],
                                   off_path=[cross_attention_int4, cross_attention_int4_stacked_tp])
    emit(summary)
    kernels["log_mel"]["launches"] = summary["launches"]["log_mel"]
    kernels["cross_attn_int4"]["launches"] = summary["launches"]["cross_attention_int4_stacked"]
    openai = phase_transcribe_openai(dev, [log_mel, fused_self_attention, cross_attention_int4_stacked],
                                     off_path=[cross_attention_int4])
    emit(openai)
    kernels["encoder_attn"]["launches"] = openai["launches"]["fused_self_attention"]
    kernels["cross_attn_int4_single"]["launches"] = (
        summary["launches"]["cross_attention_int4"] + openai["launches"]["cross_attention_int4"])
    torch.cuda.empty_cache()
    tp_summary, kernels["cross_attn_int4_tp"]["launches"], mesh_phases, mesh_launches = (
        phase_transcribe_tp(dev, tr))
    emit(tp_summary)
    for line in mesh_phases:
        emit(line)
    names = {"log_mel": "log_mel", "cross_attention_int4_stacked": "cross_attn_int4",
             "cross_attention_int4_stacked_tp": "cross_attn_int4_tp"}
    for (counter, path), n in mesh_launches.items():
        kernels[names[counter]][f"launches_{path}"] = n
    emit(phase_bench(dev, tr, bs=32, n_timed=5, profile=True))
    emit(phase_bench(dev, tr, bs=128, n_timed=2, profile=False))
    emit(phase_bench(dev, tr, bs=128, n_timed=2, profile=False, fused_encoder=True,
                     counters=[fused_self_attention]))
    int8 = phase_bench(dev, tr, bs=32, n_timed=3, profile=False, decoder="int8-kernel",
                       counters=[cross_attention_int8])
    emit(int8)
    kernels["cross_attn_int8"]["launches"] = int8["launches"]["cross_attention_int8"]
    emit(phase_bench(dev, tr, bs=32, n_timed=2, profile=False, decoder="beam5",
                     counters=[cross_attention_int4_stacked]))
    emit(phase_bench(dev, tr, bs=32, n_timed=3, profile=False, decoder="int4-self-int8-w8",
                     counters=[cross_attention_int4_stacked]))
    ingest_lines, ingest_launches = phase_ingest(dev, tr, [log_mel, cross_attention_int4_stacked])
    for line in ingest_lines:
        emit(line)
    for run, counts in ingest_launches.items():
        kernels["log_mel"][f"launches_m4a_{run}"] = counts["log_mel"]
        kernels["cross_attn_int4"][f"launches_m4a_{run}"] = counts["cross_attention_int4_stacked"]
    del tr
    torch.cuda.empty_cache()
    df_lines, df_launches = phase_device_frontend(dev, card)
    for line in df_lines:
        emit(line)
    for path, n in df_launches.items():
        kernels["log_mel"][f"launches_{path}"] = n
    emit(phase_transcribe_words(dev, [log_mel, cross_attention_int4_stacked], card))
    torch.cuda.empty_cache()
    serve, serve_launches = phase_serve(
        dev, card, next(p for p in mesh_phases if p["phase"] == "serve_tp")["jobs"])
    emit(serve)
    for name, n in serve_launches.items():
        kernels[name]["launches_serve"] = n
    emit(phase_diarize(dev, kernels))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        convert, npz = phase_convert(dev, [log_mel, cross_attention_int4_stacked], work)
        emit(convert)
        train, train_launches = phase_train(dev, npz, work, card)
        emit(train)
        torch.cuda.empty_cache()
        bundled, bundled_launches = phase_bundled_diarizer(dev, work)
        emit(bundled)
    for name, n in convert["transcribe"]["launches"].items():
        kernels["log_mel" if name == "log_mel" else "cross_attn_int4"]["launches_convert"] = n
    kernels["log_mel"]["launches_finetune"] = train_launches["finetune"]["log_mel"]
    kernels["log_mel"]["launches_train_segmentation"] = train_launches["train_segmentation"]["log_mel"]
    kernels["cross_attn_int4"]["launches_calibrate"] = (
        train_launches["calibrate"]["cross_attention_int4_stacked"])
    for path in ("bundled_validate", "bundled_train"):
        kernels["log_mel"][f"launches_{path}"] = bundled_launches[path]
    kernels["log_mel"]["launches_parity_seeded"] = bundled_launches["parity_seeded"]["log_mel"]
    kernels["cross_attn_int4"]["launches_parity_seeded"] = (
        bundled_launches["parity_seeded"]["cross_attention_int4_stacked"])
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"kernels": list(kernels.values())})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
