"""Kernel v4 probe on the H100: int8 caches, int8 products and bf16 operands.

The port's counterpart of ``benchmarks/kernel_v4_probe.py`` (the JAX
package's, unchanged).  Its variants, on one layer of a stacked cache of the
same ints (int4 nibble-packed, or int8 at twice the bytes):

  v31        the production int4 kernel: kernel B (csrc/cross_attn_int4.cu)
  i8_f32     int8 cache, f32 products: kernel #3 (csrc/cross_attn_int8.cu)
             on the views k8[l], v8[l]
  i8_mxu_k   int8 cache, q row-quantised to int8 and q.K as exact int32
             sums, P.V in f32: P3 ``int8_dot(cache="int8", pv="f32")`` (dp4a)
  i8_mxu_kv  both products in int8, P at the static scale 127:
             P3 ``int8_dot(cache="int8", pv="int8")``
  i4_mxu_kv  the int4 cache unpacked to int8, both products in int8:
             P3 ``int8_dot(cache="int4", pv="int8")``
  i4_bf16    q and P rounded to bf16, f32 sums:
             P2 ``int4_rows(bf16=True)`` (csrc/cross_attn_probes.cu)

Prints the accuracy line first (each variant against exact f32 maths on the
same ints, 4 rows, layer 0; integer units, |v| <= 7), then, after each
variant is held to its plain version on layers 0 and L-1, the timings as the
JAX probe takes them (12 layers a step, ``--steps`` steps, least of 3 runs
by CUDA events) beside the device ms a call, byte bound and stream floor.

Usage:  python -m audio_processor_tpu_torch.benchmarks.kernel_v4_probe
            [--batch 64] [--steps 64] [--accuracy-only] [--only i8_f32,...]
            [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import torch

from ..ops.kernels import decode_attention as da
from ..runtime.device import resolve_device
from . import probe_common as pc


def accuracy(variants: dict, data: dict) -> dict:
    """Each variant's max abs error against exact f32 maths on the same
    ints: 4 rows, layer 0."""
    q, k8, v8 = data["q"][:4], data["k8"][0, :4], data["v8"][0, :4]
    ref = da.cross_attention_int8_reference(q, k8, v8, valid_len=pc.VALID)
    out = {}
    for name, v in variants.items():
        k, vc = pc.cache_of(v, data)
        got = v.call(q.contiguous(), k[:, :4].contiguous(), vc[:, :4].contiguous(), 0)
        out[name] = (got - ref).abs().max().item()
    return out


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--accuracy-only", action="store_true")
    ap.add_argument("--only", help="time just these variants (comma list)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {pc.describe(dev)}", flush=True)
    table = pc.variants("v4")
    names = list(table) if not args.only else [x for x in args.only.split(",") if x]
    unknown = [x for x in names if x not in table]
    if unknown:
        ap.error(f"unknown variants {unknown}; choose from {list(table)}")
    variants = {x: table[x] for x in names}
    caches = {v.cache for v in variants.values()}
    # the accuracy line reads the int8 ints for its exact reference
    need_i8 = "int8" in caches or not args.only
    data = pc.make_inputs(args.batch, dev, int4="int4" in caches, int8=need_i8)
    for v in variants.values():
        print(f"{v.label:10s} -> H100: {v.counterpart}   (JAX: {v.replaces})")
    if not args.only:
        errs = accuracy(variants, data)
        print("max|err| vs exact-int f32 math (int units, |v|<=7):")
        print("  " + "   ".join(f"{x} {e:.5f}" for x, e in errs.items()), flush=True)
        if args.accuracy_only:
            return {"accuracy": errs}
    for v in variants.values():
        err = pc.gate(v, data)
        print(f"{v.label:10s} layers 0, {pc.L - 1}: max abs err vs its plain version {err:.3e}",
              flush=True)
    floors: dict = {}
    res = {}
    for name, v in variants.items():
        res[name] = pc.measure(v, data, args.steps, floors)
        print(pc.line(res[name]), flush=True)
    return res


if __name__ == "__main__":
    with torch.no_grad():
        main()
