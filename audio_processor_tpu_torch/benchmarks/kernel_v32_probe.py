"""Kernel v3.2 probe on the H100: byte-wise against packed nibble unpack, and
int8 products.

The port's counterpart of ``benchmarks/kernel_v32_probe.py`` (the JAX
package's, unchanged).  Its three bodies of kernel B's function, on one
layer of the stacked int4 cache:

  v3.1     byte-wise unpack (mask, shift, an int-to-float a nibble):
           P2 ``int4_rows(unpack="byte")`` (csrc/cross_attn_probes.cu)
  v3.2     the production body: kernel B itself (csrc/cross_attn_int4.cu;
           PRMT into 0x4B000000 and one FADD a nibble)
  v3.3mxu  q row-quantised to int8, both products as exact int32 sums, P at
           the static scale 127: P3 ``int8_dot(cache="int4")`` (dp4a)

Each is held to its plain version on layers 0 and L-1 first, then timed as
the JAX probe times it: 12 layers a step, ``--steps`` steps with a data
dependence, the least of 3 runs (CUDA events), beside its device ms a call,
byte bound and stream floor.  Prints each variant's speed-up over v3.1 and
v3.3mxu's error against the exact output on layer 0.

Usage:  python -m audio_processor_tpu_torch.benchmarks.kernel_v32_probe
            [--batch 128] [--steps 64] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import torch

from ..runtime.device import resolve_device
from . import probe_common as pc


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {pc.describe(dev)}", flush=True)
    data = pc.make_inputs(args.batch, dev)
    variants = pc.variants("v32")
    for v in variants.values():
        print(f"{v.label:10s} -> H100: {v.counterpart}   (JAX: {v.replaces})")
    for v in variants.values():
        err = pc.gate(v, data)
        print(f"{v.label:10s} layers 0, {pc.L - 1}: max abs err vs its plain version {err:.3e}",
              flush=True)
    floors: dict = {}
    res = {}
    for name, v in variants.items():
        res[name] = pc.measure(v, data, args.steps, floors)
        print(pc.line(res[name]), flush=True)
    base = res["v3.1"]["step_ms"]
    print(f"v3.2 speedup: {base / res['v3.2']['step_ms']:.3f}x   "
          f"v3.3 speedup: {base / res['v3.3mxu']['step_ms']:.3f}x")
    # accuracy of the lossy v3.3 (q and P quantised) against the exact v3.1, one layer
    q, k4, v4 = data["q"], data["k4"], data["v4"]
    exact = variants["v3.1"].call(q, k4, v4, 0)
    lossy = variants["v3.3mxu"].call(q, k4, v4, 0)
    err = (lossy - exact).abs()
    rel = (err / exact.abs().clamp_min(1e-6)).max().item()
    print(f"v3.3 vs exact: max abs err {err.max().item():.4e}   max rel err {rel:.4e}")
    return res


if __name__ == "__main__":
    with torch.no_grad():
        main()
