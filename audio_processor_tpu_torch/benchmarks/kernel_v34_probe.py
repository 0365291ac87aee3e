"""Kernel v3.4 probe on the H100: batch rows a block, and the stream floor.

The port's counterpart of ``benchmarks/kernel_v34_probe.py`` (the JAX
package's, unchanged).  Its variants of kernel B's function on one layer of
the stacked int4 cache, BB batch rows a block:

  v32      the production body on grid (B,): kernel B (csrc/cross_attn_int4.cu)
  a        the BB rows walked in turn, the next row's time chunk copied into
           shared memory meanwhile: P2 ``int4_rows(bb=BB, joint=False)``
  b-e      a warp group a row, each on barriers of its own:
           P2 ``int4_rows(bb=BB, joint=True)``.  On the TPU, b batches the
           softmax chain, c the products (dot_general), d and e feed the
           matrix unit block-diagonal q and P; they compute one function, and
           a warp's loop over its row is already that on this card, so all
           four run one kernel
  s        stream-only: the same bytes with P2's loads, reduced to the JAX
           probe's checksum: P1 ``probe_stream(bb=BB)``

Every variant is gated against v32 on layers 0 and L-1 (max abs err < 1e-4,
as the JAX probe gates), ``s`` bit-equal to its plain version; then each is
timed as the JAX probe times it (12 layers a step, ``--steps`` steps, least
of 3 runs by CUDA events), beside its device ms a call, byte bound and the
stream floor at its rows a block.  ``--prod`` gates and times kernel B
(the production kernel) alone against its plain version.

Usage:  python -m audio_processor_tpu_torch.benchmarks.kernel_v34_probe
            [--batch 64] [--steps 64] [--bb 8] [--variants v32,a,b,c]
            [--prod] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import torch

from ..runtime.device import resolve_device
from . import probe_common as pc


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--bb", type=int, default=8)
    ap.add_argument("--variants", default="v32,a,b,c", help="of v32,a,b,c,d,e,s")
    ap.add_argument("--prod", action="store_true",
                    help="gate and time the production kernel (kernel B) alone")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {pc.describe(dev)}", flush=True)
    data = pc.make_inputs(args.batch, dev)
    table = pc.variants("v34", bb=args.bb)
    names = ["v32"] if args.prod else [x.strip() for x in args.variants.split(",") if x.strip()]
    unknown = [x for x in names if x not in table]
    if unknown:
        ap.error(f"unknown variants {unknown}; choose from {list(table)}")
    variants = {x: table[x] for x in names}
    for v in variants.values():
        print(f"{v.label:6s} -> H100: {v.counterpart}   (JAX: {v.replaces})")

    q, k4, v4 = data["q"], data["k4"], data["v4"]
    base = table["v32"]
    for layer in (0, pc.L - 1):
        ref = base.call(q, k4, v4, layer)
        err = (ref - base.plain(q, k4, v4, layer)).abs().max().item()
        print(f"prod stacked (B={args.batch}) layer {layer} max abs err vs its plain version: "
              f"{err:.3e}", flush=True)
        assert err <= pc.EXACT_TOL, f"kernel B diverges on layer {layer}"
        for x, v in variants.items():
            if x == "v32":
                continue
            got = v.call(q, k4, v4, layer)
            if v.tol is None:
                assert torch.equal(got, v.plain(q, k4, v4, layer)), f"{x}: checksum differs"
                print(f"v3.4{x} (bb={args.bb}) layer {layer}: bit-equal to its plain version")
                continue
            err = (got - ref).abs().max().item()
            print(f"v3.4{x} (bb={args.bb}) layer {layer} max abs err vs v3.2: {err:.3e}",
                  flush=True)
            assert err < 1e-4, f"variant {x} diverges on layer {layer}"

    floors: dict = {}
    res = {x: pc.measure(v, data, args.steps, floors) for x, v in variants.items()}
    for r in res.values():
        print(pc.line(r), flush=True)
    if "v32" in res:
        for x, r in res.items():
            if x != "v32":
                print(f"v3.4{x}: {res['v32']['step_ms'] / r['step_ms']:.3f}x vs v3.2")
    return res


if __name__ == "__main__":
    with torch.no_grad():
        main()
