"""Kernel B's share of its roofline over the traced item: the least time
its calls need (valid K/V nibbles, q and out at 3.35 TB/s, or float32
FMAs at 67 TFLOP/s, whichever is larger; ``portbench.counts``) over the
profiler's time of its kernels, in %."""
from portbench import counts


def value(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["kernel_b_calls"]:
        return None
    t = sum(v[0] for k, v in tr["kernels"].items() if "cross_attn_int4" in k)
    if t <= 0:
        return None
    need = sum(counts.kernel_b_bound_s(b, f) for b, f in ctx["kernel_b_calls"])
    return 100.0 * need / t
