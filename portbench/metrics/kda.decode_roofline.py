"""``kda_step``'s share of its roofline over the traced item: its bytes
(each active row's state read and written, from ``llm.kda.state_bytes``,
with its q, k, g, v, beta and o; ``portbench.kimi_counts``) at 3.35 TB/s
over the profiler's time of its kernels, in %."""
from portbench import kimi_counts


def value(ctx):
    tr, run = ctx.get("trace"), ctx.get("run")
    traced = getattr(run, "traced", None)
    if tr is None or not traced:
        return None
    moved = traced[0]["result"]["trace"]["counters"].get("llm.kda.state_bytes", 0)
    t = sum(v[0] for k, v in tr["kernels"].items() if "kda_step" in k)
    if t <= 0 or not moved:
        return None
    need = kimi_counts.step_kernel_bytes(ctx["cfg"], moved)
    return 100.0 * need / kimi_counts.PEAK_BYTES_PER_S / t
