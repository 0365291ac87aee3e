"""What decides ``correct`` in the Kimi-Linear cell: the program's
generations held to the plain reference (``portbench/reference/
kimi_linear.py``).

For one recording of the window, each of its three rows (the speaker
task, the summary, the notes) runs through the reference's full forward
pass in float32 on the weights the program was built from (the
benchmark's bfloat16 draw under the published names,
``portbench/kimi_model.py``, upcast layer by layer, the same 128 experts
held), prompt and generated tokens together: the shared transcript and
what the fork carried into each row are computed again from the first
token, with KDA in the reference's chunked form.  At each position that
produced a generated token the gap is how far the generated token's
reference logit lies below the reference's best there.  Over the
recording's generated tokens:

- ``mean_logit_gap``: the mean gap;
- ``wide_gap_share``: the share of tokens whose gap passes ``WIDE_GAP``;
- ``max_logit_gap``: the widest gap;
- ``generated_tokens``, ``<task>_logit_gap`` (each row's widest) and
  ``check_s``, the seconds the judging took.

With ``control`` the same readings are taken for the token the reference
puts first when every weight is rounded to float8 e4m3 (one scale a row
of each weight matrix, ``llm_check.fp8``), one step below the
configuration's bfloat16, with TF32 products (the control's own forward
only; the reference's stays float32).  The control's readings then take
the plain names, so that the harness's ``correct`` is the control's, the
program's keep them behind ``program_``, and ``control_logit_gap`` is the
control's widest gap, as in the other cells.  ``gaps`` adds every token's
gap (``gaps``, and ``program_gaps`` with the control).

Why not the widest gap: with the cell's random weights the reference's best
logits lie close together, and the program's bfloat16 activations flip
some of a token's 8 picks among 256 sigmoid-scored experts (a flipped pick
moves it by a routed output scaled by 2.446), so the program's token is
not the reference's first in about 65 % of the generated tokens, on the
short speaker row as on the forked transcripts, and its widest gap reads
1.92-2.65 (23 seeds on an H100), while the float8 control's widest reads
only 2.93-4.44: the widest gap saturates.  How many tokens move far
separates: the program's ``wide_gap_share`` read 0.042-0.061 on 8 seeds and
the control's 0.404-0.453, so the limit (``limits/kimilinear.
allday_backlog4.json``) is 0.15, 2.4 times the program's largest and 2.7
times below the control's least.
"""
from __future__ import annotations

import contextlib
import time

import torch

from .llm_check import fp8
from .reference import kimi_linear as ref

WIDE_GAP = 1.0  # a gap the program's bfloat16 reaches on ~5 % of tokens, float8 on ~43 %


@contextlib.contextmanager
def _tf32():
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        ref.full_fp32()


def readings(gaps: torch.Tensor) -> dict:
    """The readings of a recording's gaps (one a generated token)."""
    return {"mean_logit_gap": float(gaps.mean()),
            "wide_gap_share": float((gaps > WIDE_GAP).float().mean()),
            "max_logit_gap": float(gaps.max())}


@torch.no_grad()
def judge(weights, cfg: dict, generations: dict, device, control: bool = False,
          gaps: bool = False) -> dict:
    """Readings over ``generations`` ({task: (prompt ids, generated ids)}),
    with ``weights`` by published name."""
    t0 = time.perf_counter()
    ref.full_fp32()
    dev = torch.device(device)
    out: dict = {"generated_tokens": 0}
    program, controls = [], []
    for task, (prompt, gen) in generations.items():
        if not gen:
            continue
        ids = torch.tensor(prompt + gen[:-1], dtype=torch.long, device=dev)
        at = torch.arange(len(prompt) - 1, len(ids), device=dev)
        want = torch.tensor(gen, dtype=torch.long, device=dev)
        logits = ref.forward(weights, cfg, ids, positions=at)
        best = logits.max(-1).values
        gap = best - logits.gather(1, want[:, None])[:, 0]
        program.append(gap.cpu())
        out[f"{task}_logit_gap"] = float(gap.max())
        out["generated_tokens"] += len(gen)
        if control:
            with _tf32():
                picks = ref.forward(weights, cfg, ids, positions=at, weight=fp8).argmax(-1)
            controls.append((best - logits.gather(1, picks[:, None])[:, 0]).cpu())
        del logits
    if not program:
        return dict(out, check_s=time.perf_counter() - t0)
    program = torch.cat(program)
    if control:
        controls = torch.cat(controls)
        out.update({f"program_{k}": v for k, v in readings(program).items()})
        out.update(readings(controls))
        out["control_logit_gap"] = out["max_logit_gap"]
    else:
        out.update(readings(program))
    if gaps:
        if control:
            out["program_gaps"] = program.tolist()
        out["gaps"] = (controls if control else program).tolist()
    out["check_s"] = time.perf_counter() - t0
    return out
