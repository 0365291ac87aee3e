"""What decides ``correct`` in the DeepSeek-V2 cell: the program's
generations held to the plain reference (``portbench/reference/
deepseek_v2.py``).

For one meeting of the window, each of its three rows (the speaker task,
the summary, the notes) runs through the reference's full forward pass in
float32 on the weights the program was built from (the benchmark's
bfloat16 draw under the published names, ``portbench/llm_model.py``,
upcast layer by layer),
prompt and generated tokens together, the shared transcript included.  At
each position that produced a generated token:

- ``max_logit_gap``: the widest gap by which the generated token's
  reference logit lies below the reference's best there;
- with ``control``, ``control_logit_gap``: the same gap for the token the
  reference puts first when every weight is rounded to float8 e4m3 (one
  scale a row of each weight matrix), one step below the configuration's
  bfloat16.
"""
from __future__ import annotations

import torch

from .reference import deepseek_v2 as ref

FP8_MAX = 448.0


def fp8(w: torch.Tensor) -> torch.Tensor:
    """w rounded to float8 e4m3, one scale for each row (last axis), in float32."""
    w = w.float()
    scale = w.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


@torch.no_grad()
def judge(weights, cfg: dict, generations: dict, device, control: bool = False) -> dict:
    """Readings over ``generations`` ({task: (prompt ids, generated ids)}),
    with ``weights`` by published name."""
    ref.full_fp32()
    dev = torch.device(device)
    out = {"max_logit_gap": 0.0, "generated_tokens": 0}
    if control:
        out["control_logit_gap"] = 0.0
    for task, (prompt, gen) in generations.items():
        if not gen:
            continue
        ids = torch.tensor(prompt + gen[:-1], dtype=torch.long, device=dev)
        at = torch.arange(len(prompt) - 1, len(ids), device=dev)
        want = torch.tensor(gen, dtype=torch.long, device=dev)
        logits = ref.forward(weights, cfg, ids, positions=at)
        best = logits.max(-1).values
        gap = float((best - logits.gather(1, want[:, None])[:, 0]).max())
        out["max_logit_gap"] = max(out["max_logit_gap"], gap)
        out[f"{task}_logit_gap"] = gap
        out["generated_tokens"] += len(gen)
        if control:
            picks = ref.forward(weights, cfg, ids, positions=at, weight=fp8).argmax(-1)
            cgap = float((best - logits.gather(1, picks[:, None])[:, 0]).max())
            out["control_logit_gap"] = max(out["control_logit_gap"], cgap)
        del logits
    return out
