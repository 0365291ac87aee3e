"""openai-whisper's decoding rules, and the gap by which a served token's
logit lies below the best the rules allow.

The rules (openai ``decoding.py``: SuppressTokens, SuppressBlank,
ApplyTimestampRules) are applied to the reference's logits along the
served tokens.  The last timestamp rule is a decision, not a mask: where
the timestamps' total probability beats the best text token, text is
forbidden.  A served token is therefore judged by the least amount by
which the reference's logits would have to move for the rules and the
argmax to pick it:

- a text token ``s``: ``max(best, lse_ts) - L[s]`` (it has to beat every
  allowed token, and the timestamps' total, or timestamps are forced);
- a timestamp ``s``: the smaller of ``best - L[s]`` (it is the argmax)
  and ``max(max_text - lse_ts, max_ts - L[s])`` (timestamps are forced,
  and it is the best of them);
- a token the rules forbid outright: ``FORBIDDEN``.

Greedy decoding at the reference's own precision reads 0 everywhere.
"""
from __future__ import annotations

import torch

FORBIDDEN = 1e9


def allowed_logits(logits: torch.Tensor, served: list[int], st: dict, suppress: torch.Tensor,
                   space_id: int, max_initial_ts: int = 50) -> torch.Tensor:
    """logits (n, V) at the positions that chose served[0..n-1] -> the
    same with every token the rules forbid at -inf.  ``suppress``: (V,)
    bool."""
    n, v = logits.shape
    dev = logits.device
    tb = st["timestamp_begin"]
    ids = torch.arange(v, device=dev)
    is_ts = ids >= tb
    out = logits.masked_fill(suppress[None, :] | (ids == st["no_timestamps"])[None, :],
                             float("-inf"))
    rows = torch.zeros((n, v), dtype=torch.bool, device=dev)
    last_ts = None  # the last timestamp sampled before step i
    for i in range(n):
        seq = served[:i]
        last_was = len(seq) >= 1 and seq[-1] >= tb
        penult_was = len(seq) < 2 or seq[-2] >= tb
        if last_was:
            if penult_was:
                rows[i] |= is_ts
            else:
                rows[i] |= ids < st["eot"]
        if last_ts is not None:
            floor = last_ts if (last_was and not penult_was) else last_ts + 1
            rows[i] |= is_ts & (ids < floor)
        if i == 0:
            rows[i] |= ~is_ts
            rows[i] |= ids > tb + max_initial_ts
            rows[i, space_id] = True
            rows[i, st["eot"]] = True
        if i < len(served) and served[i] >= tb:
            last_ts = served[i]
    return out.masked_fill(rows, float("-inf"))


def token_gaps(allowed: torch.Tensor, served: list[int], st: dict) -> torch.Tensor:
    """(n,) gap of each served token under ``allowed`` (n, V) logits."""
    tb = st["timestamp_begin"]
    s = torch.as_tensor(served, device=allowed.device)
    ninf = float("-inf")
    ls = allowed.gather(1, s[:, None])[:, 0]
    best = allowed.max(dim=1).values
    text = allowed[:, :tb]
    ts = allowed[:, tb:]
    max_text = text.max(dim=1).values
    max_ts = ts.max(dim=1).values
    lse_ts = torch.logsumexp(ts, dim=1)
    gap_text = torch.maximum(best, lse_ts) - ls
    forced = torch.maximum(torch.where(max_text > ninf, max_text - lse_ts,
                                       torch.zeros_like(lse_ts)), max_ts - ls)
    gap_ts = torch.minimum(best - ls, forced)
    gap = torch.where(s >= tb, gap_ts, gap_text).clamp(min=0.0)
    return torch.where(ls == ninf, torch.full_like(gap, FORBIDDEN), gap)


def first_choices(allowed: torch.Tensor, st: dict) -> torch.Tensor:
    """(n,) the token greedy decoding picks under ``allowed`` logits: the
    argmax, within the timestamps where their total beats the best text."""
    tb = st["timestamp_begin"]
    force = torch.logsumexp(allowed[:, tb:], dim=1) > allowed[:, :tb].max(dim=1).values
    pick_ts = tb + allowed[:, tb:].argmax(dim=1)
    return torch.where(force, pick_ts, allowed.argmax(dim=1))


def avg_logprob(allowed: torch.Tensor, served: list[int], st: dict) -> float:
    """openai's avg_logprob of a row: the served tokens' log-probabilities
    under the rules (timestamps forced where their total wins), summed
    over the tokens before EOT, over their count + 1."""
    tb = st["timestamp_begin"]
    force = torch.logsumexp(allowed[:, tb:], dim=1) > allowed[:, :tb].max(dim=1).values
    masked = allowed.clone()
    masked[force, :tb] = float("-inf")
    lp = torch.log_softmax(masked, dim=-1).gather(
        1, torch.as_tensor(served, device=allowed.device)[:, None])[:, 0]
    keep = torch.as_tensor(served, device=allowed.device) != st["eot"]
    return float(lp[keep].sum()) / (int(keep.sum()) + 1)
