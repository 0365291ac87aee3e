"""Seeded synthetic meetings, made on the device.

The meeting is the held-out generator of the repository's diarizer tests
(``chip_smoke.make_meeting`` on ``synth_voice``): speakers in rotation,
each turn a harmonic stack with pitch wobble and syllabic amplitude
modulation, turns and gaps of uniform lengths, a noise floor.  The turn
plan comes from numpy's generator (a few thousand numbers); the samples
are computed on the device in one pass, since a 30 min meeting is 28.8 M
samples.  The same seed gives the same meeting on the same device type.
"""
from __future__ import annotations

import math

import numpy as np
import torch

SR = 16_000
HARMONICS = ((1, 1.0), (2, 0.6), (3, 0.4), (4, 0.25))


def meeting_plan(rng: np.random.Generator, mix: dict) -> dict:
    """Speaker pitches and the turn plan of one meeting of the mix."""
    f0s = [float(rng.uniform(lo, hi)) for lo, hi in mix["speaker_f0_hz"]]
    dur = float(mix["meeting_s"])
    turns = []
    t, i = mix["first_turn_s"], 0
    while t < dur - 2.0:
        length = float(rng.uniform(*mix["turn_s"]))
        turns.append((t, min(t + length, dur), i % len(f0s), float(rng.uniform(2, 5)),
                      float(rng.uniform(3, 7)), *(float(x) for x in rng.uniform(0, 6.28, 4))))
        t += length + float(rng.uniform(*mix["gap_s"]))
        i += 1
    return {"f0s": f0s, "turns": turns, "seconds": dur}


def render(plan: dict, noise: float, seed: int, device) -> torch.Tensor:
    """The plan's float32 samples on ``device``."""
    n = int(plan["seconds"] * SR)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    audio = torch.randn(n, generator=gen, device=device) * noise
    turns = torch.tensor(plan["turns"], dtype=torch.float64, device=device)
    a = (turns[:, 0] * SR).long()
    b = (turns[:, 1] * SR).long()
    owner = torch.full((n,), -1, dtype=torch.long, device=device)
    idx = torch.arange(len(turns), device=device)
    lens = b - a
    # every sample of a turn knows its turn: turns never overlap
    pos = torch.repeat_interleave(a, lens) + (
        torch.arange(int(lens.sum()), device=device) - torch.repeat_interleave(
            torch.cumsum(lens, 0) - lens, lens))
    owner[pos] = torch.repeat_interleave(idx, lens)
    keep = owner >= 0
    tr = turns[owner[keep]]
    t = (torch.arange(n, device=device)[keep] - (tr[:, 0] * SR).long()).double() / SR
    f0 = torch.tensor(plan["f0s"], dtype=torch.float64, device=device)[tr[:, 2].long()]
    wobble = 1.0 + 0.02 * torch.sin(2 * math.pi * tr[:, 3] * t)
    x = torch.zeros_like(t)
    for j, (h, amp) in enumerate(HARMONICS):
        x += amp * torch.sin(2 * math.pi * f0 * h * wobble * t + tr[:, 5 + j])
    syllable = 0.55 + 0.45 * torch.sin(2 * math.pi * tr[:, 4] * t) ** 2
    audio[keep] += (x * syllable * 0.25).float()
    return audio


def meeting(mix: dict, seed: int, device) -> np.ndarray:
    """One meeting of the mix as float32 host samples."""
    plan = meeting_plan(np.random.default_rng(seed), mix)
    return render(plan, mix["noise"], seed, device).cpu().numpy()

