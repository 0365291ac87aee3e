"""Closed loop of one client calling ``Transcriber.transcribe`` on whole
recordings, back to back, until the window's seconds have passed.

Set-up draws the weights on the card, builds the Transcriber through its
public constructor with the configuration's run options, synthesises the
mix's pool of recordings from the seed, and transcribes each recording of
the pool once, so that every kernel is built and the allocator has grown
at the window's own shapes (seek-repair slabs included) before it opens.
"""
from __future__ import annotations

import sys
import time
import traceback

import numpy as np
import torch

from .. import audio as audio_lib
from .. import check as check_lib
from .. import counts
from .. import model as model_lib
from ..probe import Probe


def item_seed(seed: int, i: int) -> int:
    return int(np.random.SeedSequence([seed % (1 << 64), i + 8]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


class Run:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, sync: bool):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.params = model_lib.make_params(cfg, seed, device)
        self.tr = model_lib.transcriber(cfg, self.params, device)
        self.probe = Probe(self.tr, sync=sync)
        self.pool = [audio_lib.meeting(mix, item_seed(seed, i), device)
                     for i in range(mix["pool"])]
        for audio in self.pool:
            self.tr.transcribe(audio)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.probe.reset()
        self.items: list[dict] = []
        self.attempted = self.failed = 0

    def _one(self, audio: np.ndarray) -> dict:
        log = self.probe.begin()
        t0 = time.perf_counter()
        result = self.tr.transcribe(audio)
        return {"audio": audio, "audio_s": len(audio) / audio_lib.SR, "start": t0,
                "end": time.perf_counter(), "log": log, "result": result}

    def window(self, seconds: float) -> None:
        self.t_start = time.perf_counter()
        i = 0
        while True:
            self.attempted += 1
            try:
                self.items.append(self._one(self.pool[i % len(self.pool)]))
            except Exception:  # a failed request counts, and the loop goes on
                self.failed += 1
                traceback.print_exc(file=sys.stderr)
            i += 1
            if time.perf_counter() - self.t_start >= seconds:
                break
        self.t_end = time.perf_counter()

    def traced_item(self) -> None:
        """One more recording of the pool, for the profiler."""
        self._one(self.pool[0])

    def check(self, control: bool = False) -> dict:
        """The reference's numbers over a sample of the finished
        recordings drawn from the seed (all of one length, so the sample
        holds a longest)."""
        if not self.items:
            return {"finished_items": 0}
        pick = int(np.random.default_rng(item_seed(self.seed, -3)).integers(len(self.items)))
        item = self.items[pick]
        judge = check_lib.Judge(self.params, self.cfg, control=control)
        return judge.transcript(item["audio"], item["log"], item["result"])

    def work(self) -> dict:
        """What the window did, from the spans and the call logs: real
        windows decoded (grid and seek-repair rows, not slab padding), the
        spans' seconds, decode steps, and the model FLOPs of that work."""
        rows = [(e[1], min(self.tr.max_new_tokens, int(e[2].lengths.max()) + 1))
                for it in self.items for e in it["log"] if e[0] == "collect"]
        flops = sum(n * (counts.encoder_flops(self.cfg) + counts.decoder_flops(self.cfg, 3, s))
                    for n, s in rows)
        return {"windows": sum(n for n, _ in rows), "flops": flops,
                "decode_steps": self.probe.decode_steps(),
                "encode_s": self.probe.spans["encode"], "decode_s": self.probe.spans["decode"],
                "items_s": sum(it["end"] - it["start"] for it in self.items),
                "audio_s": sum(it["audio_s"] for it in self.items),
                "wall_s": (self.items[-1]["end"] - self.t_start) if self.items else 0.0}
