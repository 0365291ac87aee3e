"""Closed loop of one client writing up all-day recordings with the
program's on-card Kimi-Linear, batch after batch, until the window's
seconds have passed.

The meetings are ``notes_loop``'s synthesis (its ``batch``: lengths
stratified over the mix's ``minutes``, ``tokens_per_minute`` tokens a
minute in turns between the mix's speakers, who address each other in
``address_share`` of the turns), and each batch goes through the job's
own stages 5-7 (``MeetingProcessor.write_up``) as there: every
recording's speaker task in one call of the engine, then every
recording's summary and notes, the two rows forked from one prefilled
transcript.  What differs is the model: the program's Kimi-Linear
(``kimi_model``: the weights of the experts this card holds, under the
published names), judged by its own reference (``kimi_check``) and
counted by ``kimi_counts``.

Set-up draws the weights on the card, builds the client through its
public constructors, synthesises the pool of batches and runs each batch
through the stages once with the decode cut to one step, so every
session is captured and every prefill shape has run before the window
opens.  A recording counts when its notes are done: at the end of its
batch.  A program without KDA layers fails at this module's import,
before any weight is drawn.
"""
from __future__ import annotations

import gc
import itertools

import numpy as np
import torch
from audio_processor_tpu_torch.models.llm.kda import States  # noqa: F401 (needs the KDA layers)

from .. import kimi_check, kimi_counts, kimi_model
from . import notes_loop


class Run(notes_loop.Run):
    def __init__(self, cfg: dict, mix: dict, seed: int, device, sync: bool):
        from audio_processor_tpu_torch.pipeline.meeting import MeetingProcessor
        from audio_processor_tpu_torch.runtime import trace
        from audio_processor_tpu_torch.runtime.job_engine import JobEngine

        # an earlier run of this process (the control's seeds) leaves its
        # engine in a reference cycle: free its 51 GB before drawing anew
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self._trace = trace
        self.client, self.weights = kimi_model.client(cfg, seed, device)
        self.proc = MeetingProcessor(transcriber=None, gemini=self.client)
        self.jobs = JobEngine(max_workers=1)  # its store and progress; nothing is submitted
        self._job_ids = itertools.count()
        self.pool = [notes_loop.batch(mix, notes_loop.item_seed(seed, i))
                     for i in range(mix["pool"])]
        engine = self.client.engine
        generate, decode = engine.generate, engine._decode
        self.calls: list = []

        def logged(groups, caps):
            outs = generate(groups, caps)
            self.calls.append((groups, outs))
            return outs

        # set-up: each session captured and each prefill run, one decode step
        engine._decode = lambda sess, steps: decode(sess, min(steps, 1))
        try:
            for meetings in self.pool:
                self._stages(meetings)
        finally:
            del engine._decode
        engine.generate = logged
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.items: list[dict] = []
        self.traced: list[dict] = []
        self.attempted = self.failed = 0

    def check(self, control: bool = False) -> dict:
        """The reference's numbers over one recording of the window, drawn
        from the seed; the engine's kept caches are let go first, to make
        room for the reference's float32 layers."""
        served = [it for it in self.items if it["rows"]]
        if not served:
            return {"finished_items": 0}
        engine = self.client.engine
        engine._sessions.clear()
        engine._buffers.clear()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        rng = np.random.default_rng(notes_loop.item_seed(self.seed, -3))
        item = served[int(rng.integers(len(served)))]
        gens = item["rows"][int(rng.integers(len(item["rows"])))]
        return kimi_check.judge(self.weights, self.cfg, gens, self.device, control)

    def work(self) -> dict:
        """What the window did: the recordings' audio seconds, the wall
        time, and the model FLOPs of every row generated (a shared
        transcript once; ``kimi_counts``)."""
        flops = 0
        for it in self.items:
            for g in it["rows"]:
                flops += kimi_counts.group_flops(self.cfg, [g["speakers"]])
                flops += kimi_counts.group_flops(self.cfg, [g["summary"], g["notes"]])
        return {"flops": flops, "batches": len(self.items),
                "meetings": sum(len(it["meetings"]) for it in self.items),
                "items_s": sum(it["end"] - it["start"] for it in self.items),
                "audio_s": sum(it["audio_s"] for it in self.items),
                "wall_s": (self.items[-1]["end"] - self.t_start) if self.items else 0.0}
