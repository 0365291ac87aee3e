"""Closed loop of one client writing up a backlog of meetings with the
program's on-card language model, batch after batch, until the window's
seconds have passed.

A batch is the mix's ``meetings`` transcripts (the diarized segments that
stages 1-4 of the meeting job hand its language-model stages), drawn from
the seed: each meeting's length is uniform over ``minutes`` (stratified:
one meeting in each of as many equal slices of the range, at a uniform
point in it), its transcript holds ``tokens_per_minute`` tokens a minute
under the cell's tokenizer, in turns of ``segment_s`` seconds between 2-6
speakers, who address each other by name in ``address_share`` of the
turns.  Each batch goes through the job's own stages 5-7
(``MeetingProcessor.write_up``, in a job of the program's ``JobEngine``),
as a backlog job (``process_backlog``) runs them after transcribing its
recordings: every meeting's speaker task in one call of the client, then
every meeting's summary and notes, the two decoded from one prefilled
transcript.  The benchmark records each call of the engine (prompts and
generated ids) for ``check``.

Set-up draws the weights on the card, builds the client through its
public constructors, synthesises the pool of batches and runs each batch
through the stages once with the decode cut to one step: every session
(the step's CUDA graph at its rows and capacities) is captured, and every
prefill has run, at the window's own shapes before it opens.  A meeting
counts when its notes are done: at the end of its batch.
"""
from __future__ import annotations

import itertools
import sys
import time
import traceback

import numpy as np
import torch

from .. import llm_check, llm_counts, llm_model
from ..tokenizer import word

NAMES = ("Alice", "Bruno", "Chen", "Dana", "Emeka", "Farah", "Goran", "Hana", "Ivan", "Jun",
         "Kofi", "Lena", "Mateo", "Nadia", "Omar", "Priya")
LINE_TOKENS = 6  # "SPEAKER", "_", two digits, ":" and the newline around a turn's words


def item_seed(seed: int, i: int) -> int:
    return int(np.random.SeedSequence([seed % (1 << 64), i + 8]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def meeting(rng: np.random.Generator, minutes: float, mix: dict) -> dict:
    """One meeting's diarized segments."""
    n_spk = int(rng.integers(mix["speakers"][0], mix["speakers"][1] + 1))
    names = rng.choice(NAMES, n_spk, replace=False)
    total, per_s = 60.0 * minutes, mix["tokens_per_minute"] / 60.0
    segs, t, carry, spk = [], 0.0, 0.0, 0
    while t < total:
        dur = min(float(rng.uniform(*mix["segment_s"])), total - t)
        carry += per_s * dur
        n_tok = int(carry)
        carry -= n_tok
        words = [word(int(i)).strip() for i in rng.integers(256, 1 << 16, max(1, n_tok - LINE_TOKENS))]
        nxt = (spk + 1 + int(rng.integers(n_spk - 1))) % n_spk
        if rng.random() < mix["address_share"]:
            words[0] = str(names[nxt])
        segs.append({"start": t, "end": t + dur, "speaker": f"SPEAKER_{spk:02d}",
                     "text": " ".join(words)})
        t += dur
        spk = nxt
    return {"segments": segs, "name": "meeting.m4a", "duration_s": total,
            "attachment_text": ""}


def batch(mix: dict, seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    n = mix["meetings"]
    lo, hi = mix["minutes"]
    minutes = lo + (hi - lo) * (rng.permutation(n) + rng.random(n)) / n
    return [meeting(rng, float(m), mix) for m in minutes]


class Run:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, sync: bool):
        from audio_processor_tpu_torch.pipeline.meeting import MeetingProcessor
        from audio_processor_tpu_torch.runtime import trace
        from audio_processor_tpu_torch.runtime.job_engine import JobEngine

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self._trace = trace
        self.client, self.weights = llm_model.client(cfg, seed, device)
        self.proc = MeetingProcessor(transcriber=None, gemini=self.client)
        self.jobs = JobEngine(max_workers=1)  # its store and progress; nothing is submitted
        self._job_ids = itertools.count()
        self.pool = [batch(mix, item_seed(seed, i)) for i in range(mix["pool"])]
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

    def _stages(self, meetings: list[dict]) -> list[dict]:
        """Stages 5-7 of the job over ``meetings``, in a job of their own."""
        from audio_processor_tpu_torch.runtime.job_engine import JobContext

        job_id = f"batch{next(self._job_ids)}"
        self.jobs.create_job(job_id)
        ctx = JobContext(self.jobs, job_id)
        try:
            return self.proc.write_up(ctx, meetings)
        finally:
            ctx.end_stage()

    def _one(self, meetings: list[dict]) -> dict:
        self.calls.clear()
        with self._trace.request() as rec:
            t0 = time.perf_counter()
            results = self._stages(meetings)
            t1 = time.perf_counter()
        return {"meetings": meetings, "audio_s": sum(m["duration_s"] for m in meetings),
                "start": t0, "end": t1, "results": results, "rows": rows(self.calls),
                "result": {"trace": rec.summary()}}

    def window(self, seconds: float) -> None:
        self.t_start = time.perf_counter()
        i = 0
        while True:
            self.attempted += 1
            try:
                self.items.append(self._one(self.pool[i % len(self.pool)]))
            except Exception:  # a failed batch counts, and the loop goes on
                self.failed += 1
                traceback.print_exc(file=sys.stderr)
            i += 1
            if time.perf_counter() - self.t_start >= seconds:
                break
        self.t_end = time.perf_counter()

    def traced_item(self) -> None:
        """One more batch of the pool, for the profiler."""
        self.traced.append(self._one(self.pool[0]))

    def check(self, control: bool = False) -> dict:
        """The reference's numbers over one meeting of the window, drawn
        from the seed."""
        if not self.items:
            return {"finished_items": 0}
        rng = np.random.default_rng(item_seed(self.seed, -3))
        item = self.items[int(rng.integers(len(self.items)))]
        gens = item["rows"][int(rng.integers(len(item["rows"])))]
        return llm_check.judge(self.weights, self.cfg, gens, self.device, control)

    def work(self) -> dict:
        """What the window did: the meetings' audio seconds, the wall time,
        and the model FLOPs of every row generated (a shared transcript
        once)."""
        flops = 0
        for it in self.items:
            for g in it["rows"]:
                if "speakers" in g:
                    flops += llm_counts.group_flops(self.cfg, [g["speakers"]])
                flops += llm_counts.group_flops(self.cfg, [g["summary"], g["notes"]])
        return {"flops": flops, "batches": len(self.items),
                "meetings": sum(len(it["meetings"]) for it in self.items),
                "items_s": sum(it["end"] - it["start"] for it in self.items),
                "audio_s": sum(it["audio_s"] for it in self.items),
                "wall_s": (self.items[-1]["end"] - self.t_start) if self.items else 0.0}


def rows(calls: list) -> list[dict]:
    """Each meeting's rows ({task: (prompt ids, generated ids)}) from the
    engine's calls of one batch, in order: the speaker calls (one row a
    meeting), then the summary-and-notes calls (two)."""
    speakers = [(g[0], o[0]) for groups, outs in calls if len(groups[0]) == 1
                for g, o in zip(groups, outs)]
    joint = [(g, o) for groups, outs in calls if len(groups[0]) == 2
             for g, o in zip(groups, outs)]
    if len(speakers) != len(joint):
        raise RuntimeError(f"{len(speakers)} speaker rows for {len(joint)} write-ups")
    return [{"speakers": s, "summary": (g[0], o[0]), "notes": (g[1], o[1])}
            for s, (g, o) in zip(speakers, joint)]
