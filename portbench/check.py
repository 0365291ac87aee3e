"""What decides ``correct``: the program's transcripts held to the plain
reference (``portbench/reference``).

For each transcript judged, the reference trims the recording, cuts its
windows, computes the log-mel, the encoder states, the language vote and
each window's int4 cross cache in float32, and runs the decoder along the
tokens the program served (``reference.rules``).  Three numbers result:

- ``max_logit_gap``: the widest gap by which a served token (or the
  voted language) lies below the best the decoding rules allow;
- ``windows_mismatched``: windows the program decoded other than those
  the trim and the seek rewind give (grid windows out of order or
  missing, seek-repair windows too many or too few);
- ``segments_mismatched``: segments whose start or end differ from those
  the served tokens give on the original timeline, plus the difference
  in their count.

With ``control`` the same rows are also run at float8 (the control): at
each position the token the control puts first is read in the float32
reference, and the widest such gap is ``control_logit_gap``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .reference import rules
from .reference import transcript as tx
from .reference import whisper as ref
from .tokenizer import WordTokenizer

BLOCK = 8


def decode_log(log: list) -> tuple[list, list]:
    """The program's call log -> (decode calls, languages voted).  Each
    call is (the (file, window) pair of each row, or None for a
    seek-repair slab; the slab's rows; its tokens; its language).  A
    decode reads the slab of the encode (or of the gather of banked
    encoder rows) before it; that slab was cut from the grid when a grid
    record precedes it."""
    calls, langs = [], []
    last_grid, encoded = None, None
    for entry in log:
        kind = entry[0]
        if kind == "grid":
            last_grid = entry[1]
        elif kind in ("encode", "gather"):
            encoded = (last_grid, entry[1])
            last_grid = None
        elif kind == "lang":
            langs.append([entry[1]])
        elif kind == "langs":
            langs.append(list(entry[1]))
        elif kind == "decode":
            pairs, rows = encoded
            calls.append((None if pairs is None else [tuple(p) for p in pairs], rows,
                          entry[1].tokens.cpu().numpy(), entry[2]))
    return calls, (langs[0] if langs else [])


def served(row: np.ndarray, eot: int, cap: int) -> list[int]:
    """A row's sampled tokens, through the first EOT."""
    out = []
    for t in row[:cap]:
        out.append(int(t))
        if int(t) == eot:
            break
    return out


class Judge:
    """Reference runs of one configuration's weights."""

    def __init__(self, params: dict, cfg: dict, control: bool = False):
        ref.full_fp32()
        self.params, self.cfg, self.control = params, cfg, control
        self.st = ref.special_tokens(cfg["vocab_size"])
        self.dev = params["decoder"]["token_emb"].device
        self.suppress = torch.zeros(cfg["vocab_size"], dtype=torch.bool, device=self.dev)
        self.tok = WordTokenizer(self.st["eot"])
        self.suppress[ref.suppressed_ids(self.st, self.tok.encode)] = True
        self.space = self.tok.encode(" ")[0]
        self.cap = cfg["max_new_tokens"]
        self._silent_rows: dict = {}

    def sot(self, lang: int) -> list[int]:
        st = self.st
        return [st["sot"], st["lang_begin"] + int(lang), st["transcribe"]]

    @torch.no_grad()
    def encode(self, windows: np.ndarray, prec: ref.Precision) -> torch.Tensor:
        audio = torch.from_numpy(windows).to(self.dev).float() / 32768.0
        return ref.encode(self.params, self.cfg, ref.log_mel(audio, self.cfg["num_mel_bins"]),
                          prec)

    @torch.no_grad()
    def rows(self, windows: np.ndarray, token_rows: list[list[int]], lang: int) -> dict:
        """Gaps of the served rows over their windows, block by block:
        {"gap": widest gap, "nsp": no-speech probability of each row,
        "control": the control's widest gap}."""
        out = {"gap": 0.0, "nsp": [], "avg_logprob": [], "control": 0.0,
               "gap_sum": 0.0, "control_sum": 0.0, "n": 0}
        precs = [ref.Precision("f32")] + ([ref.Precision("fp8")] if self.control else [])
        for lo in range(0, len(token_rows), BLOCK):
            blk = token_rows[lo:lo + BLOCK]
            width = max(len(r) for r in blk)
            prompt = torch.full((len(blk), 3 + width - 1), self.st["eot"], dtype=torch.long,
                                device=self.dev)
            for j, r in enumerate(blk):
                prompt[j, :3] = torch.tensor(self.sot(lang))
                prompt[j, 3:3 + len(r) - 1] = torch.tensor(r[:-1])
            logits = []
            for prec in precs:
                states = self.encode(windows[lo:lo + BLOCK], prec)
                kv = ref.cross_kv(self.params, self.cfg, states, prec, int4=True)
                logits.append(ref.decode_logits(self.params, self.cfg, prompt, kv, prec))
                del states, kv
            for j, r in enumerate(blk):
                out["nsp"].append(float(torch.softmax(logits[0][j, 0], -1)[self.st["no_speech"]]))
                allowed = rules.allowed_logits(logits[0][j, 2:2 + len(r)], r, self.st,
                                               self.suppress, self.space)
                gaps = rules.token_gaps(allowed, r, self.st)
                out["gap"] = max(out["gap"], float(gaps.max()))
                out["gap_sum"] += float(gaps.sum())
                out["n"] += len(r)
                out["avg_logprob"].append(rules.avg_logprob(allowed, r, self.st))
                if self.control:
                    low = rules.allowed_logits(logits[1][j, 2:2 + len(r)], r, self.st,
                                               self.suppress, self.space)
                    picks = rules.first_choices(low, self.st).tolist()
                    gaps = rules.token_gaps(allowed, picks, self.st)
                    out["control"] = max(out["control"], float(gaps.max()))
                    out["control_sum"] += float(gaps.sum())
            del logits
        return out

    @torch.no_grad()
    def language(self, windows: np.ndarray, chosen: int) -> tuple[float, float]:
        """(gap of the chosen language, gap of the control's choice): the
        log of the best mean probability over the voters minus the
        chosen one's."""
        def mean_probs(kind):
            prec = ref.Precision(kind)
            states = self.encode(windows, prec)
            return ref.language_probs(self.params, self.cfg, states, self.st, prec).double().mean(0)

        p = mean_probs("f32")
        best = torch.log(p.max())
        ctrl = float(best - torch.log(p[int(mean_probs("fp8").argmax())])) if self.control else 0.0
        return float(best - torch.log(p[chosen])), ctrl

    def transcript(self, audio: np.ndarray, log: list, result: dict) -> dict:
        """The numbers of one ``transcribe`` call."""
        calls, langs = decode_log(log)
        return self.files([audio], calls, langs, {0: result["segments"]})

    def files(self, audios: list, calls: list, langs: list, judged: dict) -> dict:
        """The numbers of the files ``judged`` ({file: its segments as the
        program answered}) of one call that decoded ``audios`` through
        ``calls``.  Seek-repair slabs follow the grid slabs, file by file;
        a file's count of them follows from its grid tokens (ungated for
        the files not judged: the no-speech gate never fires on them
        unless their no-speech probability passes 0.6)."""
        st, eot = self.st, self.st["eot"]
        nums = {"max_logit_gap": 0.0, "windows_mismatched": 0, "segments_mismatched": 0,
                "control_logit_gap": 0.0, "mean_logit_gap": 0.0, "control_mean_gap": 0.0,
                "positions": 0}
        self._silent_rows = {}
        self._sums = [0.0, 0.0, 0]
        trims = [tx.trim(np.asarray(a, np.float32)) for a in audios]
        grid = [[] for _ in audios]
        for pairs, _, toks, lang in calls:
            for j, (f, c) in enumerate(pairs or []):
                grid[f].append((c, served(toks[j], eot, self.cap), lang))
        patch_calls = [(rows, toks, lang) for pairs, rows, toks, lang in calls if pairs is None]
        if len(langs) != len(audios):
            nums["windows_mismatched"] += 1
            return nums
        for f, (trimmed, _) in enumerate(trims):
            n = tx.n_windows(trimmed)
            got = [c for c, _, _ in grid[f]]
            nums["windows_mismatched"] += int(got != list(range(n)))
            grid[f].sort(key=lambda r: r[0])
        for f in sorted(judged):
            self._judge_grid(f, trims[f][0], grid[f], langs[f], nums)
        for f, (trimmed, intervals) in enumerate(trims):
            n, content_s = tx.n_windows(trimmed), len(trimmed) / tx.SR
            tokens = np.full((n, self.cap), eot, np.int64)
            for c, row, _ in grid[f]:
                if c < n and not (f in judged and self._silent_rows.get((f, c), False)):
                    tokens[c, :len(row)] = row
            bounds = []
            for i in range(n):
                cons, rewound = tx.consumed(tokens[i], st)
                if not (rewound and 1.0 <= cons <= 29.0):
                    continue
                if i == n - 1 and i * 30.0 + cons >= content_s - 0.2:
                    continue
                bounds.append((i, cons))
            patch_rows, left = [], len(bounds)
            while left and patch_calls:
                rows, toks, lang = patch_calls.pop(0)
                real = min(rows, left)
                nums["windows_mismatched"] += int(lang != langs[f])
                patch_rows += [served(toks[j], eot, self.cap) for j in range(real)]
                left -= real
            nums["windows_mismatched"] += left
            if f not in judged:
                continue
            kept_rows, kept_off, kept_dur = [], [], []
            if bounds and not left:
                starts = [i * tx.WINDOW + int(round(cons * tx.SR)) for i, cons in bounds]
                silent = self._judge(np.stack([tx.window(trimmed, s0) for s0 in starts]),
                                     patch_rows, langs[f], nums)
                for j, (i, cons) in enumerate(bounds):
                    row = np.full(self.cap, eot, np.int64)
                    if not silent[j]:
                        row[:len(patch_rows[j])] = patch_rows[j]
                    offset = i * 30.0 + cons
                    cut, last_end = tx.keep_pairs_starting_before(
                        row, st, 30.0 - cons if i + 1 < n else 30.0)
                    if last_end is None:
                        if any(int(t) < eot for t in row):
                            cut, last_end = row.copy(), min(30.0, max(content_s - offset, 0.02))
                        else:
                            tokens[i] = tx.truncate_after_last_pair(tokens[i], st)
                            continue
                    tokens[i] = tx.truncate_after_last_pair(tokens[i], st)
                    end = offset + last_end
                    if i + 1 < n and end > (i + 1) * 30.0 + 0.1:
                        tokens[i + 1] = tx.drop_segments_before(tokens[i + 1], st,
                                                                end - (i + 1) * 30.0)
                    kept_rows.append(cut)
                    kept_off.append(offset)
                    kept_dur.append(min(30.0, max(content_s - offset, 0.02)))
            offsets = list(np.arange(n) * 30.0) + kept_off
            durations = list(np.clip(content_s - np.arange(n) * 30.0, 0.0, 30.0)) + kept_dur
            want = tx.segments(list(tokens) + kept_rows, offsets, durations, st, self.tok.decode)
            want.sort(key=lambda s: (s["start"], s["end"]))
            tmap = tx.TimeMap(intervals)
            want = [(round(tmap.to_original(s["start"]), 3), round(tmap.to_original(s["end"]), 3))
                    for s in want]
            got = [(s["start"], s["end"]) for s in judged[f]]
            nums["segments_mismatched"] += abs(len(want) - len(got)) + sum(
                not (math.isclose(a[0], b[0], abs_tol=1e-9) and math.isclose(a[1], b[1], abs_tol=1e-9))
                for a, b in zip(want, got))
        n = max(self._sums[2], 1)
        nums["mean_logit_gap"] = self._sums[0] / n
        nums["control_mean_gap"] = self._sums[1] / n
        nums["positions"] = self._sums[2]
        return nums

    def _judge(self, windows, rows, lang, nums) -> list[bool]:
        """Gaps of rows decoded from windows under lang, into nums; returns
        the reference's no-speech verdict of each row."""
        r = self.rows(windows, rows, lang)
        nums["max_logit_gap"] = max(nums["max_logit_gap"], r["gap"])
        nums["control_logit_gap"] = max(nums["control_logit_gap"], r["control"])
        self._sums[0] += r["gap_sum"]
        self._sums[1] += r["control_sum"]
        self._sums[2] += r["n"]
        return [self.silent(p, lp) for p, lp in zip(r["nsp"], r["avg_logprob"])]

    def _judge_grid(self, f, trimmed, rows, lang, nums) -> None:
        """The judged file's language vote and grid rows."""
        if not rows:
            return
        voters = tx.voting_rows(trimmed, tx.n_windows(trimmed))
        g, c = self.language(np.stack([tx.window(trimmed, v * tx.WINDOW) for v in voters]), lang)
        nums["max_logit_gap"] = max(nums["max_logit_gap"], g)
        nums["control_logit_gap"] = max(nums["control_logit_gap"], c)
        for _, _, call_lang in rows:
            nums["windows_mismatched"] += int(call_lang != lang)
        silent = self._judge(np.stack([tx.window(trimmed, c * tx.WINDOW) for c, _, _ in rows]),
                             [r for _, r, _ in rows], lang, nums)
        for (c, _, _), s in zip(rows, silent):
            self._silent_rows[(f, c)] = s

    @staticmethod
    def silent(nsp: float, avg_logprob: float) -> bool:
        """openai's no-speech skip, on the reference's probabilities: the
        no-speech probability above 0.6 and the decode not confident
        (average log-probability not above -1)."""
        return nsp > 0.6 and not avg_logprob > -1.0
