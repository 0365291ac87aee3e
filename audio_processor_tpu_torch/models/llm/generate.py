"""Greedy generation for the language models (DeepSeek-V2, Kimi-Linear)
over their caches, with the decode step captured as a CUDA graph.

``Engine.generate`` takes groups of prompts: the rows of a group share the
longest prefix their prompts have in common (a transcript asked for a
summary and for notes), which is prefilled once, in chunks of at most
``CHUNK_TOKENS`` tokens packed across groups, into the group's prefix
cache.  Each row then prefills the rest of its prompt into a cache of its
own (the absorbed form, a few tokens) and decodes greedily to its cap or
EOS.  A model with KDA layers (Kimi-Linear) keeps two kinds of state side
by side: latent caches for its MLA layers only, and for its KDA layers a
fixed state and convolution window a sequence (``kda.States``): a
group's, carried across the prefix's chunks, then copied into each of its
rows (the fork) before the row's own prompt; the rows' states are updated
in place by every step.

The rows of one call share a *session*: fixed-capacity caches (the
prefix's rounded up to ``CACHE_BLOCK`` tokens, the rows' to
``SUFFIX_BLOCK``), the step's inputs and outputs as device tensors, and on
the card the step captured once as a CUDA graph.  A step reads every row's
state from the device and writes it back there (next token, lengths,
finished flags), so the host only replays the graph; it reads the
finished flags every ``READBACK_EVERY`` steps (``llm.decode.wait``) and
the tokens once at the end.  Sessions are kept by (groups, rows a group,
capacities) for the calls that follow, the least recently used dropped
past ``MAX_BUFFERS`` prefix caches.

Spans and counters (``runtime/trace.py``): ``llm.prefill`` (ends when the
first tokens are on the device), ``llm.decode``, ``llm.decode.step`` and
``llm.decode.wait``; ``llm.prefill_tokens``, ``llm.decode.steps``,
``llm.decode.rows`` (rows a call decodes), ``llm.moe.experts_touched``
(the distinct experts each MoE layer read at each step, summed on the
device), ``llm.decode.cache_tokens`` (the valid latent tokens the steps
had to read: a group's prefix once a step while any of its rows decodes,
and each decoding row's own tokens) and, on the card,
``llm.decode.card_us`` (the steps' time on the card, from CUDA events).
With KDA layers also the span ``llm.prefill.fork`` and the counters
``llm.kda.prefill_tokens`` (tokens through the chunked form, once a token),
``llm.kda.forks`` (rows given their group's state) and
``llm.kda.state_bytes`` (the KDA states and windows the steps read and
wrote, summed on the device over the active rows, added once a call).
"""
from __future__ import annotations

import logging
import threading
from collections import OrderedDict

import torch

from ...runtime import trace
from . import kda
from . import model as M
from .config import DeepseekV2Config

logger = logging.getLogger(__name__)

CHUNK_TOKENS = 8192    # prefill tokens a chunk at most
CACHE_BLOCK = 2048     # the prefix caches' capacities are multiples of this
SUFFIX_BLOCK = 256     # and the rows' of this
READBACK_EVERY = 16    # decode steps between reads of the finished flags
MAX_BUFFERS = 4        # prefix caches (and their sessions) kept between calls
ATTN_BLOCK_BYTES = 1 << 29  # the rows' prompt prefill attends this many score bytes at a time


def _round_up(n: int, block: int) -> int:
    return max(block, -(-n // block) * block)


def _common_prefix(rows: list[list[int]]) -> int:
    n = min(len(r) for r in rows)
    for i in range(n):
        t = rows[0][i]
        if any(r[i] != t for r in rows[1:]):
            return i
    return n


def _chunks(lengths: list[int], limit: int):
    """Pieces (group, start, end) of sequences of these lengths, packed in
    order into chunks of at most ``limit`` tokens."""
    chunk, size = [], 0
    for g, n in enumerate(lengths):
        a = 0
        while a < n:
            b = min(n, a + limit - size)
            chunk.append((g, a, b))
            size += b - a
            a = b
            if size == limit:
                yield chunk
                chunk, size = [], 0
    if chunk:
        yield chunk


class _Session:
    """The state of G groups of K rows at fixed capacities: the groups'
    prefix caches ``pc`` and KDA ``prefix_states`` (shared by the sessions
    of one prefix buffer), the rows' own caches and states."""

    def __init__(self, engine: "Engine", pc: torch.Tensor, prefix_states, K: int, cap_s: int):
        cfg, dev = engine.cfg, engine.device
        G = pc.shape[1]
        R = G * K
        self.engine, self.pc, self.G, self.K, self.R = engine, pc, G, K, R
        self.prefix_states = prefix_states
        self.states = (kda.States.zeros(cfg, R, pc.dtype, dev) if prefix_states is not None
                       else None)
        self.sc = pc.new_zeros(cfg.mla_layers, R, cap_s, cfg.latent_dim)
        self.plen = torch.zeros(G, dtype=torch.long, device=dev)
        self.tok = torch.zeros(R, dtype=torch.long, device=dev)
        self.slen = torch.zeros(R, dtype=torch.long, device=dev)
        self.gen = torch.zeros(R, dtype=torch.long, device=dev)
        self.cap = torch.zeros(R, dtype=torch.long, device=dev)
        self.active = torch.zeros(R, dtype=torch.bool, device=dev)
        self.out = torch.zeros(R, cap_s, dtype=torch.long, device=dev)
        self.touched = torch.zeros((), dtype=torch.long, device=dev)
        self.kda_bytes = torch.zeros((), dtype=torch.long, device=dev)
        self._rows = torch.arange(R, device=dev)
        self.graph = None
        if engine.graphs:
            self._capture()

    def _state(self):
        state = (self.tok, self.slen, self.gen, self.cap, self.active, self.out, self.touched)
        return state if self.states is None else state + (self.kda_bytes,)

    def fork(self) -> None:
        """Each row's KDA state and windows from its group's."""
        K, p = self.K, self.prefix_states
        self.states.state.copy_(p.state.repeat_interleave(K, dim=1))
        self.states.win.copy_(p.win.repeat_interleave(K, dim=1))

    def step(self) -> None:
        """One greedy step of every row, all on the device (eager)."""
        e = self.engine
        if self.states is not None:
            self.kda_bytes.add_(self.active.sum() * (2 * self.states.row_bytes()))
        h, touched = M.forward_rows(e.params, e.cfg, self.tok[:, None], self.active[:, None],
                                    self.pc, self.plen, self.sc, self.slen, e.inv_freq,
                                    states=self.states, mesh=e.mesh)
        nxt = M.logits(e.params, e.cfg, h[:, 0]).argmax(-1)
        act = self.active
        at = self.gen.clamp(max=self.out.shape[1] - 1)
        self.out[self._rows, at] = torch.where(act, nxt, self.out[self._rows, at])
        self.tok.copy_(torch.where(act, nxt, self.tok))
        self.slen.add_(act.long())
        self.gen.add_(act.long())
        self.active.copy_(act & (nxt != e.cfg.eos_token_id) & (self.gen < self.cap))
        if touched:
            self.touched.add_(torch.stack(touched).sum())

    def _capture(self) -> None:
        """Capture ``step`` once; a warm-up step first, on a side stream,
        with the state put back after it (its cache writes land where the
        rows' prompts will be written, its KDA writes where the fork will
        copy)."""
        saved = [t.clone() for t in self._state()]
        side = torch.cuda.Stream(self.engine.device)
        side.wait_stream(torch.cuda.current_stream(self.engine.device))
        with torch.cuda.stream(side):
            self.step()
        torch.cuda.current_stream(self.engine.device).wait_stream(side)
        for t, s in zip(self._state(), saved):
            t.copy_(s)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.step()

    def run_step(self) -> None:
        if self.graph is not None:
            self.graph.replay()
        else:
            self.step()


class Engine:
    """Greedy generation with one model's weights on one device."""

    def __init__(self, params: dict, cfg: DeepseekV2Config, device, mesh=None):
        """``mesh``: the (data, model) mesh whose model group shares the
        routed experts (``cfg.expert_range`` is this rank's share); every
        rank of the group runs the same calls."""
        self.params, self.cfg, self.device, self.mesh = params, cfg, torch.device(device), mesh
        e0, e1 = cfg.expert_range
        if (e0, e1) != (0, cfg.n_routed_experts) and (mesh is None or mesh.tp == 1):
            logger.warning(
                "%s holds experts %d-%d of each layer's %d and no mesh holds the others: "
                "a token's picks among them add nothing, so this one card computes only its "
                "share of the model", cfg.name, e0, e1 - 1, cfg.n_routed_experts)
        self.graphs = self.device.type == "cuda"
        self.inv_freq = M.yarn_inv_freq(cfg).to(self.device) if cfg.rope else None
        self.dtype = params["embed"].dtype
        # (G, prefix capacity) -> (prefix cache, the groups' KDA states or None)
        self._buffers: OrderedDict = OrderedDict()
        self._sessions: OrderedDict = OrderedDict()  # (G, K, prefix cap, suffix cap) -> _Session
        self._lock = threading.Lock()

    def _session(self, G: int, K: int, cap_p: int, cap_s: int) -> _Session:
        key = (G, K, cap_p, cap_s)
        if key in self._sessions:
            self._sessions.move_to_end(key)
            self._buffers.move_to_end((G, cap_p))
            return self._sessions[key]
        if (G, cap_p) not in self._buffers:
            while len(self._buffers) >= MAX_BUFFERS:
                old, _ = self._buffers.popitem(last=False)
                for k in [k for k in self._sessions if (k[0], k[2]) == old]:
                    del self._sessions[k]
            self._buffers[(G, cap_p)] = (
                torch.zeros(self.cfg.mla_layers, G, cap_p, self.cfg.latent_dim, dtype=self.dtype,
                            device=self.device),
                kda.States.zeros(self.cfg, G, self.dtype, self.device)
                if self.cfg.kda_layers else None)
        sess = self._sessions[key] = _Session(self, *self._buffers[(G, cap_p)], K, cap_s)
        return sess

    def generate(self, groups: list[list[list[int]]], caps: list[list[int]]) -> list:
        """Greedy continuations of ``groups[g][k]`` (token ids), each of at
        most ``caps[g][k]`` new tokens, through EOS.  Every group has the
        same number of rows."""
        K = len(groups[0])
        if any(len(g) != K for g in groups) or any(len(c) != K for c in caps):
            raise ValueError("every group needs the same number of rows and caps")
        if any(len(p) < 1 for g in groups for p in g) or any(c < 1 for cs in caps for c in cs):
            raise ValueError("every row needs a prompt and a cap of at least one token")
        with self._lock, torch.inference_mode():
            return self._generate(groups, caps)

    def _generate(self, groups, caps) -> list:
        G, K = len(groups), len(groups[0])
        plens = [min(_common_prefix(g), min(len(p) for p in g) - 1) for g in groups]
        rows = [p[n:] for g, n in zip(groups, plens) for p in g]
        flat_caps = [c for cs in caps for c in cs]
        cap_p = _round_up(max(plens), CACHE_BLOCK)
        cap_s = _round_up(max(len(r) + c for r, c in zip(rows, flat_caps)), SUFFIX_BLOCK)
        need = max(len(p) + c for g, cs in zip(groups, caps) for p, c in zip(g, cs))
        if need > self.cfg.max_position_embeddings:
            raise ValueError(f"a row needs {need} positions, more than the model's "
                             f"{self.cfg.max_position_embeddings}")
        sess = self._session(G, K, cap_p, cap_s)
        trace.count("llm.decode.rows", G * K)
        with trace.span("llm.prefill"):
            trace.count("llm.prefill_tokens", sum(plens) + sum(len(r) for r in rows))
            self._prefill_prefixes(sess, groups, plens)
            if sess.states is not None:
                with trace.span("llm.prefill.fork"):
                    sess.fork()
                trace.count("llm.kda.forks", G * K)
                scanned = sum(plens) + (sum(len(r) for r in rows) if max(map(len, rows)) > 1
                                        else 0)
                trace.count("llm.kda.prefill_tokens", scanned)
            self._prefill_rows(sess, rows, plens, flat_caps)
            live = bool(sess.active.any())  # the prefill's one read-back
        steps = self._decode(sess, max(flat_caps) - 1) if live else 0
        out, gen = sess.out.cpu(), sess.gen.cpu()
        if steps:
            trace.count("llm.moe.experts_touched", int(sess.touched))
            if sess.states is not None:
                trace.count("llm.kda.state_bytes", int(sess.kda_bytes))
            n = gen.tolist()
            tokens = sum((n[r] - 1) * len(rows[r]) + (n[r] - 1) * n[r] // 2 for r in range(G * K))
            tokens += sum(plens[g] * (max(n[g * K:(g + 1) * K]) - 1) for g in range(G))
            trace.count("llm.decode.cache_tokens", tokens)
        res = [out[r, :int(gen[r])].tolist() for r in range(G * K)]
        return [res[g * K:(g + 1) * K] for g in range(G)]

    def _prefill_prefixes(self, sess: _Session, groups, plens) -> None:
        """The groups' shared prefixes into the prefix cache, in chunks of
        at most ``CHUNK_TOKENS`` tokens that pack segments of groups; the
        groups' KDA states start from zero."""
        if sess.prefix_states is not None:
            sess.prefix_states.state.zero_()
            sess.prefix_states.win.zero_()
        for chunk in _chunks(plens, CHUNK_TOKENS):
            ids, segs, s = [], [], 0
            for g, a, b in chunk:
                ids += groups[g][0][a:b]
                segs.append((g, a, s, s + b - a))
                s += b - a
            M.prefill_chunk(self.params, self.cfg, sess.pc,
                            torch.tensor(ids, dtype=torch.long, device=self.device), segs,
                            self.inv_freq, states=sess.prefix_states, mesh=self.mesh)

    def _prefill_rows(self, sess: _Session, rows, plens, caps) -> None:
        """Each row's own prompt after its group's prefix (absorbed form),
        and its first token: the session's state for the decode."""
        R, dev = sess.R, self.device
        S = max(len(r) for r in rows)
        tok = torch.zeros(R, S, dtype=torch.long)
        for r, ids in enumerate(rows):
            tok[r, :len(ids)] = torch.tensor(ids)
        n = torch.tensor([len(r) for r in rows])
        tok, n = tok.to(dev), n.to(dev)
        valid = torch.arange(S, device=dev)[None, :] < n[:, None]
        sess.plen.copy_(torch.tensor(plens))
        sess.slen.zero_()
        cap_all = sess.pc.shape[2] + sess.sc.shape[2]
        per_group = sess.K * S * self.cfg.num_attention_heads * cap_all * 8
        h, _ = M.forward_rows(self.params, self.cfg, tok, valid, sess.pc, sess.plen, sess.sc,
                              sess.slen, self.inv_freq,
                              group_block=max(1, ATTN_BLOCK_BYTES // per_group),
                              states=sess.states, lengths=[len(r) for r in rows], mesh=self.mesh)
        first = M.logits(self.params, self.cfg, h[sess._rows, n - 1]).argmax(-1)
        sess.tok.copy_(first)
        sess.slen.copy_(n)
        sess.gen.fill_(1)
        sess.cap.copy_(torch.tensor(caps))
        sess.out.zero_()
        sess.out[:, 0] = first
        sess.active.copy_((first != self.cfg.eos_token_id) & (sess.cap > 1))
        sess.touched.zero_()
        if sess.states is not None:
            sess.kda_bytes.zero_()

    def _decode(self, sess: _Session, max_steps: int) -> int:
        """Steps until every row is done; returns the steps run."""
        timed = self.device.type == "cuda"
        if timed:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        steps = 0
        with trace.span("llm.decode"):
            if timed:
                ev[0].record()
            while steps < max_steps:
                with trace.span("llm.decode.step"):
                    sess.run_step()
                    steps += 1
                    trace.count("llm.decode.steps")
                    if steps % READBACK_EVERY == 0 or steps == max_steps:
                        with trace.span("llm.decode.wait"):
                            if not bool(sess.active.any()):
                                break
            if timed:
                ev[1].record()
                ev[1].synchronize()
                trace.count("llm.decode.card_us", int(1000 * ev[0].elapsed_time(ev[1])))
        return steps
