"""Kimi Delta Attention's two sequential kernels (Triton), with their plain
versions.

KDA keeps, for each sequence and head, a float32 state S (K x V) that
every token decays channel by channel and corrects by a delta rule
(``models/llm/kda.py`` has the equations).  Both kernels replace no TPU
kernel: the JAX package has no language model; they were added with
Kimi-Linear, whose KDA layers need a pass along the sequence that no
batched product expresses.

* ``kda_chunk_state`` (prefill): the pass over a segment's chunks of 64
  tokens.  What is parallel across chunks (the pairwise decays, the
  triangular solve, the products inside a chunk) is batched PyTorch
  before it; each chunk n hands the kernel W_k, W_v (the solved system),
  Q~ (the decayed queries), P (the chunk's query-key decays), K^ (the keys
  decayed to the chunk's end) and Gamma (the chunk's whole decay).  One
  program holds one (segment, head, 32-column block) of the state in
  registers across the segment's chunks:

      U = W_v - W_k S;   O = Q~ S + P U;   S = Gamma * S + K^^T U

  The state's columns are independent, so the column blocks split a
  head four ways for parallelism; segments of several sequences packed in
  one prefill chunk each read and write their own state.  The chunk loop
  is not pipelined (one stage): the five tiles of a chunk and the float32
  products' operands already take most of a block's shared memory.  Bound: the
  bytes of its inputs (five float32 tiles a chunk, about 2.8 KB a token
  and head) at the card's 3.35 TB/s; its products (115 kFLOP a token and
  head, in float32: ``input_precision="ieee"``, since the state is exact
  float32) are far below the tensor cores' rate.

* ``kda_step`` (decode): one token of every row and head, in place on the
  row's state:

      S = exp(g) * S;   u = beta (v - S^T k);   S = S + k u^T;   o = S^T q

  Bound: the state's bytes, read and written once (128 KB a row and head
  a layer).  A program holds a (row, head, 32-column block) and skips
  rows that are not active: finished rows touch no state.

Each wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors; ``launches`` counts the kernel's launches.
Triton is imported where a kernel is built, never at import.
"""
from __future__ import annotations

import functools

import torch

CHUNK = 64  # tokens a chunk of the prefill's pass
BV = 32  # state columns a program holds (all of them where V is smaller)

launches = {"kda_chunk_state": 0, "kda_step": 0}


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def kda_chunk_state_reference(wk, wv, qt, kh, p, gam, first, end, slot, state):
    """The chunks' outputs O (N, H, C, V), and each segment's state
    carried through its chunks [first, end) into ``state[slot]`` (in place)."""
    out = torch.zeros_like(wv)
    for s0, s1, sl in zip(first.tolist(), end.tolist(), slot.tolist()):
        S = state[sl]
        for n in range(s0, s1):
            u = wv[n] - wk[n] @ S
            out[n] = qt[n] @ S + p[n] @ u
            S = gam[n][..., None] * S + kh[n].transpose(-1, -2) @ u
        state[sl] = S
    return out


def kda_step_reference(q, k, v, g, beta, active, state):
    """One token of every row (R, H, .) on ``state`` (R, H, K, V), in place
    for the active rows; the output (R, H, V), zero for the others."""
    S = state * g.exp()[..., None]
    kv = (k[..., None] * S).sum(-2)
    S = S + k[..., None] * (beta[..., None] * (v - kv))[..., None, :]
    o = (q[..., None] * S).sum(-2)
    act = active.view(-1, 1, 1)
    state.copy_(torch.where(act[..., None], S, state))
    return torch.where(act, o, torch.zeros_like(o))


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _kernels():
    import triton
    import triton.language as tl

    @triton.jit
    def kda_chunk_state(wk_ptr, wv_ptr, qt_ptr, kh_ptr, p_ptr, gam_ptr, o_ptr, state_ptr,
                        first_ptr, end_ptr, slot_ptr, H: tl.constexpr, C: tl.constexpr,
                        K: tl.constexpr, V: tl.constexpr, BV: tl.constexpr):
        seg = tl.program_id(0)
        h = tl.program_id(1)
        rv = tl.program_id(2) * BV + tl.arange(0, BV)
        rc = tl.arange(0, C)
        rk = tl.arange(0, K)
        n0 = tl.load(first_ptr + seg)
        n1 = tl.load(end_ptr + seg)
        slot = tl.load(slot_ptr + seg).to(tl.int64)
        s_ptrs = state_ptr + ((slot * H + h) * K + rk[:, None]) * V + rv[None, :]
        S = tl.load(s_ptrs)
        for n in range(n0, n1):
            base = n.to(tl.int64) * H + h
            tile_k = (base * C + rc[:, None]) * K + rk[None, :]
            tile_v = (base * C + rc[:, None]) * V + rv[None, :]
            u = tl.load(wv_ptr + tile_v) - tl.dot(tl.load(wk_ptr + tile_k), S,
                                                  input_precision="ieee")
            o = tl.dot(tl.load(qt_ptr + tile_k), S, input_precision="ieee")
            p = tl.load(p_ptr + (base * C + rc[:, None]) * C + rc[None, :])
            o += tl.dot(p, u, input_precision="ieee")
            tl.store(o_ptr + tile_v, o)
            gam = tl.load(gam_ptr + base * K + rk)
            S = S * gam[:, None] + tl.dot(tl.trans(tl.load(kh_ptr + tile_k)), u,
                                          input_precision="ieee")
        tl.store(s_ptrs, S)

    @triton.jit
    def kda_step(q_ptr, k_ptr, v_ptr, g_ptr, beta_ptr, active_ptr, state_ptr, o_ptr,
                 H: tl.constexpr, K: tl.constexpr, V: tl.constexpr, BV: tl.constexpr):
        row = tl.program_id(0)
        h = tl.program_id(1)
        rv = tl.program_id(2) * BV + tl.arange(0, BV)
        rk = tl.arange(0, K)
        base = row.to(tl.int64) * H + h
        if tl.load(active_ptr + row) == 0:
            tl.store(o_ptr + base * V + rv, tl.zeros((BV,), tl.float32))
            return
        s_ptrs = state_ptr + (base * K + rk[:, None]) * V + rv[None, :]
        S = tl.load(s_ptrs) * tl.exp(tl.load(g_ptr + base * K + rk))[:, None]
        k = tl.load(k_ptr + base * K + rk)
        kv = tl.sum(k[:, None] * S, axis=0)
        u = tl.load(beta_ptr + base) * (tl.load(v_ptr + base * V + rv) - kv)
        S += k[:, None] * u[None, :]
        tl.store(s_ptrs, S)
        q = tl.load(q_ptr + base * K + rk)
        tl.store(o_ptr + base * V + rv, tl.sum(q[:, None] * S, axis=0))

    return kda_chunk_state, kda_step


def _check(name, *ts):
    for t in ts:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous float32 tensors, got {t.dtype}")


def kda_chunk_state(wk, wv, qt, kh, p, gam, first, end, slot, state):
    """See the module's note.  wk, qt, kh (N, H, C, K), wv (N, H, C, V), p
    (N, H, C, C), gam (N, H, K), float32; first, end, slot (segments,)
    int32; state (slots, H, K, V) float32, updated in place.  Returns O."""
    if wk.device.type != "cuda":
        return kda_chunk_state_reference(wk, wv, qt, kh, p, gam, first, end, slot, state)
    _check("kda_chunk_state", wk, wv, qt, kh, p, gam, state)
    N, H, C, K = wk.shape
    V = wv.shape[-1]
    bv = min(BV, V)
    if C != CHUNK or V % bv or state.shape[1:] != (H, K, V):
        raise ValueError(f"kda_chunk_state: chunks of {C}, V {V}, state {tuple(state.shape)}")
    out = torch.empty_like(wv)
    kernel, _ = _kernels()
    kernel[(first.shape[0], H, V // bv)](wk, wv, qt, kh, p, gam, out, state, first, end, slot,
                                         H=H, C=C, K=K, V=V, BV=bv, num_warps=8, num_stages=1)
    launches["kda_chunk_state"] += 1
    return out


def kda_step(q, k, v, g, beta, active, state):
    """See the module's note.  q, k, g (R, H, K), v (R, H, V), beta (R, H),
    float32; active (R,) bool; state (R, H, K, V) float32, in place.
    Returns o (R, H, V)."""
    if q.device.type != "cuda":
        return kda_step_reference(q, k, v, g, beta, active, state)
    _check("kda_step", q, k, v, g, beta, state)
    R, H, K = q.shape
    V = v.shape[-1]
    bv = min(BV, V)
    if V % bv or state.shape != (R, H, K, V):
        raise ValueError(f"kda_step: V {V}, state {tuple(state.shape)} for {R} rows")
    out = torch.empty_like(v)
    _, kernel = _kernels()
    kernel[(R, H, V // bv)](q, k, v, g, beta, active.view(torch.uint8), state, out, H=H, K=K,
                            V=V, BV=bv, num_warps=4)
    launches["kda_step"] += 1
    return out
