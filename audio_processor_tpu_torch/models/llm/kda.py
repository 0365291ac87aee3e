"""Kimi Delta Attention (KDA), the linear attention of Kimi-Linear's
layers, over sequences whose state is carried between calls.

The equations are ``modeling_kimi.py``'s ``KimiDeltaAttention`` (with
``fla``'s ``chunk_kda`` / ``fused_recurrent_kda``), for each head of 128
key and value channels:

1. q, k, v = SiLU(causal depthwise convolution of width 4 (W_q x, W_k x,
   W_v x)); q and k are L2-normalised, q scaled by 1/sqrt(128);
2. the per-channel log-decay g = -exp(A_log[h]) softplus(f_b(f_a(x)) +
   dt_bias), and beta = sigmoid(W_b x), one a head;
3. the state S (K x V, float32): S_t = Diag(e^g_t) S_{t-1} + k_t u_t^T
   with u_t = beta_t (v_t - (Diag(e^g_t) S_{t-1})^T k_t), and o_t = S_t^T q_t;
4. o = RMSNorm(o) w sigmoid(g_b(g_a(x))) per head, then o_proj.

A sequence's state between calls is S (per head) and the convolution's
window, the last 3 projected inputs.  ``prefill`` runs the tokens of
several sequences at once (the segments of a packed prefill chunk, or the
rows' own prompts), each from and back into its own state; ``step`` runs
one token of every row.

**The chunked form** (``prefill``).  A segment is cut into chunks of 64
tokens.  With G_t the cumulative log-decay from a chunk's start, S_0 the
state at its start, A_tj = beta_t sum_c k_t[c] k_j[c] e^(G_t[c] - G_j[c])
(j < t) and P_tj = sum_c q_t[c] k_j[c] e^(G_t[c] - G_j[c]) (j <= t), the
recurrence gives (I + A) U = diag(beta) (V - (e^G * K) S_0), so
U = W_v - W_k S_0 with W = (I + A)^-1 diag(beta) [V | e^G * K], and then
O = (e^G * Q) S_0 + P U and S_C = e^(G_C) * S_0 + (e^(G_C - G) * K)^T U.
Everything but the pass from S_0 to S_C is batched over every chunk of
the call: the decays, A and P, and the solve (``chunk_inputs``); the pass
is the kernel ``kda_chunk_state`` (``ops/kernels/kda.py``).  The pairwise
decays are formed so that no exponent is positive: across sub-chunks of
16 tokens through the decay at the end of the key's sub-chunk, inside one
exactly, masked before the exponential.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ...ops.kernels import kda as kernels

CHUNK = kernels.CHUNK
SUB = 16  # tokens a sub-chunk of the pairwise decays


def l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``fla``'s L2 normalisation over the last axis."""
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + eps)


@dataclass
class Plan:
    """Where the tokens of the segments go: each segment (slot, start, end)
    of the call's T tokens as whole chunks of ``CHUNK``, laid end to end,
    and the window rows its convolution reads."""

    chunks: int
    first: torch.Tensor   # (segments,) int32: each segment's first chunk
    end: torch.Tensor     # (segments,) int32: past its last
    slot: torch.Tensor    # (segments,) int32: its state's index
    src: torch.Tensor     # (tokens,) the segments' token rows, in order
    dst: torch.Tensor     # (tokens,) their rows in the chunks (chunk * CHUNK + i)
    ext: torch.Tensor     # rows of [windows; tokens] each segment's convolution reads
    ext_out: torch.Tensor  # (tokens,) each token's row of the convolution's output
    win_rows: torch.Tensor  # (segments * (conv - 1),) the new windows' rows of ext
    win_slots: torch.Tensor  # (segments * (conv - 1),) their rows of the windows


@dataclass
class States:
    """The KDA layers' carried state of n sequences: ``state`` (layers, n,
    H, K, V) float32 and the convolutions' windows ``win`` (layers, n,
    conv - 1, 3W) in the weights' type."""

    state: torch.Tensor
    win: torch.Tensor

    @classmethod
    def zeros(cls, cfg, n: int, dtype, device) -> "States":
        H, D = cfg.kda_num_heads, cfg.kda_head_dim
        return cls(torch.zeros(cfg.kda_layers, n, H, D, D, dtype=torch.float32, device=device),
                   torch.zeros(cfg.kda_layers, n, cfg.conv_size - 1, 3 * H * D, dtype=dtype,
                               device=device))

    def row_bytes(self) -> int:
        """Bytes of one sequence's state and windows, over every layer."""
        return (self.state[:, 0].numel() * self.state.element_size()
                + self.win[:, 0].numel() * self.win.element_size())


def plan(segs: list[tuple[int, int, int]], n_slots: int, conv: int, device) -> Plan:
    """The layout of segments ``(slot, start, end)`` (rows start..end-1 of
    the call's tokens) over ``n_slots`` states with windows of ``conv - 1``."""
    w = conv - 1
    first, end, slot, src, dst, ext, ext_out, win_rows, win_slots = ([] for _ in range(9))
    c = 0
    for sl, a, b in segs:
        n = -(-(b - a) // CHUNK)
        first.append(c)
        end.append(c + n)
        slot.append(sl)
        src += range(a, b)
        dst += range(c * CHUNK, c * CHUNK + b - a)
        c += n
        e0 = len(ext)
        ext += [sl * w + i for i in range(w)] + [n_slots * w + t for t in range(a, b)]
        ext_out += range(e0, e0 + b - a)
        win_rows += range(len(ext) - w, len(ext))
        win_slots += [sl * w + i for i in range(w)]

    def t(x, dtype=torch.long):
        return torch.tensor(x, dtype=dtype).to(device, non_blocking=True)

    i32 = torch.int32
    return Plan(c, t(first, i32), t(end, i32), t(slot, i32), t(src), t(dst), t(ext),
                t(ext_out), t(win_rows), t(win_slots))


def _projections(h, lp):
    """The convolution's inputs (T, 3W), the decay's, the gate's and beta's
    low-rank inputs."""
    ab = h @ lp["ab"]
    r = lp["f_b"].shape[0]
    return h @ lp["qkv"], ab[:, :r], ab[:, r:2 * r], ab[:, 2 * r:]


def _qkv(conv_out, cfg):
    """SiLU, split, per-head L2 norm of q and k, q scaled; float32 (T, H, D) each."""
    H, D = cfg.kda_num_heads, cfg.kda_head_dim
    q, k, v = F.silu(conv_out).view(-1, 3, H, D).unbind(1)
    return l2norm(q) * D ** -0.5, l2norm(k), v


def _decay(fa, b, lp, cfg):
    H, D = cfg.kda_num_heads, cfg.kda_head_dim
    f = (fa @ lp["f_b"]).float() + lp["dt_bias"]
    g = -lp["A_log"].exp()[:, None] * F.softplus(f.view(-1, H, D))
    return g, torch.sigmoid(b.float())


def _output(o, ga, lp, cfg, dtype):
    """The gated RMSNorm of each head's output, then o_proj."""
    gate = (ga @ lp["g_b"]).float().view(o.shape)
    o = F.rms_norm(o, (o.shape[-1],), lp["o_norm"].float(), cfg.rms_norm_eps)
    return (o * torch.sigmoid(gate)).to(dtype).flatten(1) @ lp["o"]


def chunk_inputs(q, k, v, g, beta, p: Plan):
    """The kernel's inputs for the chunks of ``p``: (wk, wv, qt, kh, P,
    gam), each (chunks, H, CHUNK, .) float32 (gam (chunks, H, K)), from
    the segments' tokens in order (q (tokens, H, K), ...).  Padded rows
    hold zero keys, values, betas and decays: they move no state."""
    N, C = p.chunks, CHUNK
    H, K = q.shape[1], q.shape[2]
    V = v.shape[2]

    def pad(x):
        z = x.new_zeros(N * C, *x.shape[1:])
        z.index_copy_(0, p.dst, x)
        return z.view(N, C, *x.shape[1:]).transpose(1, 2).contiguous()

    q, k, v, g, beta = pad(q), pad(k), pad(v), pad(g), pad(beta[..., None])[..., 0]
    G = g.cumsum(2)
    nb = C // SUB
    dev = q.device
    Gs, ks, qs = (x.view(N, H, nb, SUB, K) for x in (G, k, q))
    Rb = Gs[:, :, :, -1]                                                   # (N, H, nb, K)
    # across sub-chunks: key j (sub-chunk b) decayed to b's end, query or
    # key t (a later sub-chunk) decayed from there; each exponent <= 0
    kj = ks * (Rb[:, :, :, None] - Gs).exp()
    later = (torch.arange(C, device=dev) // SUB)[:, None] > torch.arange(nb, device=dev)
    ft = (G[:, :, :, None] - Rb[:, :, None]).masked_fill_(~later[..., None], float("-inf"))
    ft.exp_()
    kq = torch.stack((k, q), 2)[:, :, :, :, None] * ft[:, :, None]          # (N, H, 2, C, nb, K)
    off = torch.einsum("nhxtbc,nhbjc->nhxtbj", kq, kj).reshape(N, H, 2, C, C)
    del kq, ft
    # inside a sub-chunk: the exact pairwise decays, masked before the exponential
    i = torch.arange(SUB, device=dev)
    E = (Gs[:, :, :, :, None] - Gs[:, :, :, None]).masked_fill_(
        (i[None, :] > i[:, None])[..., None], float("-inf"))               # (N, H, nb, t, j, K)
    E.exp_().mul_(ks[:, :, :, None])
    diag = torch.einsum("nhatjc,nhatcx->nhxatj", E, torch.stack((ks, qs), -1))
    del E
    blocks = off.view(N, H, 2, nb, SUB, nb, SUB).diagonal(dim1=3, dim2=5)   # (N, H, 2, t, j, nb)
    blocks += diag.permute(0, 1, 2, 4, 5, 3)
    A, P = off.unbind(2)
    A = torch.tril(A, -1) * beta[..., None]
    eg = G.exp()
    rhs = torch.cat((v, k * eg), -1) * beta[..., None]
    W = torch.linalg.solve_triangular(A, rhs, upper=False, unitriangular=True)
    glast = G[:, :, -1]
    return (W[..., V:].contiguous(), W[..., :V].contiguous(), (q * eg).contiguous(),
            (k * (glast[:, :, None] - G).exp()).contiguous(), P.contiguous(),
            glast.exp().contiguous())


def prefill(lp, cfg, h: torch.Tensor, p: Plan, state: torch.Tensor,
            win: torch.Tensor) -> torch.Tensor:
    """The layer's output (T, d) for tokens h (T, d) of the segments of
    ``p``, each continuing the sequence of its slot: ``state`` (slots, H,
    K, V) float32 and ``win`` (slots, conv - 1, 3W) are read and updated
    in place.  Rows of h in no segment get a zero output."""
    x, fa, ga, b = _projections(h, lp)
    w = win.shape[1]
    ext = torch.cat((win.view(-1, x.shape[1]), x)).index_select(0, p.ext)
    win.view(-1, x.shape[1]).index_copy_(0, p.win_slots, ext.index_select(0, p.win_rows))
    ext = ext.float()
    wt = lp["conv"].float()                                                # (3W, conv)
    conv = sum(ext[i:ext.shape[0] - w + i] * wt[:, i] for i in range(w + 1))
    q, k, v = _qkv(conv.index_select(0, p.ext_out), cfg)
    g, beta = _decay(fa.index_select(0, p.src), b.index_select(0, p.src), lp, cfg)
    o_chunks = kernels.kda_chunk_state(*chunk_inputs(q, k, v, g, beta, p), p.first, p.end,
                                       p.slot, state)
    H, V = o_chunks.shape[1], o_chunks.shape[3]
    o = o_chunks.transpose(1, 2).reshape(-1, H, V).index_select(0, p.dst)
    out = h.new_zeros(h.shape[0], lp["o"].shape[1])
    return out.index_copy_(0, p.src, _output(o, ga.index_select(0, p.src), lp, cfg, h.dtype))


def step(lp, cfg, h: torch.Tensor, active: torch.Tensor, state: torch.Tensor,
         win: torch.Tensor) -> torch.Tensor:
    """One token of every row: h (R, d), ``state`` (R, H, K, V) and ``win``
    (R, conv - 1, 3W) in place for the active rows' heads (a finished
    row's window moves on; it is never read again).  Returns (R, d)."""
    x, fa, ga, b = _projections(h, lp)
    ext = torch.cat((win, x[:, None]), 1)
    win.copy_(ext[:, 1:])
    conv = (ext.float() * lp["conv"].float().t()).sum(1)
    q, k, v = _qkv(conv, cfg)
    g, beta = _decay(fa, b, lp, cfg)
    o = kernels.kda_step(q.contiguous(), k.contiguous(), v.contiguous(), g.contiguous(),
                         beta.contiguous(), active, state)
    return _output(o, ga, lp, cfg, h.dtype)
