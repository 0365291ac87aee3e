"""A plain Kimi-Linear forward pass in float32: the reference the port's
Kimi-Linear is held to.

It follows ``modeling_kimi.py`` of the published checkpoint
(``KimiLinearForCausalLM``: ``KimiDeltaAttention`` on the
``linear_attn_config``'s KDA layers, ``KimiMLAAttention`` with
``mla_use_nope`` on the others, ``KimiMoEGate`` with sigmoid scores and
``KimiBlockSparseMoE`` with one shared expert) over one sequence, reading
weights by their published names from any mapping of tensors.  It imports
nothing of the JAX package or of its PyTorch port.  Departures from the
published code, none of which changes the function it computes:

- every product and sum is float32 (the published code runs in the
  checkpoint's type and keeps float32 only in RMSNorm's statistics, the
  router, the softmax and KDA's state), and TF32 is off (``full_fp32``);
- KDA runs in one of two forms written from its recurrence: token by
  token (``kda_tokens``, the definition, as ``fla``'s naive recurrent
  form), or chunk by chunk (``kda_chunks``: the decays of each pair of a
  block's tokens, masked before the exponential, and the block's lower
  triangular system, with blocks of 32 tokens, not the port's 64) in
  place of ``fla``'s fused kernels; the short convolution is the causal
  sum of its four taps (``ShortConvolution`` without bias), not
  ``causal_conv1d``'s kernel;
- no cache, no batch, no padding mask, no dropout;
- MLA attention runs in blocks of queries, each over the keys up to its
  last query (the same causal softmax, in pieces that fit);
- each token goes through its own top-k experts and no other: a loop over
  the held experts, each applied to the tokens that chose it and added in
  with the token's routing weight (``moe_infer``'s sort and split,
  unrolled);
- an expert share: ``num_experts`` experts are held, ``experts_held``
  [first, end) of ``experts_published`` (all by default); the router
  scores every published expert, and a token's picks held elsewhere add
  nothing here (the other cards of an expert-parallel deployment add
  them);
- ``weight`` maps each weight before use (float32 by default); the
  benchmark's control rounds through float8 there.
"""
from __future__ import annotations

from typing import Callable, Mapping

import torch
import torch.nn.functional as F

ATTN_BLOCK_BYTES = 1 << 31  # float32 scores a block of queries at most
KDA_BLOCK = 32


def full_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + 1e-6)


def _mlp(x, gate, up, down):
    return (F.silu(x @ gate.T) * (x @ up.T)) @ down.T


def kda_tokens(q, k, v, g, beta, state=None):
    """KDA token by token: q, k, g (T, H, K), v (T, H, V), beta (T, H);
    returns o (T, H, V) and the final state (H, K, V)."""
    T, H, K = q.shape
    S = q.new_zeros(H, K, v.shape[-1]) if state is None else state
    out = []
    for t in range(T):
        S = S * g[t].exp()[..., None]
        u = beta[t][:, None] * (v[t] - (k[t][..., None] * S).sum(1))
        S = S + k[t][..., None] * u[:, None, :]
        out.append((q[t][..., None] * S).sum(1))
    return torch.stack(out), S


def kda_chunks(q, k, v, g, beta, state=None, block: int = KDA_BLOCK,
               blocks_at_once: int = 64):
    """KDA a block of tokens at a time, from the same recurrence: in a
    block with cumulative log-decays G from its start and state S0 at its
    start, u = (I + A)^-1 diag(beta) (V - (e^G * K) S0) with A_tj =
    beta_t k_t . e^(G_t - G_j) k_j (j < t); o_t = (e^G_t q_t) S0 +
    sum_{j <= t} (q_t . e^(G_t - G_j) k_j) u_j; the state at the block's end
    e^G_last S0 + sum_j (e^(G_last - G_j) k_j) u_j^T.  What does not need
    S0 (the pairwise decays, A, the solve) is formed for ``blocks_at_once``
    blocks together; the state then passes through them one by one.  The
    tail is padded with tokens of zero key, value, beta and decay, which
    move no state."""
    T, H, K = q.shape
    V = v.shape[-1]
    S = q.new_zeros(H, K, V) if state is None else state
    n = block
    out = []
    for s in range(0, T, n * blocks_at_once):
        e = min(T, s + n * blocks_at_once)
        nb = -(-(e - s) // n)

        def blocks(x):
            x = x[s:e]
            pad = x.new_zeros(nb * n - (e - s), *x.shape[1:])
            return torch.cat((x, pad)).view(nb, n, *x.shape[1:]).transpose(1, 2)

        qb, kb, vb, gb = blocks(q), blocks(k), blocks(v), blocks(g)      # (nb, H, n, .)
        bb = blocks(beta[..., None])[..., 0]                             # (nb, H, n)
        G = gb.cumsum(2)
        i = torch.arange(n, device=q.device)
        later = i[None, :] > i[:, None]                                  # [t, j]: j after t
        D = (G[:, :, :, None] - G[:, :, None]).masked_fill_(later[..., None], float("-inf"))
        D = D.exp_().mul_(kb[:, :, None])                # (nb, H, t, j, K): e^(G_t - G_j) k_j
        kk = (D * kb[:, :, :, None]).sum(-1)
        qk = (D * qb[:, :, :, None]).sum(-1)
        del D
        A = torch.tril(kk, -1) * bb[..., None]
        eye = torch.eye(n, device=q.device)
        eG = G.exp()
        W = torch.linalg.solve_triangular(eye + A, bb[..., None] * torch.cat((vb, eG * kb), -1),
                                          upper=False)
        Wv, Wk = W[..., :V], W[..., V:]
        last = G[:, :, -1:]
        Kend = (last - G).exp() * kb
        for i in range(nb):
            U = Wv[i] - Wk[i] @ S
            out.append(((eG[i] * qb[i]) @ S + qk[i] @ U).transpose(0, 1))
            S = last[i, :, 0, :, None].exp() * S + Kend[i].transpose(1, 2) @ U
    return torch.cat(out)[:T], S


def _kda_layer(h, W, p, cfg, kda_form, eps):
    la = cfg["linear_attn_config"]
    H, D, cw = la["num_heads"], la["head_dim"], la["short_conv_kernel_size"]
    T = h.shape[0]

    def conv(x, w):                                                      # causal, no bias
        xp = torch.cat((x.new_zeros(cw - 1, x.shape[1]), x))
        w = w[:, 0]                                                     # (C, cw)
        return F.silu(sum(xp[i:i + T] * w[:, i] for i in range(cw)))

    a = p + "self_attn."
    q = conv(h @ W(a + "q_proj.weight").T, W(a + "q_conv1d.weight")).view(T, H, D)
    k = conv(h @ W(a + "k_proj.weight").T, W(a + "k_conv1d.weight")).view(T, H, D)
    v = conv(h @ W(a + "v_proj.weight").T, W(a + "v_conv1d.weight")).view(T, H, D)
    q, k = _l2norm(q) * D ** -0.5, _l2norm(k)
    f = (h @ W(a + "f_a_proj.weight").T) @ W(a + "f_b_proj.weight").T + W(a + "dt_bias")
    g = -W(a + "A_log").reshape(-1).exp()[:, None] * F.softplus(f.view(T, H, D))
    beta = torch.sigmoid(h @ W(a + "b_proj.weight").T)
    o, _ = (kda_tokens if kda_form == "tokens" else kda_chunks)(q, k, v, g, beta)
    gate = ((h @ W(a + "g_a_proj.weight").T) @ W(a + "g_b_proj.weight").T).view(T, H, D)
    o = _rms_norm(o, W(a + "o_norm.weight"), eps) * torch.sigmoid(gate)
    return o.reshape(T, H * D) @ W(a + "o_proj.weight").T


def _mla_layer(h, W, p, cfg, eps):
    T, dev = h.shape[0], h.device
    H, dn, dr, dv = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                     cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    r = cfg["kv_lora_rank"]
    a = p + "self_attn."
    q = (h @ W(a + "q_proj.weight").T).view(T, H, dn + dr)
    ckv = h @ W(a + "kv_a_proj_with_mqa.weight").T
    c = _rms_norm(ckv[:, :r], W(a + "kv_a_layernorm.weight"), eps)
    kv = (c @ W(a + "kv_b_proj.weight").T).view(T, H, dn + dv)
    # NoPE: the rope part of query and key enter unrotated
    qs = q.transpose(0, 1)                                              # (H, T, dq)
    ks = torch.cat((kv[..., :dn], ckv[:, None, r:].expand(T, H, dr)), -1).transpose(0, 1)
    vs = kv[..., dn:].transpose(0, 1)
    scale = (dn + dr) ** -0.5
    q_block = max(1, ATTN_BLOCK_BYTES // (4 * H * T))
    attn = torch.empty(H, T, dv, device=dev)
    for s in range(0, T, q_block):
        e = min(T, s + q_block)
        sc = (qs[:, s:e] @ ks[:, :e].transpose(1, 2)).mul_(scale)
        future = torch.arange(e, device=dev)[None, :] > torch.arange(s, e, device=dev)[:, None]
        attn[:, s:e] = torch.softmax(sc.masked_fill_(future, float("-inf")), dim=-1) @ vs[:, :e]
    return attn.transpose(0, 1).reshape(T, H * dv) @ W(a + "o_proj.weight").T


def _moe(h, W, m, cfg):
    e0, e1 = cfg.get("experts_held", (0, cfg["num_experts"]))
    k = cfg["num_experts_per_token"]
    scores = torch.sigmoid(h @ W(m + "gate.weight").T)                  # (T, n_pub)
    top_i = torch.topk(scores + W(m + "gate.e_score_correction_bias"), k, dim=-1).indices
    top_w = scores.gather(1, top_i)
    if cfg["moe_renormalize"]:
        top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-20)
    top_w = top_w * cfg["routed_scaling_factor"]
    routed = torch.zeros_like(h)
    for j in range(e0, e1):
        tok, slot = (top_i == j).nonzero(as_tuple=True)
        if tok.numel():
            e_ = f"{m}experts.{j}."
            y = _mlp(h[tok], W(e_ + "w1.weight"), W(e_ + "w3.weight"), W(e_ + "w2.weight"))
            routed.index_add_(0, tok, y * top_w[tok, slot, None])
    s_ = m + "shared_experts."
    return routed + _mlp(h, W(s_ + "gate_proj.weight"), W(s_ + "up_proj.weight"),
                         W(s_ + "down_proj.weight"))


def forward(weights: Mapping[str, torch.Tensor], cfg: dict, ids: torch.Tensor, *,
            weight: Callable[[torch.Tensor], torch.Tensor] | None = None,
            positions: torch.Tensor | None = None, kda_form: str = "chunks") -> torch.Tensor:
    """Float32 logits of the sequence ``ids`` at ``positions`` (all by
    default), from the weights under their published names; KDA in
    ``kda_form`` "chunks" or "tokens"."""
    w = weight or (lambda t: t.float())
    dev = ids.device
    eps = cfg["rms_norm_eps"]
    full = {i - 1 for i in cfg["linear_attn_config"]["full_attn_layers"]}

    def W(name):
        return w(weights[name]).to(dev)

    x = w(weights["model.embed_tokens.weight"][ids].to(dev))
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        h = _rms_norm(x, W(p + "input_layernorm.weight"), eps)
        x = x + (_mla_layer(h, W, p, cfg, eps) if i in full
                 else _kda_layer(h, W, p, cfg, kda_form, eps))
        h = _rms_norm(x, W(p + "post_attention_layernorm.weight"), eps)
        moe = i >= cfg["first_k_dense_replace"] and i % cfg["moe_layer_freq"] == 0
        if moe:
            x = x + _moe(h, W, p + "block_sparse_moe.", cfg)
        else:
            m = p + "mlp."
            x = x + _mlp(h, W(m + "gate_proj.weight"), W(m + "up_proj.weight"),
                         W(m + "down_proj.weight"))
    if positions is not None:
        x = x[positions]
    x = _rms_norm(x, W("model.norm.weight"), eps)
    return x @ W("lm_head.weight").T
