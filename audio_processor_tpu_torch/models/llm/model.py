"""The language models' forward pass in PyTorch: DeepSeek-V2 (MLA, YaRN,
dense and MoE MLPs) and Kimi-Linear (KDA and NoPE MLA layers, sigmoid-routed
experts).

The equations are ``modeling_deepseek.py``'s (``DeepseekV2Attention`` with
no query LoRA, ``DeepseekV2YarnRotaryEmbedding``, ``MoEGate`` with softmax
scores and greedy top-k, ``DeepseekV2MoE`` with shared experts) and
``modeling_kimi.py``'s (the same MLA without rotary positions,
``KimiDeltaAttention`` in ``kda.py``, ``KimiMoEGate`` with sigmoid scores,
a score-correction bias for the choice, renormalised and scaled weights),
computed in the weights' type (bfloat16 on the card) with float32 where the
published code keeps it: RMSNorm's statistics, the router's logits, scores
and weights, the softmax of attention, the sum of the routed experts'
outputs, and KDA's decays and state.  A configuration's ``layer_kinds``
say which attention a layer runs; MLA layers keep latent caches, KDA
layers a state a sequence (``kda.States``).

Attention runs in two forms over one latent cache of ``kv_lora_rank`` +
``qk_rope_head_dim`` values a token and layer (the normalised ``c_kv`` and
the roped ``k_pe``):

- **prefill** (``prefill_chunk``) expands the cached latent to per-head keys
  and values (``W_UK``, ``W_UV``, the two halves of ``kv_b_proj``) and
  attends causally in query blocks;
- **rows** (``forward_rows``: decode steps, and the few prompt tokens each
  row adds after a shared prefix) absorb ``W_UK`` into the query and
  ``W_UV`` into the output, and attend over the latent itself: a group's
  shared prefix (read once for all its rows) and each row's own suffix.

The MoE runs one grouped product (``torch.nn.functional.grouped_mm``) per
expert projection over the (token, expert) pairs sorted by expert, so the
router's choice never leaves the device.  Rows that are finished or
padding are routed past the last expert, where the grouped product skips
them: they touch no expert's weights.  A process may hold a share of the
routed experts (``cfg.expert_range``, expert parallelism): the router
still scores all of them, pairs of the experts held elsewhere go past the
last held expert too, and on a mesh the routed sum is all-reduced over the
model group, where the other ranks add their experts' part.

Parameters are a plain tree (``checkpoint.py`` builds it): linears stored
(d_in, d_out), the gate and up projections of every MLP side by side, the
routed experts stacked, ``W_UK`` as (heads, nope, rank) and ``W_UV`` as
(heads, rank, v).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...parallel.mesh import all_reduce
from . import kda
from .config import DeepseekV2Config, yarn_mscale

PREFILL_BLOCK_BYTES = 1 << 30  # the prefill's score block at most (query rows x keys x heads)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """``DeepseekV2RMSNorm``: the statistics in float32 (one rounding to
    x's type at the end, where the published code rounds before the
    weight's product too)."""
    return F.rms_norm(x, (x.shape[-1],), w, eps)


def yarn_inv_freq(cfg: DeepseekV2Config) -> torch.Tensor:
    """YaRN's blend of interpolated and original frequencies
    (``DeepseekV2YarnRotaryEmbedding._set_cos_sin_cache``), float32 on the CPU."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    extra = 1.0 / (base ** exps)
    inter = 1.0 / (cfg.rope_factor * base ** exps)

    def corr(rot):
        return dim * math.log(cfg.rope_original_max_position / (rot * 2 * math.pi)) / (
            2 * math.log(base))

    low = max(math.floor(corr(cfg.rope_beta_fast)), 0)
    high = min(math.ceil(corr(cfg.rope_beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    return inter * (1 - mask) + extra * mask


def rope_mscale(cfg: DeepseekV2Config) -> float:
    """The factor on the cos and sin tables (1 where both mscales agree)."""
    return yarn_mscale(cfg.rope_factor, cfg.rope_mscale) / yarn_mscale(
        cfg.rope_factor, cfg.rope_mscale_all_dim)


def rope_tables(pos: torch.Tensor, inv_freq: torch.Tensor, mscale: float = 1.0) -> torch.Tensor:
    """The rotation of each channel pair at positions ``pos``, as complex
    numbers (pos.shape + (d/2,)), float32."""
    f = pos.float().unsqueeze(-1) * inv_freq
    return torch.polar(torch.full_like(f, mscale), f)


def rope(x: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Rotary embedding of x (..., d), whose channels come in the
    checkpoint's interleaved pairs, by ``rope_tables`` (broadcastable to
    x.shape[:-1]): each pair (x[2i], x[2i+1]) turned by its angle, the
    first members then the second, which is ``apply_rotary_pos_emb``'s
    de-interleave and rotation by halves; float32, returned in x's type."""
    d = x.shape[-1]
    z = torch.view_as_complex(x.float().unflatten(-1, (d // 2, 2))) * rot
    return torch.cat((z.real, z.imag), -1).to(x.dtype)


def mlp(x: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``down(silu(gate(x)) * up(x))``."""
    g, u = (x @ gate_up).chunk(2, -1)
    return (F.silu(g) * u) @ down


def moe(x: torch.Tensor, lp: dict, cfg: DeepseekV2Config,
        valid: torch.Tensor | None = None, mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The routed experts plus the shared ones for tokens x (T, d).

    Returns the output and the number of distinct held experts the valid
    tokens chose (a device scalar).  ``valid`` (T,) bool routes the other
    tokens past the last expert: their pairs sort last, beyond the grouped
    products' offsets, and their routed output is zero; so do the pairs of
    experts outside ``cfg.expert_range``.  The router scores every expert:
    softmax (DeepSeek-V2) or sigmoid, chosen by score plus ``router_bias``
    and weighted by the unbiased score (Kimi); the chosen weights are
    renormalised where ``norm_topk_prob``, then scaled by ``route_scale``."""
    n_exp, k = cfg.n_routed_experts, cfg.num_experts_per_tok
    e0, e1 = cfg.expert_range
    held = e1 - e0
    logits = x.float() @ lp["router"].float()
    if cfg.scoring == "sigmoid":
        scores = logits.sigmoid()
        idx = (scores + lp["router_bias"]).topk(k, dim=-1).indices
        w = scores.gather(-1, idx)
    else:
        w, idx = logits.softmax(-1).topk(k, dim=-1)
    if cfg.norm_topk_prob:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * cfg.route_scale
    flat = idx.reshape(-1)
    if held < n_exp:  # another card's experts: past the last held one
        flat = flat - e0
        flat = flat.masked_fill((flat < 0) | (flat >= held), held)
    if valid is not None:
        flat = flat.masked_fill(~valid.repeat_interleave(k), held)
    order = flat.argsort(stable=True)
    counts = torch.zeros(held + 1, dtype=torch.int32, device=x.device).scatter_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))
    offs = counts[:held].cumsum(0, dtype=torch.int32)
    xs = x.index_select(0, order // k)
    g, u = F.grouped_mm(xs, lp["experts_gate_up"], offs=offs).chunk(2, -1)
    h = F.grouped_mm(F.silu(g) * u, lp["experts_down"], offs=offs)
    if valid is not None or held < n_exp:  # the skipped rows of the grouped product hold no result
        h = h.masked_fill((flat.index_select(0, order) == held).unsqueeze(-1), 0)
    routed = torch.empty_like(h).index_copy_(0, order, h)
    routed = (routed.view(x.shape[0], k, -1).float() * w.unsqueeze(-1)).sum(1).to(x.dtype)
    shared = mlp(x, lp["shared_gate_up"], lp["shared_down"])
    return all_reduce(routed, mesh) + shared, (counts[:held] > 0).sum()


def _ffn(h, lp, cfg, valid, touched, mesh=None):
    if "router" in lp:
        y, n = moe(h, lp, cfg, valid, mesh)
        touched.append(n)
        return y
    return mlp(h, lp["gate_up"], lp["down"])


def _project(h, lp, cfg, rot):
    """The queries (nope, roped rope part) and the new latent of tokens h
    (..., d), at the positions of the rotary tables (...); with ``rot``
    None (NoPE) the rope part of the query and the key stay as projected."""
    nh, dn, r = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
    q = (h @ lp["q"]).unflatten(-1, (nh, cfg.q_head_dim))
    lat = h @ lp["kv_a"]
    c = rms_norm(lat[..., :r], lp["kv_norm"], cfg.rms_norm_eps)
    if rot is None:
        return q[..., :dn], q[..., dn:], torch.cat((c, lat[..., r:]), -1)
    k_pe = rope(lat[..., r:], rot)
    q_pe = rope(q[..., dn:], rot.unsqueeze(-2))
    return q[..., :dn], q_pe, torch.cat((c, k_pe), -1)


def _attend_expanded(q_nope, q_pe, lat, lp, cfg, q0: int, q_block: int) -> torch.Tensor:
    """Causal attention of n queries at positions q0..q0+n-1 over the
    latent ``lat`` (capacity, r+dr) of positions 0.., with per-head keys and
    values expanded from it; (n, H*dv).  Keys are taken up to the next
    multiple of 64 past the last query (where the capacity allows), so the
    products' rows stay aligned; those past a query are masked.  Queries
    go ``q_block`` at a time, fewer where their scores over every key
    would pass ``PREFILL_BLOCK_BYTES`` (a multiple of 64, at least 64)."""
    n, nh = q_nope.shape[0], cfg.num_attention_heads
    r = cfg.kv_lora_rank
    kb_all = min(lat.shape[0], -(-(q0 + n) // 64) * 64)
    fit = PREFILL_BLOCK_BYTES // (nh * kb_all * q_nope.element_size()) // 64 * 64
    q_block = max(64, min(q_block, fit))
    c, k_pe = lat[:kb_all, :r], lat[:kb_all, r:]
    k = torch.cat((torch.einsum("br,hnr->hbn", c, lp["w_uk"]),
                   k_pe.unsqueeze(0).expand(nh, -1, -1)), -1)
    v = torch.einsum("br,hrv->hbv", c, lp["w_uv"])
    q = torch.cat((q_nope, q_pe), -1).transpose(0, 1) * cfg.softmax_scale
    out = q.new_empty(nh, n, cfg.v_head_dim)
    for s in range(0, n, q_block):
        e = min(n, s + q_block)
        kb = min(kb_all, -(-(q0 + e) // 64) * 64)
        sc = torch.matmul(q[:, s:e], k[:, :kb].transpose(1, 2))
        future = (torch.arange(q0 + s, kb, device=sc.device)
                  > torch.arange(q0 + s, q0 + e, device=sc.device)[:, None])
        sc[:, :, q0 + s:kb].masked_fill_(future, float("-inf"))
        out[:, s:e] = torch.matmul(torch.softmax(sc, dim=-1), v[:, :kb])
    return out.transpose(0, 1).reshape(n, nh * cfg.v_head_dim)


def prefill_chunk(params: dict, cfg: DeepseekV2Config, pc: torch.Tensor, ids: torch.Tensor,
                  segs: list[tuple[int, int, int, int]], inv_freq: torch.Tensor,
                  q_block: int = 1024, states: kda.States | None = None,
                  mesh=None) -> tuple[torch.Tensor, list]:
    """One chunk of prefill: tokens ``ids`` (T,) made of segments
    ``(group, first position, chunk start, chunk end)``, each the
    continuation of its group's prefix in the cache ``pc`` (MLA layers,
    groups, capacity, latent) and, for the KDA layers, of its group's
    ``states``; it extends both.  Returns the chunk's last hidden states
    (T, d), before the final norm, and the experts-touched scalars."""
    kinds, slots = cfg.layer_kinds, cfg.layer_slots
    rot = None
    if cfg.rope:
        pos = torch.cat([torch.arange(a, a + e - s, device=ids.device) for _, a, s, e in segs])
        rot = rope_tables(pos, inv_freq, rope_mscale(cfg))
    plan = None
    if cfg.kda_layers:
        plan = kda.plan([(g, s, e) for g, _, s, e in segs], pc.shape[1], cfg.conv_size,
                        ids.device)
    x = params["embed"].index_select(0, ids)
    touched: list = []
    for li, lp in enumerate(params["layers"]):
        h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
        m = slots[li]
        if kinds[li] == "kda":
            x = x + kda.prefill(lp, cfg, h, plan, states.state[m], states.win[m])
        else:
            q_nope, q_pe, lat = _project(h, lp, cfg, rot)
            attn = []
            for g, a, s, e in segs:
                pc[m, g, a:a + e - s] = lat[s:e]
                attn.append(_attend_expanded(q_nope[s:e], q_pe[s:e], pc[m, g], lp, cfg, a,
                                             q_block))
            x = x + torch.cat(attn) @ lp["o"]
        x = x + _ffn(rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps), lp, cfg, None, touched, mesh)
    return x, touched


def forward_rows(params: dict, cfg: DeepseekV2Config, tok: torch.Tensor, valid: torch.Tensor,
                 pc: torch.Tensor, plen: torch.Tensor, sc: torch.Tensor, slen: torch.Tensor,
                 inv_freq: torch.Tensor, group_block: int | None = None,
                 states: kda.States | None = None, lengths: list[int] | None = None,
                 mesh=None) -> tuple[torch.Tensor, list]:
    """S new tokens ``tok`` (R, S) for each of R rows, in the absorbed form.

    The rows come in G groups of K = R // G (group g's rows g*K..g*K+K-1)
    that share the prefix ``pc[:, g, :plen[g]]``; row r's own tokens are
    ``sc[:, r, :slen[r]]``, and its new tokens go to the positions after
    them, in ``sc`` and at ``plen + slen + j``.  Tokens that are not
    ``valid`` are computed (their rows' later tokens may overwrite them)
    but touch no expert.  ``group_block`` groups attend at a time (all by
    default).  The KDA layers continue each row's ``states``: one token a
    row (S = 1) through the step, whose invalid rows move no state, or the
    rows' first ``lengths`` tokens through the chunked form.  Returns the
    hidden states (R, S, d) and the experts-touched scalars."""
    R, S = tok.shape
    G = pc.shape[1]
    K = R // G
    nh, r = cfg.num_attention_heads, cfg.kv_lora_rank
    cap_p, cap_s = pc.shape[2], sc.shape[2]
    dev = tok.device
    steps = torch.arange(S, device=dev)
    row_plen = plen.repeat_interleave(K)
    pos = row_plen[:, None] + slen[:, None] + steps                      # (R, S)
    write = slen[:, None] + steps                                        # (R, S)
    rows = torch.arange(R, device=dev)[:, None].expand(R, S)
    # key masks, shared by the layers: prefix keys at or past the group's
    # length, suffix keys after the query's own position
    mask = torch.cat((
        (torch.arange(cap_p, device=dev) >= row_plen[:, None, None]).expand(R, S, cap_p),
        torch.arange(cap_s, device=dev) > write[:, :, None]), -1).unsqueeze(2)
    rot = rope_tables(pos, inv_freq, rope_mscale(cfg)) if cfg.rope else None
    kinds, slots = cfg.layer_kinds, cfg.layer_slots
    plan = None
    if cfg.kda_layers and S > 1:
        plan = kda.plan([(i, i * S, i * S + n) for i, n in enumerate(lengths)], R,
                        cfg.conv_size, dev)
    gb = group_block or G
    x = params["embed"].index_select(0, tok.reshape(-1))
    touched: list = []
    for li, lp in enumerate(params["layers"]):
        h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
        m = slots[li]
        if kinds[li] == "kda":
            if plan is None:
                x = x + kda.step(lp, cfg, h, valid.reshape(-1), states.state[m], states.win[m])
            else:
                x = x + kda.prefill(lp, cfg, h, plan, states.state[m], states.win[m])
            x = x + _ffn(rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps), lp, cfg,
                         valid.reshape(-1), touched, mesh)
            continue
        q_nope, q_pe, lat = _project(h.view(R, S, -1), lp, cfg, rot)
        sc_l, pc_l = sc[m], pc[m]
        sc_l[rows, write] = lat
        q_lat = torch.matmul(q_nope.permute(2, 0, 1, 3).reshape(nh, R * S, -1), lp["w_uk"])
        q = torch.cat((q_lat.view(nh, R, S, r).permute(1, 2, 0, 3), q_pe), -1)
        q = q * cfg.softmax_scale                                         # (R, S, H, r+dr)
        o = q.new_empty(R, S, nh, r)
        for g0 in range(0, G, gb):
            g1 = min(G, g0 + gb)
            r0, r1 = g0 * K, g1 * K
            qg = q[r0:r1]
            sp = torch.matmul(qg.reshape(g1 - g0, K * S * nh, -1), pc_l[g0:g1].transpose(1, 2))
            ss = torch.matmul(qg.reshape(r1 - r0, S * nh, -1), sc_l[r0:r1].transpose(1, 2))
            scores = torch.cat((sp.view(r1 - r0, S, nh, cap_p), ss.view(r1 - r0, S, nh, cap_s)),
                               -1)
            p = torch.softmax(scores.masked_fill_(mask[r0:r1], float("-inf")), dim=-1)
            o[r0:r1] = (
                torch.matmul(p[..., :cap_p].view(g1 - g0, K * S * nh, cap_p),
                             pc_l[g0:g1, :, :r]).view(r1 - r0, S, nh, r)
                + torch.matmul(p[..., cap_p:].view(r1 - r0, S * nh, cap_s),
                               sc_l[r0:r1, :, :r]).view(r1 - r0, S, nh, r))
        out = torch.matmul(o.permute(2, 0, 1, 3).reshape(nh, R * S, r), lp["w_uv"])
        x = x + out.permute(1, 0, 2).reshape(R * S, -1) @ lp["o"]
        x = x + _ffn(rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps), lp, cfg,
                     valid.reshape(-1), touched, mesh)
    return x.view(R, S, -1), touched


def logits(params: dict, cfg: DeepseekV2Config, x: torch.Tensor) -> torch.Tensor:
    """The head over the final norm of hidden states x (..., d), as float32."""
    return (rms_norm(x, params["norm"], cfg.rms_norm_eps) @ params["head"]).float()


def full_forward(params: dict, cfg: DeepseekV2Config, ids: torch.Tensor,
                 q_block: int = 1024, mesh=None) -> torch.Tensor:
    """Logits (T, V) of one sequence, through the prefill path in one chunk."""
    T = ids.shape[0]
    pc = params["embed"].new_zeros(cfg.mla_layers, 1, T, cfg.latent_dim)
    states = kda.States.zeros(cfg, 1, params["embed"].dtype, ids.device) if cfg.kda_layers else None
    inv_freq = yarn_inv_freq(cfg).to(ids.device) if cfg.rope else None
    x, _ = prefill_chunk(params, cfg, pc, ids, [(0, 0, 0, T)], inv_freq, q_block, states, mesh)
    return logits(params, cfg, x)
