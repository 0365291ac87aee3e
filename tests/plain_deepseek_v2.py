"""A plain DeepSeek-V2 forward pass in float32: the reference the port's
language model is held to.

It follows ``modeling_deepseek.py`` of the published checkpoint
(``DeepseekV2ForCausalLM`` with ``q_lora_rank`` None, softmax scoring and
greedy top-k) over one sequence, reading weights by their published names
from any mapping of tensors.  It imports nothing of the JAX package or of
its PyTorch port.  Departures from the published code, none of which
changes the function it computes:

- every product and sum is float32 (the published code runs in the
  checkpoint's type and keeps float32 only in RMSNorm's statistics, the
  router and the softmax), and TF32 is off (``full_fp32``);
- the rotary tables are float32 and computed for the positions asked,
  not cached at ``max_position_embeddings`` and cast to the model's type;
- no cache, no batch, no padding mask, no dropout and no auxiliary loss;
- attention runs in blocks of ``q_block`` queries, each over the keys up
  to its last query (the same causal softmax, in pieces that fit);
- each token goes through its own top-k experts and no other: a loop over
  the experts, each applied to the tokens that chose it and added in with
  the token's routing weight (``moe_infer``'s sort and split, unrolled);
- ``weight`` maps each weight before use (float32 by default); the
  benchmark's control rounds through float8 there.
"""
from __future__ import annotations

import math
from typing import Callable, Mapping

import torch


def full_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _mscale(scale: float, m: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def _rotary(cfg: dict, pos: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, float]:
    """cos and sin (len(pos), rope dim) of YaRN, and the softmax scale."""
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    rs = cfg.get("rope_scaling") or {}
    factor = float(rs.get("factor", 1.0))
    orig = rs.get("original_max_position_embeddings", cfg["max_position_embeddings"])
    fast, slow = rs.get("beta_fast", 32), rs.get("beta_slow", 1)
    m, m_all = rs.get("mscale", 1), rs.get("mscale_all_dim", 0)
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    freq_inter = 1.0 / (factor * base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))

    def corr_dim(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))) / (2 * math.log(base))

    low = max(math.floor(corr_dim(fast)), 0)
    high = min(math.ceil(corr_dim(slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0, 1)
    inv_freq_mask = 1.0 - ramp
    inv_freq = freq_inter * (1 - inv_freq_mask) + freq_extra * inv_freq_mask
    freqs = torch.outer(pos.float().cpu(), inv_freq)
    emb = torch.cat((freqs, freqs), dim=-1)
    cos_mscale = _mscale(factor, m) / _mscale(factor, m_all)
    scale = (cfg["qk_nope_head_dim"] + dim) ** -0.5
    if m_all:
        scale = scale * _mscale(factor, m_all) ** 2
    return (emb.cos() * cos_mscale).to(pos.device), (emb.sin() * cos_mscale).to(pos.device), scale


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x[..., : x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat((-x2, x1), dim=-1)


def _apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (T, heads, d): de-interleave the pairs, then rotate (``apply_rotary_pos_emb``)."""
    t, h, d = x.shape
    x = x.view(t, h, d // 2, 2).transpose(3, 2).reshape(t, h, d)
    return x * cos[:, None] + _rotate_half(x) * sin[:, None]


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def _mlp(x, gate, up, down):
    return (torch.nn.functional.silu(x @ gate.T) * (x @ up.T)) @ down.T


def forward(weights: Mapping[str, torch.Tensor], cfg: dict, ids: torch.Tensor, *,
            weight: Callable[[torch.Tensor], torch.Tensor] | None = None, q_block: int = 1024,
            positions: torch.Tensor | None = None) -> torch.Tensor:
    """Float32 logits of the sequence ``ids`` at ``positions`` (all by
    default), from the weights under their published names."""
    w = weight or (lambda t: t.float())
    dev = ids.device
    T = ids.shape[0]
    H, dn, dr, dv = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                     cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    r, eps = cfg["kv_lora_rank"], cfg["rms_norm_eps"]
    E, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    cos, sin, scale = _rotary(cfg, torch.arange(T, device=dev))
    x = w(weights["model.embed_tokens.weight"][ids].to(dev))

    def W(name):
        return w(weights[name]).to(dev)

    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        h = _rms_norm(x, W(p + "input_layernorm.weight"), eps)
        q = (h @ W(p + "self_attn.q_proj.weight").T).view(T, H, dn + dr)
        ckv = h @ W(p + "self_attn.kv_a_proj_with_mqa.weight").T
        c = _rms_norm(ckv[:, :r], W(p + "self_attn.kv_a_layernorm.weight"), eps)
        kv = (c @ W(p + "self_attn.kv_b_proj.weight").T).view(T, H, dn + dv)
        q_pe = _apply_rotary(q[..., dn:], cos, sin)
        k_pe = _apply_rotary(ckv[:, None, r:], cos, sin)
        qs = torch.cat((q[..., :dn], q_pe), -1).transpose(0, 1)                   # (H, T, dq)
        ks = torch.cat((kv[..., :dn], k_pe.expand(T, H, dr)), -1).transpose(0, 1)
        vs = kv[..., dn:].transpose(0, 1)
        attn = torch.empty(H, T, dv, device=dev)
        for s in range(0, T, q_block):
            e = min(T, s + q_block)
            sc = (qs[:, s:e] @ ks[:, :e].transpose(1, 2)) * scale
            future = torch.arange(e, device=dev)[None, :] > torch.arange(s, e, device=dev)[:, None]
            sc = sc.masked_fill(future, float("-inf"))
            attn[:, s:e] = torch.softmax(sc, dim=-1) @ vs[:, :e]
        x = x + attn.transpose(0, 1).reshape(T, H * dv) @ W(p + "self_attn.o_proj.weight").T
        h = _rms_norm(x, W(p + "post_attention_layernorm.weight"), eps)
        m = p + "mlp."
        moe = (E and i >= cfg["first_k_dense_replace"] and i % cfg["moe_layer_freq"] == 0)
        if not moe:
            x = x + _mlp(h, W(m + "gate_proj.weight"), W(m + "up_proj.weight"),
                         W(m + "down_proj.weight"))
            continue
        scores = torch.softmax(h @ W(m + "gate.weight").T, dim=-1)
        top_w, top_i = torch.topk(scores, k, dim=-1)
        if cfg["norm_topk_prob"]:
            top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-20)
        else:
            top_w = top_w * cfg["routed_scaling_factor"]
        routed = torch.zeros_like(h)
        for j in range(E):
            tok, slot = (top_i == j).nonzero(as_tuple=True)
            if tok.numel():
                e_ = f"{m}experts.{j}."
                y = _mlp(h[tok], W(e_ + "gate_proj.weight"), W(e_ + "up_proj.weight"),
                         W(e_ + "down_proj.weight"))
                routed.index_add_(0, tok, y * top_w[tok, slot, None])
        s_ = m + "shared_experts."
        x = x + routed + _mlp(h, W(s_ + "gate_proj.weight"), W(s_ + "up_proj.weight"),
                              W(s_ + "down_proj.weight"))
    if positions is not None:
        x = x[positions]
    x = _rms_norm(x, W("model.norm.weight"), eps)
    return x @ W("lm_head.weight").T
