"""Operations and bytes of DeepSeek-V2's work, from a configuration file's
shapes (the published keys), for ``notes.mfu`` and
``llm.decode_roofline``.

Model FLOPs are two a weight a token of the weights the token uses (the
attention projections with ``kv_b_proj`` once a token, the dense MLP or
the shared experts, the router and the token's top-k experts, the head)
plus attention's two products over the positions it attends, counted in
the expanded form, ``2 * heads * (qk + v head dims)`` a position a layer,
whatever form the program computes.  A shared prefix is work done once.

A decode step must read, at the least: every weight outside the routed
experts (attention, the dense MLP, the shared experts, the routers, the
norms, the head), each routed expert some row chose once, and each valid
latent-cache token its rows attend once (a group's shared prefix once,
whatever its rows); the embedding rows and the activations are left out.
"""
from __future__ import annotations

from .counts import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S  # noqa: F401 (the peaks the metrics use)

BYTES = 2  # bfloat16


def _is_moe(cfg: dict, i: int) -> bool:
    return bool(cfg["n_routed_experts"]) and i >= cfg["first_k_dense_replace"] and (
        i % cfg["moe_layer_freq"] == 0)


def moe_layers(cfg: dict) -> int:
    return sum(_is_moe(cfg, i) for i in range(cfg["num_hidden_layers"]))


def attn_params(cfg: dict) -> int:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    r = cfg["kv_lora_rank"]
    return (d * h * qk + d * (r + cfg["qk_rope_head_dim"]) + r * h * (cfg["qk_nope_head_dim"]
            + cfg["v_head_dim"]) + h * cfg["v_head_dim"] * d)


def expert_params(cfg: dict) -> int:
    return 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def dense_params(cfg: dict) -> int:
    """Every weight a decode step reads whatever the routing: all but the
    routed experts and the embedding."""
    d, layers = cfg["hidden_size"], cfg["num_hidden_layers"]
    n_moe = moe_layers(cfg)
    shared = expert_params(cfg) * cfg["n_shared_experts"] + d * cfg["n_routed_experts"]
    dense_mlp = 3 * d * cfg["intermediate_size"]
    norms = layers * 2 * d + layers * cfg["kv_lora_rank"] + d
    return (layers * attn_params(cfg) + n_moe * shared + (layers - n_moe) * dense_mlp + norms
            + d * cfg["vocab_size"])


def active_params(cfg: dict) -> int:
    """Weights one token uses (embedding row left out)."""
    return dense_params(cfg) + moe_layers(cfg) * cfg["num_experts_per_tok"] * expert_params(cfg)


def token_flops(cfg: dict, ctx: int) -> int:
    """One token attending ``ctx`` positions (itself included)."""
    h = cfg["num_attention_heads"]
    dq = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    return 2 * active_params(cfg) + 2 * cfg["num_hidden_layers"] * h * (dq + cfg["v_head_dim"]) * ctx


def span_flops(cfg: dict, first_ctx: int, n: int) -> int:
    """n consecutive tokens, the first attending ``first_ctx`` positions."""
    if n <= 0:
        return 0
    ctx_sum = n * first_ctx + n * (n - 1) // 2
    h = cfg["num_attention_heads"]
    dq = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    return 2 * active_params(cfg) * n + 2 * cfg["num_hidden_layers"] * h * (
        dq + cfg["v_head_dim"]) * ctx_sum


def common_prefix(rows: list[list[int]]) -> int:
    n = min(len(r) for r in rows)
    for i in range(n):
        if any(r[i] != rows[0][i] for r in rows[1:]):
            return i
    return n


def group_flops(cfg: dict, rows: list[tuple[list[int], list[int]]]) -> int:
    """A group of (prompt, generated) rows whose prompts share a prefix:
    the prefix once, then each row's own prompt and its generated tokens
    (the last generated token is never fed back)."""
    shared = min(common_prefix([p for p, _ in rows]), min(len(p) for p, _ in rows) - 1)
    total = span_flops(cfg, 1, shared)
    for p, g in rows:
        total += span_flops(cfg, shared + 1, len(p) - shared + max(len(g) - 1, 0))
    return total


def decode_bytes(cfg: dict, steps: int, experts_touched: int, cache_tokens: int) -> int:
    """What the decode steps must read (see the module's note)."""
    latent = (cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]) * cfg["num_hidden_layers"]
    return BYTES * (steps * dense_params(cfg) + experts_touched * expert_params(cfg)
                    + cache_tokens * latent)
