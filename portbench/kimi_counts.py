"""Operations and bytes of Kimi-Linear's work, from a configuration
file's shapes (the published keys, with the held share of the experts),
for ``notes.mfu``, ``kda.prefill_roofline``, ``kda.decode_roofline`` and
``kimi.decode_roofline``.

Model FLOPs are two a weight a token of the weights the token uses on
this card, plus each attention's products.  The card holds 128 of each
MoE layer's 256 experts, and the router picks 8 of the 256 a token: the
held share's expected picks are 8 x 128/256 = 4 a token, so a token uses
the attention projections, the dense MLP or the shared expert and the
router, 4 held experts, and the head.  Attention adds, per token, the MLA
layers' two products over the positions it attends, ``2 * heads * (qk +
v head dims)`` a position (NoPE: qk is 128 + 64), and the KDA layers'
state products, ``6 * K * V`` a head (S^T k, k u^T and S^T q).  A shared
prefix is work done once.

``kda_chunk_state`` (the prefill's pass, ``ops/kernels/kda.py``) reads,
per token, head and KDA layer, its rows of W_k, Q~ and K^ (K float32 each),
W_v and writes O (V each), reads its row of P (64) and, per chunk, the
decay (K): about 2.8 KB; it computes W_k S, Q~ S, K^^T U (2 K V each) and
its causal half of P U (64 V).  ``kda_step`` reads and writes a row's
state (K x V float32) per head and layer, reads q, k, g (K), v (V) and
beta, and writes o (V).

A decode step must read, at the least: every weight outside the routed
experts (the embedding left out), each held expert some row chose once,
each valid latent-cache token of the MLA layers once (a group's shared
prefix once), and the KDA states and windows of the active rows, read and
written (``llm.kda.state_bytes``).
"""
from __future__ import annotations

from .counts import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S  # noqa: F401 (the peaks the metrics use)
from .llm_counts import common_prefix

BYTES = 2  # bfloat16
F32 = 4
CHUNK = 64


def _la(cfg: dict) -> dict:
    return cfg["linear_attn_config"]


def mla_layers(cfg: dict) -> int:
    return len(_la(cfg)["full_attn_layers"])


def kda_layers(cfg: dict) -> int:
    return cfg["num_hidden_layers"] - mla_layers(cfg)


def moe_layers(cfg: dict) -> int:
    return sum(i >= cfg["first_k_dense_replace"] and i % cfg["moe_layer_freq"] == 0
               for i in range(cfg["num_hidden_layers"]))


def kda_width(cfg: dict) -> int:
    return _la(cfg)["num_heads"] * _la(cfg)["head_dim"]


def kda_params(cfg: dict) -> int:
    d, la = cfg["hidden_size"], _la(cfg)
    H, D, cw = la["num_heads"], la["head_dim"], la["short_conv_kernel_size"]
    W = H * D
    return 3 * d * W + 3 * W * cw + d * (2 * D + H) + 2 * D * W + H + W + D + W * d


def mla_params(cfg: dict) -> int:
    d, h, r = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    return (d * h * qk + d * (r + cfg["qk_rope_head_dim"]) + r
            + r * h * (cfg["qk_nope_head_dim"] + cfg["v_head_dim"]) + h * cfg["v_head_dim"] * d)


def expert_params(cfg: dict) -> int:
    return 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def dense_params(cfg: dict) -> int:
    """Every weight a decode step reads whatever the routing: all but the
    routed experts and the embedding."""
    d, layers = cfg["hidden_size"], cfg["num_hidden_layers"]
    n_moe = moe_layers(cfg)
    n_pub = cfg.get("experts_published", cfg["num_experts"])
    shared = expert_params(cfg) * cfg["num_shared_experts"] + d * n_pub + n_pub
    dense_mlp = 3 * d * cfg["intermediate_size"]
    return (kda_layers(cfg) * kda_params(cfg) + mla_layers(cfg) * mla_params(cfg)
            + n_moe * shared + (layers - n_moe) * dense_mlp + layers * 2 * d + d
            + d * cfg["vocab_size"])


def held_picks(cfg: dict) -> float:
    """The experts a token is expected to use on this card."""
    n_pub = cfg.get("experts_published", cfg["num_experts"])
    return cfg["num_experts_per_token"] * cfg["num_experts"] / n_pub


def active_params(cfg: dict) -> float:
    return dense_params(cfg) + moe_layers(cfg) * held_picks(cfg) * expert_params(cfg)


def span_flops(cfg: dict, first_ctx: int, n: int) -> float:
    """n consecutive tokens, the first attending ``first_ctx`` positions."""
    if n <= 0:
        return 0
    ctx_sum = n * first_ctx + n * (n - 1) // 2
    h = cfg["num_attention_heads"]
    dq = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    kda_tok = 6 * kda_width(cfg) * _la(cfg)["head_dim"] * kda_layers(cfg)
    return ((2 * active_params(cfg) + kda_tok) * n
            + 2 * mla_layers(cfg) * h * (dq + cfg["v_head_dim"]) * ctx_sum)


def group_flops(cfg: dict, rows: list[tuple[list[int], list[int]]]) -> float:
    """A group of (prompt, generated) rows whose prompts share a prefix:
    the prefix once, then each row's own prompt and its generated tokens
    (the last generated token is never fed back)."""
    shared = min(common_prefix([p for p, _ in rows]), min(len(p) for p, _ in rows) - 1)
    total = span_flops(cfg, 1, shared)
    for p, g in rows:
        total += span_flops(cfg, shared + 1, len(p) - shared + max(len(g) - 1, 0))
    return total


def chunk_state_bound_s(cfg: dict, tokens: int) -> float:
    """The least time ``kda_chunk_state`` could take over ``tokens``: its
    bytes at the HBM rate or its float32 products at the bf16 tensor
    rate, whichever is larger."""
    la = _la(cfg)
    K = V = la["head_dim"]
    per = la["num_heads"] * kda_layers(cfg) * tokens
    n_bytes = per * F32 * (3 * K + 2 * V + CHUNK + K / CHUNK)
    flops = per * (6 * K * V + CHUNK * V)
    return max(n_bytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def row_state_bytes(cfg: dict) -> int:
    """One sequence's KDA state (float32) and windows (bfloat16), every layer."""
    la = _la(cfg)
    D, cw = la["head_dim"], la["short_conv_kernel_size"]
    return kda_layers(cfg) * (la["num_heads"] * D * D * F32 + (cw - 1) * 3 * kda_width(cfg) * BYTES)


def step_kernel_bytes(cfg: dict, state_bytes: int) -> float:
    """``kda_step``'s bytes over the steps whose states and windows moved
    ``state_bytes`` (``llm.kda.state_bytes``: twice a row's a row-step)."""
    la = _la(cfg)
    H, D = la["num_heads"], la["head_dim"]
    row_steps = state_bytes / (2 * row_state_bytes(cfg))
    return row_steps * kda_layers(cfg) * H * F32 * (2 * D * D + 3 * D + 2 * D + 1)


def decode_bytes(cfg: dict, steps: int, experts_touched: int, cache_tokens: int,
                 state_bytes: int) -> int:
    """What the decode steps must read and write (see the module's note)."""
    latent = (cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]) * mla_layers(cfg)
    return (BYTES * (steps * dense_params(cfg) + experts_touched * expert_params(cfg)
                     + cache_tokens * latent) + state_bytes)
