"""DeepSeek-V2 configuration, read from the published ``config.json`` keys.

The port runs the DeepSeek-V2 block: multi-head latent attention (MLA)
without a query low-rank path, YaRN rotary positions, a dense SwiGLU MLP in
the first ``first_k_dense_replace`` layers and a softmax-routed mixture of
experts with shared experts after them.  ``from_dict`` takes the keys of the
published file and refuses the variants the port does not compute (a query
LoRA, group-limited routing, another scoring function), so a configuration
never runs under a mechanism it does not have.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, fields


@dataclass(frozen=True)
class DeepseekV2Config:
    name: str = "deepseek-v2-lite"
    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    max_position_embeddings: int = 163840
    # YaRN (``rope_scaling`` of the published file)
    rope_factor: float = 40.0
    rope_original_max_position: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 0.707
    rope_mscale_all_dim: float = 0.707
    norm_topk_prob: bool = False
    routed_scaling_factor: float = 1.0
    # DeepSeek-V2-Chat's special tokens (the tokenizer's, not config.json's)
    bos_token_id: int = 100000
    eos_token_id: int = 100001

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Values a token and layer in the latent cache: the normalised
        ``c_kv`` and the roped ``k_pe``."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def softmax_scale(self) -> float:
        """``q_head_dim ** -0.5``, times YaRN's mscale squared
        (``DeepseekV2Attention.__init__``)."""
        scale = self.q_head_dim ** -0.5
        if self.rope_mscale_all_dim:
            m = yarn_mscale(self.rope_factor, self.rope_mscale_all_dim)
            scale *= m * m
        return scale

    def is_moe(self, layer: int) -> bool:
        return (self.n_routed_experts > 0 and layer >= self.first_k_dense_replace
                and layer % self.moe_layer_freq == 0)

    @property
    def moe_layers(self) -> int:
        return sum(self.is_moe(i) for i in range(self.num_hidden_layers))

    @classmethod
    def from_dict(cls, d: dict, name: str | None = None) -> "DeepseekV2Config":
        """The published keys (``config.json``) -> the config; raises on a
        variant the port does not compute."""
        refused = {
            "q_lora_rank": (d.get("q_lora_rank"), None),
            "scoring_func": (d.get("scoring_func", "softmax"), "softmax"),
            "topk_method": (d.get("topk_method", "greedy"), "greedy"),
            "n_group": (d.get("n_group", 1) or 1, 1),
            "hidden_act": (d.get("hidden_act", "silu"), "silu"),
            "attention_bias": (d.get("attention_bias", False), False),
            "tie_word_embeddings": (d.get("tie_word_embeddings", False), False),
        }
        for key, (got, want) in refused.items():
            if got != want:
                raise NotImplementedError(f"{key}={got!r}: the port computes only {want!r}")
        rs = d.get("rope_scaling") or {}
        if rs and rs.get("type", "yarn") != "yarn":
            raise NotImplementedError(f"rope_scaling type {rs.get('type')!r}")
        kw = {f.name: d[f.name] for f in fields(cls) if f.name in d}
        kw.update(
            name=name or d.get("name", cls.name),
            rope_factor=rs.get("factor", 1.0),
            rope_original_max_position=rs.get("original_max_position_embeddings",
                                              d.get("max_position_embeddings", 4096)),
            rope_beta_fast=rs.get("beta_fast", 32), rope_beta_slow=rs.get("beta_slow", 1),
            rope_mscale=rs.get("mscale", 1), rope_mscale_all_dim=rs.get("mscale_all_dim", 0),
        )
        return cls(**kw)


def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    """``yarn_get_mscale`` of ``modeling_deepseek.py``."""
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


PRESETS = {
    # the published DeepSeek-V2-Lite (config.json of deepseek-ai/DeepSeek-V2-Lite)
    "deepseek-v2-lite": DeepseekV2Config(),
    # the CPU tests' size: every mechanism, tiny widths, prompts can pass
    # the original context (32) so YaRN's ramp is exercised
    "tiny": DeepseekV2Config(
        name="tiny", vocab_size=512, hidden_size=64, intermediate_size=96,
        moe_intermediate_size=32, num_hidden_layers=3, num_attention_heads=4,
        n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2,
        kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        max_position_embeddings=1280, rope_original_max_position=32,
        bos_token_id=500, eos_token_id=501),
}


def get_config(name: str) -> DeepseekV2Config:
    try:
        return PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown language model {name!r}; known: {sorted(PRESETS)}") from None
