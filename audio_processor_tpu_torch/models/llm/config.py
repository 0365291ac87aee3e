"""The language models' configurations, read from the published
``config.json`` keys.

The port runs two blocks:

- **DeepSeek-V2** (``DeepseekV2Config``): multi-head latent attention (MLA)
  without a query low-rank path, YaRN rotary positions, a dense SwiGLU MLP
  in the first ``first_k_dense_replace`` layers and a softmax-routed mixture
  of experts with shared experts after them;
- **Kimi-Linear** (``KimiLinearConfig``): Kimi Delta Attention (KDA, a
  gated delta rule with a per-channel decay and a short convolution) on
  most layers and MLA without positions (NoPE) on the others, the dense
  first layer, then experts routed by sigmoid scores plus a correction
  bias, renormalised and scaled.

Both give the model code one vocabulary: ``layer_kinds`` ("mla" or "kda"
a layer) and ``layer_slots`` (each layer's index into its kind's cache),
the router's ``scoring`` and ``route_scale``, and ``expert_range``, the
routed experts this process holds ([0, n) when it holds them all; a share
of an expert-parallel deployment otherwise).  ``from_dict`` takes the keys
of a published file and refuses the variants the port does not compute
(a query LoRA, group-limited routing, another scoring function), so a
configuration never runs under a mechanism it does not have.
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
    # [first, end) of the routed experts this process holds (None: all)
    experts_held: tuple[int, int] | None = None
    # the engine's bytes on the card above its weights at its largest call,
    # and that call's meetings at most (``integrations/local_llm.py``), on
    # an H100 80GB: 16 meetings of 30-60 min peaked at 43.04 GB with 31.41
    # GB of bf16 weights
    work_bytes: int = 12 * 10**9
    max_meetings: int = 16

    family = "deepseek_v2"  # the published checkpoint's names (``checkpoint.py``)
    scoring = "softmax"
    rope = True

    @property
    def route_scale(self) -> float:
        """The factor on the chosen experts' weights: DeepSeek-V2 scales
        them only when it does not renormalise (``MoEGate.forward``)."""
        return 1.0 if self.norm_topk_prob else self.routed_scaling_factor

    @property
    def expert_range(self) -> tuple[int, int]:
        return self.experts_held or (0, self.n_routed_experts)

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        return ("mla",) * self.num_hidden_layers

    @property
    def layer_slots(self) -> tuple[int, ...]:
        return tuple(range(self.num_hidden_layers))

    @property
    def mla_layers(self) -> int:
        return self.num_hidden_layers

    kda_layers = 0

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


@dataclass(frozen=True)
class KimiLinearConfig:
    """Kimi-Linear (``modeling_kimi.py``): KDA and NoPE MLA layers, a dense
    first layer, sigmoid-routed experts with one shared expert.

    ``n_routed_experts`` is the router's width (the published
    ``num_experts``); ``expert_range`` the experts this process holds and
    computes, the rest being other cards' share of an expert-parallel
    deployment (``models/llm/model.py`` ``moe``)."""

    name: str = "kimi-linear-48b-a3b"
    vocab_size: int = 163840
    hidden_size: int = 2304
    intermediate_size: int = 9216
    moe_intermediate_size: int = 1024
    num_hidden_layers: int = 27
    num_attention_heads: int = 32
    n_routed_experts: int = 256
    n_shared_experts: int = 1
    num_experts_per_tok: int = 8
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 1048576
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 2.446
    # KDA (``linear_attn_config``): heads, head size, convolution width, and
    # the 0-based layers that run full attention (MLA)
    kda_num_heads: int = 32
    kda_head_dim: int = 128
    conv_size: int = 4
    full_attn_layers: tuple[int, ...] = (3, 7, 11, 15, 19, 23, 26)
    experts_held: tuple[int, int] | None = (0, 128)
    # Kimi's special tokens (the tokenizer's; the catalog's config strips
    # them): [BOS] and <|im_end|>
    bos_token_id: int = 163584
    eos_token_id: int = 163586
    # as DeepSeek-V2's: 4 recordings of 3-8 h a call peaked at 65.77 GB over
    # the share's 51.13 GB of bf16 weights; no larger call was measured
    work_bytes: int = 15 * 10**9
    max_meetings: int = 4

    family = "kimi_linear"
    scoring = "sigmoid"
    rope = False  # mla_use_nope: no rotary positions, the 64 "rope" values plain

    @property
    def route_scale(self) -> float:
        """V3's rule: renormalise (``moe_renormalize``), then scale."""
        return self.routed_scaling_factor

    @property
    def expert_range(self) -> tuple[int, int]:
        return self.experts_held or (0, self.n_routed_experts)

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def softmax_scale(self) -> float:
        return self.q_head_dim ** -0.5

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        return tuple("mla" if i in self.full_attn_layers else "kda"
                     for i in range(self.num_hidden_layers))

    @property
    def layer_slots(self) -> tuple[int, ...]:
        seen = {"mla": 0, "kda": 0}
        out = []
        for kind in self.layer_kinds:
            out.append(seen[kind])
            seen[kind] += 1
        return tuple(out)

    @property
    def mla_layers(self) -> int:
        return len(self.full_attn_layers)

    @property
    def kda_layers(self) -> int:
        return self.num_hidden_layers - self.mla_layers

    def is_moe(self, layer: int) -> bool:
        return (self.n_routed_experts > 0 and layer >= self.first_k_dense_replace
                and layer % self.moe_layer_freq == 0)

    @property
    def moe_layers(self) -> int:
        return sum(self.is_moe(i) for i in range(self.num_hidden_layers))

    @classmethod
    def from_dict(cls, d: dict, name: str | None = None) -> "KimiLinearConfig":
        """The published keys -> the config; raises on a variant the port
        does not compute.  ``num_experts`` may be a held share: then
        ``experts_published`` gives the router's width and
        ``experts_held`` the share's [first, end)."""
        la = d["linear_attn_config"]
        refused = {
            "q_lora_rank": (d.get("q_lora_rank"), None),
            "mla_use_nope": (d.get("mla_use_nope"), True),
            "moe_router_activation_func": (d.get("moe_router_activation_func"), "sigmoid"),
            "num_expert_group": (d.get("num_expert_group", 1), 1),
            "topk_group": (d.get("topk_group", 1), 1),
            "moe_renormalize": (d.get("moe_renormalize", True), True),
            "hidden_act": (d.get("hidden_act", "silu"), "silu"),
            "tie_word_embeddings": (d.get("tie_word_embeddings", False), False),
            "num_key_value_heads": (d.get("num_key_value_heads"), d["num_attention_heads"]),
            "rope_scaling": (d.get("rope_scaling"), None),
            "num_nextn_predict_layers": (d.get("num_nextn_predict_layers", 0), 0),
        }
        for key, (got, want) in refused.items():
            if got != want:
                raise NotImplementedError(f"{key}={got!r}: the port computes only {want!r}")
        layers = d["num_hidden_layers"]
        full = tuple(i - 1 for i in la["full_attn_layers"])
        if sorted(full + tuple(i - 1 for i in la["kda_layers"])) != list(range(layers)):
            raise ValueError("linear_attn_config must give every layer one kind")
        n = d.get("experts_published", d["num_experts"])
        held = tuple(d.get("experts_held", (0, d["num_experts"])))
        if held[1] - held[0] != d["num_experts"] or not 0 <= held[0] < held[1] <= n:
            raise ValueError(f"experts_held {held} is not a share of {n} experts "
                             f"holding num_experts={d['num_experts']}")
        return cls(
            name=name or d.get("name", cls.name), vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"], intermediate_size=d["intermediate_size"],
            moe_intermediate_size=d["moe_intermediate_size"], num_hidden_layers=layers,
            num_attention_heads=d["num_attention_heads"], n_routed_experts=n,
            n_shared_experts=d["num_shared_experts"],
            num_experts_per_tok=d["num_experts_per_token"],
            first_k_dense_replace=d["first_k_dense_replace"],
            moe_layer_freq=d["moe_layer_freq"], kv_lora_rank=d["kv_lora_rank"],
            qk_nope_head_dim=d["qk_nope_head_dim"], qk_rope_head_dim=d["qk_rope_head_dim"],
            v_head_dim=d["v_head_dim"], rms_norm_eps=d["rms_norm_eps"],
            max_position_embeddings=d.get("model_max_length", cls.max_position_embeddings),
            routed_scaling_factor=d["routed_scaling_factor"], kda_num_heads=la["num_heads"],
            kda_head_dim=la["head_dim"], conv_size=la["short_conv_kernel_size"],
            full_attn_layers=full, experts_held=None if held == (0, n) else held,
            **{k: d[k] for k in ("bos_token_id", "eos_token_id") if k in d})


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
    # the published Kimi-Linear-48B-A3B-Instruct as one card's share of a
    # two-card expert-parallel deployment: experts 0-127 of each layer's 256
    # (on a mesh ``split_bounds`` gives each rank its share)
    "kimi-linear-48b-a3b": KimiLinearConfig(),
    # the CPU tests' Kimi-Linear: two KDA layers, then NoPE MLA, then KDA
    # again; 8 experts top-2, all held
    "tiny-kimi": KimiLinearConfig(
        name="tiny-kimi", vocab_size=512, hidden_size=64, intermediate_size=96,
        moe_intermediate_size=32, num_hidden_layers=4, num_attention_heads=4,
        n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2, kv_lora_rank=32,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, max_position_embeddings=4096,
        kda_num_heads=2, kda_head_dim=16, full_attn_layers=(2,), experts_held=None,
        bos_token_id=500, eos_token_id=501),
}


def get_config(name: str) -> DeepseekV2Config | KimiLinearConfig:
    try:
        return PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown language model {name!r}; known: {sorted(PRESETS)}") from None


def on_mesh(cfg, mesh):
    """``cfg`` holding this model rank's share of the routed experts
    (``split_bounds`` over the mesh's model group); ``cfg`` itself off a
    mesh or with a model group of one."""
    import dataclasses

    from ...parallel.mesh import split_bounds

    if mesh is None or mesh.tp == 1:
        return cfg
    return dataclasses.replace(cfg, experts_held=split_bounds(cfg.n_routed_experts, mesh))
