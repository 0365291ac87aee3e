"""DeepSeek-V2 parameters: the published checkpoint's names, seeded weights.

``params_from_hf`` maps a state dict under the published names
(``model.layers.{i}.self_attn.kv_a_proj_with_mqa.weight``, ...,
``lm_head.weight``) into the port's tree (``model.py``): linears
transposed to (d_in, d_out), gate and up side by side, the routed experts
stacked, ``kv_b_proj`` split per head into ``W_UK`` and ``W_UV``.
``to_hf`` is its inverse, as views of the tree where it can be (all but
``kv_b_proj``).  ``random_params`` draws a tree from a seed in one call on
the device, for runs without a checkpoint.
"""
from __future__ import annotations

import math

import torch

from .config import DeepseekV2Config

_ATTN = "model.layers.{i}.self_attn."
_MLP = "model.layers.{i}.mlp."


def _t(w: torch.Tensor) -> torch.Tensor:
    return w.t().contiguous()


def params_from_hf(sd: dict, cfg: DeepseekV2Config, device=None, dtype=None) -> dict:
    """The port's tree from a state dict under the published names."""
    nh, dn, dv, r = (cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.v_head_dim,
                     cfg.kv_lora_rank)

    def get(name):
        w = sd[name]
        return w.to(device=device, dtype=dtype or w.dtype)

    def gate_up(prefix):
        return torch.cat((_t(get(prefix + "gate_proj.weight")),
                          _t(get(prefix + "up_proj.weight"))), 1)

    layers = []
    for i in range(cfg.num_hidden_layers):
        a, m = _ATTN.format(i=i), _MLP.format(i=i)
        kv_b = get(a + "kv_b_proj.weight").view(nh, dn + dv, r)
        lp = {
            "attn_norm": get(f"model.layers.{i}.input_layernorm.weight"),
            "mlp_norm": get(f"model.layers.{i}.post_attention_layernorm.weight"),
            "q": _t(get(a + "q_proj.weight")),
            "kv_a": _t(get(a + "kv_a_proj_with_mqa.weight")),
            "kv_norm": get(a + "kv_a_layernorm.weight"),
            "w_uk": kv_b[:, :dn].contiguous(),
            "w_uv": kv_b[:, dn:].transpose(1, 2).contiguous(),
            "o": _t(get(a + "o_proj.weight")),
        }
        if cfg.is_moe(i):
            lp["router"] = _t(get(m + "gate.weight"))
            lp["experts_gate_up"] = torch.stack(
                [gate_up(f"{m}experts.{j}.") for j in range(cfg.n_routed_experts)])
            lp["experts_down"] = torch.stack(
                [_t(get(f"{m}experts.{j}.down_proj.weight")) for j in range(cfg.n_routed_experts)])
            lp["shared_gate_up"] = gate_up(m + "shared_experts.")
            lp["shared_down"] = _t(get(m + "shared_experts.down_proj.weight"))
        else:
            lp["gate_up"] = gate_up(m)
            lp["down"] = _t(get(m + "down_proj.weight"))
        layers.append(lp)
    return {"embed": get("model.embed_tokens.weight"), "norm": get("model.norm.weight"),
            "head": _t(get("lm_head.weight")), "layers": layers}


def to_hf(params: dict, cfg: DeepseekV2Config) -> dict:
    """The published names over the port's tree: transposed views, and a
    copy for each ``kv_b_proj``."""
    r = cfg.kv_lora_rank
    sd = {"model.embed_tokens.weight": params["embed"], "model.norm.weight": params["norm"],
          "lm_head.weight": params["head"].t()}

    def mlp_names(prefix, gate_up, down):
        f = down.shape[-2]
        sd[prefix + "gate_proj.weight"] = gate_up[..., :f].transpose(-1, -2)
        sd[prefix + "up_proj.weight"] = gate_up[..., f:].transpose(-1, -2)
        sd[prefix + "down_proj.weight"] = down.transpose(-1, -2)

    for i, lp in enumerate(params["layers"]):
        a, m = _ATTN.format(i=i), _MLP.format(i=i)
        sd[f"model.layers.{i}.input_layernorm.weight"] = lp["attn_norm"]
        sd[f"model.layers.{i}.post_attention_layernorm.weight"] = lp["mlp_norm"]
        sd[a + "q_proj.weight"] = lp["q"].t()
        sd[a + "kv_a_proj_with_mqa.weight"] = lp["kv_a"].t()
        sd[a + "kv_a_layernorm.weight"] = lp["kv_norm"]
        sd[a + "kv_b_proj.weight"] = torch.cat(
            (lp["w_uk"], lp["w_uv"].transpose(1, 2)), 1).reshape(-1, r)
        sd[a + "o_proj.weight"] = lp["o"].t()
        if "router" in lp:
            sd[m + "gate.weight"] = lp["router"].t()
            for j in range(cfg.n_routed_experts):
                mlp_names(f"{m}experts.{j}.", lp["experts_gate_up"][j], lp["experts_down"][j])
            mlp_names(m + "shared_experts.", lp["shared_gate_up"], lp["shared_down"])
        else:
            mlp_names(m, lp["gate_up"], lp["down"])
    return sd


def param_spec(cfg: DeepseekV2Config) -> list[tuple[tuple, tuple, str, float]]:
    """(path, shape, kind, scale) of every leaf of the port's tree: linears
    normal / sqrt(d_in), norms 1 + scale * normal, the embedding normal."""
    d, nh, r = cfg.hidden_size, cfg.num_attention_heads, cfg.kv_lora_rank
    dn, dv, e = cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.n_routed_experts
    out = [(("embed",), (cfg.vocab_size, d), "normal", 1.0)]

    def lin(path, shape):
        out.append((path, shape, "normal", 1.0 / math.sqrt(shape[-2])))

    for i in range(cfg.num_hidden_layers):
        p = ("layers", i)
        out += [(p + ("attn_norm",), (d,), "one_plus", 0.1),
                (p + ("mlp_norm",), (d,), "one_plus", 0.1),
                (p + ("kv_norm",), (r,), "one_plus", 0.1)]
        lin(p + ("q",), (d, nh * cfg.q_head_dim))
        lin(p + ("kv_a",), (d, cfg.latent_dim))
        # W_UK maps the latent (rank r) to each head's keys, as kv_b_proj does
        out.append((p + ("w_uk",), (nh, dn, r), "normal", 1.0 / math.sqrt(r)))
        lin(p + ("w_uv",), (nh, r, dv))
        lin(p + ("o",), (nh * dv, d))
        if cfg.is_moe(i):
            fe, fs = cfg.moe_intermediate_size, cfg.moe_intermediate_size * cfg.n_shared_experts
            lin(p + ("router",), (d, e))
            lin(p + ("experts_gate_up",), (e, d, 2 * fe))
            lin(p + ("experts_down",), (e, fe, d))
            lin(p + ("shared_gate_up",), (d, 2 * fs))
            lin(p + ("shared_down",), (fs, d))
        else:
            lin(p + ("gate_up",), (d, 2 * cfg.intermediate_size))
            lin(p + ("down",), (cfg.intermediate_size, d))
    out.append((("norm",), (d,), "one_plus", 0.1))
    lin(("head",), (d, cfg.vocab_size))
    return out


def random_params(cfg: DeepseekV2Config, seed: int, device, dtype=torch.bfloat16) -> dict:
    """A tree drawn from ``seed`` in one call on ``device`` (``param_spec``)."""
    spec = param_spec(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(sum(math.prod(s) for _, s, _, _ in spec), generator=gen,
                       device=device, dtype=dtype)
    tree: dict = {"layers": [{} for _ in range(cfg.num_hidden_layers)]}
    off = 0
    for path, shape, kind, scale in spec:
        n = math.prod(shape)
        leaf = flat[off:off + n].view(shape).mul_(scale)
        if kind == "one_plus":
            leaf.add_(1.0)
        off += n
        node = tree
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = leaf
    return tree
