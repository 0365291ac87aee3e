"""The language models' parameters: the published checkpoints' names,
seeded weights.

``params_from_hf`` maps a state dict under the published names
(``model.layers.{i}.self_attn.kv_a_proj_with_mqa.weight``, ...,
``lm_head.weight``) into the port's tree (``model.py``): linears
transposed to (d_in, d_out), gate and up side by side, the routed experts
stacked, ``kv_b_proj`` split per head into ``W_UK`` and ``W_UV``.
Kimi-Linear's names are those of ``modeling_kimi.py`` (no checkpoint is in
the repository to check them against): its KDA layers' ``q_proj``,
``k_proj``, ``v_proj`` side by side, the three convolutions' weights as one
(3W, width), ``f_a_proj``, ``g_a_proj`` and ``b_proj`` side by side,
``A_log``, ``dt_bias`` and the router's ``e_score_correction_bias`` in
float32; its experts under ``block_sparse_moe.experts.{j}.w1`` (gate),
``w3`` (up) and ``w2`` (down).  Only the experts of ``cfg.expert_range``
are read.  ``to_hf`` is its inverse, as views of the tree where it can be
(all but ``kv_b_proj``).
``random_params`` draws a tree from a seed in one call on the device, for
runs without a checkpoint.
"""
from __future__ import annotations

import math

import torch

from .config import DeepseekV2Config

_ATTN = "model.layers.{i}.self_attn."
_MLP = "model.layers.{i}.mlp."


def _t(w: torch.Tensor) -> torch.Tensor:
    return w.t().contiguous()


_MOE = "model.layers.{i}.block_sparse_moe."
# expert projections under Kimi's names: (gate, up, down)
_KIMI_EXPERT = ("w1.weight", "w3.weight", "w2.weight")
_DEEPSEEK_EXPERT = ("gate_proj.weight", "up_proj.weight", "down_proj.weight")
_FP32 = ("A_log", "dt_bias", "router_bias")  # leaves kept in float32 whatever the weights' type


def params_from_hf(sd: dict, cfg: DeepseekV2Config, device=None, dtype=None) -> dict:
    """The port's tree from a state dict under the published names."""
    nh, dn, dv, r = (cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.v_head_dim,
                     cfg.kv_lora_rank)
    kimi = cfg.family == "kimi_linear"
    e0, e1 = cfg.expert_range

    def get(name, fp32=False):
        w = sd[name]
        return w.to(device=device, dtype=torch.float32 if fp32 else (dtype or w.dtype))

    def gate_up(prefix, names=_DEEPSEEK_EXPERT):
        return torch.cat((_t(get(prefix + names[0])), _t(get(prefix + names[1]))), 1)

    layers = []
    for i, kind in enumerate(cfg.layer_kinds):
        a = _ATTN.format(i=i)
        m = (_MOE if kimi and cfg.is_moe(i) else _MLP).format(i=i)
        lp = {"attn_norm": get(f"model.layers.{i}.input_layernorm.weight"),
              "mlp_norm": get(f"model.layers.{i}.post_attention_layernorm.weight"),
              "o": _t(get(a + "o_proj.weight"))}
        if kind == "kda":
            lp.update(
                qkv=torch.cat([_t(get(a + f"{x}_proj.weight")) for x in "qkv"], 1),
                conv=torch.cat([get(a + f"{x}_conv1d.weight")[:, 0] for x in "qkv"]),
                ab=torch.cat([_t(get(a + f"{x}_proj.weight")) for x in ("f_a", "g_a", "b")], 1),
                f_b=_t(get(a + "f_b_proj.weight")), g_b=_t(get(a + "g_b_proj.weight")),
                A_log=get(a + "A_log", True).reshape(-1), dt_bias=get(a + "dt_bias", True),
                o_norm=get(a + "o_norm.weight"))
        else:
            kv_b = get(a + "kv_b_proj.weight").view(nh, dn + dv, r)
            lp.update(q=_t(get(a + "q_proj.weight")),
                      kv_a=_t(get(a + "kv_a_proj_with_mqa.weight")),
                      kv_norm=get(a + "kv_a_layernorm.weight"), w_uk=kv_b[:, :dn].contiguous(),
                      w_uv=kv_b[:, dn:].transpose(1, 2).contiguous())
        if cfg.is_moe(i):
            names = _KIMI_EXPERT if kimi else _DEEPSEEK_EXPERT
            lp["router"] = _t(get(m + "gate.weight"))
            if kimi:
                lp["router_bias"] = get(m + "gate.e_score_correction_bias", True)
            lp["experts_gate_up"] = torch.stack(
                [gate_up(f"{m}experts.{j}.", names) for j in range(e0, e1)])
            lp["experts_down"] = torch.stack(
                [_t(get(f"{m}experts.{j}.{names[2]}")) for j in range(e0, e1)])
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
    kimi = cfg.family == "kimi_linear"
    e0, _ = cfg.expert_range
    sd = {"model.embed_tokens.weight": params["embed"], "model.norm.weight": params["norm"],
          "lm_head.weight": params["head"].t()}

    def mlp_names(prefix, gate_up, down, names=_DEEPSEEK_EXPERT):
        f = down.shape[-2]
        sd[prefix + names[0]] = gate_up[..., :f].transpose(-1, -2)
        sd[prefix + names[1]] = gate_up[..., f:].transpose(-1, -2)
        sd[prefix + names[2]] = down.transpose(-1, -2)

    def split(w, name_of, widths):
        for x, part in zip(name_of, w.split(widths, -1)):
            sd[x] = part.t()

    for i, lp in enumerate(params["layers"]):
        a = _ATTN.format(i=i)
        m = (_MOE if kimi and "router" in lp else _MLP).format(i=i)
        sd[f"model.layers.{i}.input_layernorm.weight"] = lp["attn_norm"]
        sd[f"model.layers.{i}.post_attention_layernorm.weight"] = lp["mlp_norm"]
        sd[a + "o_proj.weight"] = lp["o"].t()
        if "qkv" in lp:
            W, D = lp["f_b"].shape[1], lp["f_b"].shape[0]
            split(lp["qkv"], [a + f"{x}_proj.weight" for x in "qkv"], [W] * 3)
            split(lp["ab"], [a + f"{x}_proj.weight" for x in ("f_a", "g_a", "b")],
                  [D, D, lp["ab"].shape[1] - 2 * D])
            for x, part in zip("qkv", lp["conv"].split(W)):
                sd[a + f"{x}_conv1d.weight"] = part[:, None]
            sd[a + "f_b_proj.weight"] = lp["f_b"].t()
            sd[a + "g_b_proj.weight"] = lp["g_b"].t()
            sd[a + "A_log"] = lp["A_log"].view(1, 1, -1, 1)
            sd[a + "dt_bias"] = lp["dt_bias"]
            sd[a + "o_norm.weight"] = lp["o_norm"]
        else:
            sd[a + "q_proj.weight"] = lp["q"].t()
            sd[a + "kv_a_proj_with_mqa.weight"] = lp["kv_a"].t()
            sd[a + "kv_a_layernorm.weight"] = lp["kv_norm"]
            sd[a + "kv_b_proj.weight"] = torch.cat(
                (lp["w_uk"], lp["w_uv"].transpose(1, 2)), 1).reshape(-1, r)
        if "router" in lp:
            sd[m + "gate.weight"] = lp["router"].t()
            if kimi:
                sd[m + "gate.e_score_correction_bias"] = lp["router_bias"]
            for j in range(lp["experts_down"].shape[0]):
                mlp_names(f"{m}experts.{e0 + j}.", lp["experts_gate_up"][j],
                          lp["experts_down"][j], _KIMI_EXPERT if kimi else _DEEPSEEK_EXPERT)
            mlp_names(m + "shared_experts.", lp["shared_gate_up"], lp["shared_down"])
        else:
            mlp_names(m, lp["gate_up"], lp["down"])
    return sd


def param_spec(cfg: DeepseekV2Config) -> list[tuple[tuple, tuple, str, float]]:
    """(path, shape, kind, scale) of every leaf of the port's tree: linears
    normal / sqrt(d_in), norms 1 + scale * normal, the embedding normal;
    KDA's ``A_log`` the log of a uniform draw over [1, 16] and ``dt_bias``
    the inverse softplus of a log-uniform draw over [0.001, 0.1] (the
    published initialisations), the router's bias scale * normal.  Only
    the held experts (``cfg.expert_range``) are leaves."""
    d, nh, r = cfg.hidden_size, cfg.num_attention_heads, cfg.kv_lora_rank
    dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    e = cfg.expert_range[1] - cfg.expert_range[0]
    out = [(("embed",), (cfg.vocab_size, d), "normal", 1.0)]

    def lin(path, shape):
        out.append((path, shape, "normal", 1.0 / math.sqrt(shape[-2])))

    for i, kind in enumerate(cfg.layer_kinds):
        p = ("layers", i)
        out += [(p + ("attn_norm",), (d,), "one_plus", 0.1),
                (p + ("mlp_norm",), (d,), "one_plus", 0.1)]
        if kind == "kda":
            H, D = cfg.kda_num_heads, cfg.kda_head_dim
            lin(p + ("qkv",), (d, 3 * H * D))
            out.append((p + ("conv",), (3 * H * D, cfg.conv_size), "normal",
                        1.0 / math.sqrt(cfg.conv_size)))
            lin(p + ("ab",), (d, 2 * D + H))
            lin(p + ("f_b",), (D, H * D))
            lin(p + ("g_b",), (D, H * D))
            out += [(p + ("A_log",), (H,), "a_log", 1.0),
                    (p + ("dt_bias",), (H * D,), "dt_bias", 1.0),
                    (p + ("o_norm",), (D,), "one_plus", 0.1)]
            lin(p + ("o",), (H * D, d))
        else:
            out.append((p + ("kv_norm",), (r,), "one_plus", 0.1))
            lin(p + ("q",), (d, nh * cfg.q_head_dim))
            lin(p + ("kv_a",), (d, cfg.latent_dim))
            # W_UK maps the latent (rank r) to each head's keys, as kv_b_proj does
            out.append((p + ("w_uk",), (nh, dn, r), "normal", 1.0 / math.sqrt(r)))
            lin(p + ("w_uv",), (nh, r, dv))
            lin(p + ("o",), (nh * dv, d))
        if cfg.is_moe(i):
            fe, fs = cfg.moe_intermediate_size, cfg.moe_intermediate_size * cfg.n_shared_experts
            lin(p + ("router",), (d, cfg.n_routed_experts))
            if cfg.scoring == "sigmoid":
                out.append((p + ("router_bias",), (cfg.n_routed_experts,), "normal", 0.1))
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
    """A tree drawn from ``seed`` in one call on ``device`` (``param_spec``).
    Each leaf starts on a multiple of 8 values, so that every leaf is 16-byte
    aligned for the grouped products."""
    spec = param_spec(cfg)
    starts, off = [], 0
    for _, shape, _, _ in spec:
        starts.append(off)
        off = -(-(off + math.prod(shape)) // 8) * 8
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(off, generator=gen, device=device, dtype=dtype)
    tree: dict = {"layers": [{} for _ in range(cfg.num_hidden_layers)]}
    for (path, shape, kind, scale), off in zip(spec, starts):
        n = math.prod(shape)
        leaf = flat[off:off + n].view(shape).mul_(scale)
        if kind == "one_plus":
            leaf.add_(1.0)
        elif kind == "a_log":
            leaf = torch.log(1.0 + 15.0 * torch.special.ndtr(leaf.float()))
        elif kind == "dt_bias":
            dt = torch.exp(math.log(1e-3) + torch.special.ndtr(leaf.float()) * math.log(100.0))
            leaf = dt + torch.log(-torch.expm1(-dt))
        if path[-1] in _FP32:
            leaf = leaf.float()
        node = tree
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = leaf
    return tree
