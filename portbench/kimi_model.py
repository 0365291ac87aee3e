"""A Kimi-Linear configuration file -> seeded weights under the published
checkpoint's names, and the program's language-model client built from
them.

As ``portbench/llm_model.py`` does for DeepSeek-V2: each tensor of the
checkpoint (``modeling_kimi.py``'s names: ``model.layers.{i}.self_attn.
q_conv1d.weight``, ``...block_sparse_moe.experts.{j}.w1.weight``, ...,
``lm_head.weight``) is drawn on the card from --seed and its place in the
list, again at every read, so the reference reads the very tensors the
program was built from.  Linears are normal / sqrt(d_in) in bfloat16, the
convolutions normal / 2, norms 1 + 0.1 * normal, the embedding normal;
``A_log`` the log of a uniform draw over [1, 16] and ``dt_bias`` the
inverse softplus of a log-uniform draw over [0.001, 0.1] (the published
initialisations), the router's ``e_score_correction_bias`` 0.1 * normal,
those three in float32.  Only the experts the file holds
(``experts_held``) are in the list.  The program gets them through its
checkpoint loader (``checkpoint.params_from_hf``), and the client is the
program's ``LocalLLMClient`` over its ``Engine``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .llm_model import PublishedWeights

FP32_KINDS = ("a_log", "dt_bias", "bias")


def program_config(cfg: dict):
    """The program's config for a configuration file (published keys, the
    special ids from ``run``)."""
    import dataclasses

    from audio_processor_tpu_torch.models.llm.config import KimiLinearConfig

    conf = KimiLinearConfig.from_dict(cfg, name=cfg["name"])
    return dataclasses.replace(conf, bos_token_id=cfg["run"]["bos_token_id"],
                               eos_token_id=cfg["run"]["eos_token_id"])


def published_spec(cfg: dict) -> list[tuple[str, tuple, str, float]]:
    """(name, shape, kind, scale) of every held tensor of the checkpoint,
    in ``modeling_kimi.py``'s layout (linears (d_out, d_in))."""
    if cfg.get("q_lora_rank") is not None:
        raise ValueError("the benchmark draws q_proj only: q_lora_rank must be null")
    d, nh, r = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    la = cfg["linear_attn_config"]
    H, D, cw = la["num_heads"], la["head_dim"], la["short_conv_kernel_size"]
    full = {i - 1 for i in la["full_attn_layers"]}
    e0, e1 = cfg.get("experts_held", (0, cfg["num_experts"]))
    n_pub = cfg.get("experts_published", cfg["num_experts"])
    out = [("model.embed_tokens.weight", (cfg["vocab_size"], d), "normal", 1.0)]

    def lin(name, d_out, d_in):
        out.append((name, (d_out, d_in), "normal", 1.0 / math.sqrt(d_in)))

    def mlp(prefix, width, names=("gate_proj", "up_proj", "down_proj")):
        lin(f"{prefix}{names[0]}.weight", width, d)
        lin(f"{prefix}{names[1]}.weight", width, d)
        lin(f"{prefix}{names[2]}.weight", d, width)

    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        a = p + "self_attn."
        for norm in ("input_layernorm", "post_attention_layernorm"):
            out.append((p + norm + ".weight", (d,), "one_plus", 0.1))
        if i in full:
            out.append((a + "kv_a_layernorm.weight", (r,), "one_plus", 0.1))
            lin(a + "q_proj.weight", nh * (dn + dr), d)
            lin(a + "kv_a_proj_with_mqa.weight", r + dr, d)
            lin(a + "kv_b_proj.weight", nh * (dn + dv), r)
            lin(a + "o_proj.weight", d, nh * dv)
        else:
            for x in "qkv":
                lin(a + f"{x}_proj.weight", H * D, d)
                out.append((a + f"{x}_conv1d.weight", (H * D, 1, cw), "normal", 1 / math.sqrt(cw)))
            lin(a + "f_a_proj.weight", D, d)
            lin(a + "f_b_proj.weight", H * D, D)
            lin(a + "g_a_proj.weight", D, d)
            lin(a + "g_b_proj.weight", H * D, D)
            lin(a + "b_proj.weight", H, d)
            out += [(a + "A_log", (1, 1, H, 1), "a_log", 1.0),
                    (a + "dt_bias", (H * D,), "dt_bias", 1.0),
                    (a + "o_norm.weight", (D,), "one_plus", 0.1)]
            lin(a + "o_proj.weight", d, H * D)
        if i >= cfg["first_k_dense_replace"] and i % cfg["moe_layer_freq"] == 0:
            m = p + "block_sparse_moe."
            lin(m + "gate.weight", n_pub, d)
            out.append((m + "gate.e_score_correction_bias", (n_pub,), "bias", 0.1))
            for j in range(e0, e1):
                mlp(f"{m}experts.{j}.", cfg["moe_intermediate_size"], ("w1", "w3", "w2"))
            mlp(m + "shared_experts.", cfg["moe_intermediate_size"] * cfg["num_shared_experts"])
        else:
            mlp(p + "mlp.", cfg["intermediate_size"])
    out.append(("model.norm.weight", (d,), "one_plus", 0.1))
    lin("lm_head.weight", cfg["vocab_size"], d)
    return out


class KimiWeights(PublishedWeights):
    """The held tensors by name, each drawn on ``device`` when read from
    (seed, its place in ``published_spec``)."""

    def __init__(self, cfg: dict, seed: int, device, dtype=torch.bfloat16):
        self.seed, self.device, self.dtype = seed, torch.device(device), dtype
        self.spec = {name: (k, shape, kind, scale)
                     for k, (name, shape, kind, scale) in enumerate(published_spec(cfg))}

    def __getitem__(self, name: str) -> torch.Tensor:
        k, shape, kind, scale = self.spec[name]
        if kind not in FP32_KINDS:
            return super().__getitem__(name)
        state = np.random.SeedSequence([self.seed % (1 << 64), k]).generate_state(1, np.uint64)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(state[0] >> np.uint64(1)))
        if kind == "bias":
            return torch.randn(shape, generator=gen, device=self.device).mul_(scale)
        u = torch.rand(shape, generator=gen, device=self.device)
        if kind == "a_log":
            return torch.log(1.0 + 15.0 * u)
        dt = torch.exp(math.log(1e-3) + u * math.log(100.0))
        return dt + torch.log(-torch.expm1(-dt))


def client(cfg: dict, seed: int, device):
    """(the client, the weights it was built from, by published name)."""
    from audio_processor_tpu_torch.integrations.local_llm import LocalLLMClient
    from audio_processor_tpu_torch.models.llm.checkpoint import params_from_hf
    from audio_processor_tpu_torch.models.llm.generate import Engine

    from .llm_tokenizer import SynthTokenizer

    run = cfg["run"]
    conf = program_config(cfg)
    weights = KimiWeights(cfg, seed, device, getattr(torch, run["dtype"]))
    params = params_from_hf(weights, conf)
    llm = LocalLLMClient(Engine(params, conf, device), SynthTokenizer(run["bos_token_id"]))
    llm.speaker_tokens, llm.summary_tokens, llm.notes_tokens = (
        run["speaker_tokens"], run["summary_tokens"], run["notes_tokens"])
    return llm, weights
