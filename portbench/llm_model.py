"""A DeepSeek-V2 configuration file -> seeded weights under the published
checkpoint's names, and the program's language-model client built from
them.

The benchmark draws the weights itself: each tensor of the checkpoint
(``model.layers.{i}.self_attn.kv_b_proj.weight``, ...,
``lm_head.weight``) from the card's generator, seeded by ``--seed`` and
the tensor's place in the list, in bfloat16.  Linears are normal /
sqrt(d_in), norms 1 + 0.1 * normal, the embedding normal.  A tensor is
drawn again, to the same numbers, each time it is read, so the reference
reads the very tensors the program was built from without a second copy
of the model on the card.  The program gets them through its checkpoint
loader (``checkpoint.params_from_hf``), the path published weights would
take, and the client is the program's ``LocalLLMClient`` over its
``Engine``, with the file's run options and the benchmark's tokenizer.
"""
from __future__ import annotations

import math
from collections.abc import Mapping

import numpy as np
import torch


def program_config(cfg: dict):
    """The program's config for a configuration file (published keys,
    the special ids from ``run``)."""
    import dataclasses

    from audio_processor_tpu_torch.models.llm.config import DeepseekV2Config

    conf = DeepseekV2Config.from_dict(cfg, name=cfg["name"])
    return dataclasses.replace(conf, bos_token_id=cfg["run"]["bos_token_id"],
                               eos_token_id=cfg["run"]["eos_token_id"])


def published_spec(cfg: dict) -> list[tuple[str, tuple, str, float]]:
    """(name, shape, kind, scale) of every tensor of the checkpoint, in
    ``modeling_deepseek.py``'s layout (linears (d_out, d_in))."""
    if cfg.get("q_lora_rank") is not None:
        raise ValueError("the benchmark draws q_proj only: q_lora_rank must be null")
    d, nh, r = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    out = [("model.embed_tokens.weight", (cfg["vocab_size"], d), "normal", 1.0)]

    def lin(name, d_out, d_in):
        out.append((name, (d_out, d_in), "normal", 1.0 / math.sqrt(d_in)))

    def mlp(prefix, width):
        lin(prefix + "gate_proj.weight", width, d)
        lin(prefix + "up_proj.weight", width, d)
        lin(prefix + "down_proj.weight", d, width)

    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        a, m = p + "self_attn.", p + "mlp."
        for norm, width in (("input_layernorm", d), ("post_attention_layernorm", d),
                            ("self_attn.kv_a_layernorm", r)):
            out.append((p + norm + ".weight", (width,), "one_plus", 0.1))
        lin(a + "q_proj.weight", nh * (dn + dr), d)
        lin(a + "kv_a_proj_with_mqa.weight", r + dr, d)
        lin(a + "kv_b_proj.weight", nh * (dn + dv), r)
        lin(a + "o_proj.weight", d, nh * dv)
        moe = (cfg["n_routed_experts"] and i >= cfg["first_k_dense_replace"]
               and i % cfg["moe_layer_freq"] == 0)
        if moe:
            lin(m + "gate.weight", cfg["n_routed_experts"], d)
            for j in range(cfg["n_routed_experts"]):
                mlp(f"{m}experts.{j}.", cfg["moe_intermediate_size"])
            mlp(m + "shared_experts.", cfg["moe_intermediate_size"] * cfg["n_shared_experts"])
        else:
            mlp(m, cfg["intermediate_size"])
    out.append(("model.norm.weight", (d,), "one_plus", 0.1))
    lin("lm_head.weight", cfg["vocab_size"], d)
    return out


class PublishedWeights(Mapping):
    """The checkpoint's tensors by name, each drawn on ``device`` when read
    from (seed, its place in ``published_spec``): the same numbers at
    every read."""

    def __init__(self, cfg: dict, seed: int, device, dtype=torch.bfloat16):
        self.seed, self.device, self.dtype = seed, torch.device(device), dtype
        self.spec = {name: (k, shape, kind, scale)
                     for k, (name, shape, kind, scale) in enumerate(published_spec(cfg))}

    def __getitem__(self, name: str) -> torch.Tensor:
        k, shape, kind, scale = self.spec[name]
        state = np.random.SeedSequence([self.seed % (1 << 64), k]).generate_state(1, np.uint64)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(state[0] >> np.uint64(1)))
        w = torch.randn(shape, generator=gen, device=self.device, dtype=self.dtype).mul_(scale)
        return w.add_(1.0) if kind == "one_plus" else w

    def __iter__(self):
        return iter(self.spec)

    def __len__(self) -> int:
        return len(self.spec)


def client(cfg: dict, seed: int, device):
    """(the client, the weights it was built from, by published name)."""
    from audio_processor_tpu_torch.integrations.local_llm import LocalLLMClient
    from audio_processor_tpu_torch.models.llm.checkpoint import params_from_hf
    from audio_processor_tpu_torch.models.llm.generate import Engine

    from .llm_tokenizer import SynthTokenizer

    run = cfg["run"]
    conf = program_config(cfg)
    weights = PublishedWeights(cfg, seed, device, getattr(torch, run["dtype"]))
    params = params_from_hf(weights, conf)
    llm = LocalLLMClient(Engine(params, conf, device), SynthTokenizer(run["bos_token_id"]))
    llm.speaker_tokens, llm.summary_tokens, llm.notes_tokens = (
        run["speaker_tokens"], run["summary_tokens"], run["notes_tokens"])
    return llm, weights
