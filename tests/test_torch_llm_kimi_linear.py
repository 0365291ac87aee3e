"""The port's Kimi-Linear (``models/llm``) against the plain float32
reference (``tests/plain_kimi_linear.py``), on the CPU at a tiny size.

Seeded random weights at the ``tiny-kimi`` preset (d 64; KDA layers of 2
heads of 16 with a convolution of 4 on layers 0, 1 and 3, NoPE MLA of 4
heads on layer 2; 8 experts top-2 and a shared one after the dense first
layer; vocab 512), every tensor in float32.  Logits are compared, not
sampled tokens.  The tolerance is 1e-4 on logits of magnitude about 4:
both sides compute in float32 and differ only in the order of their sums
(the 64-token chunks against the reference's 128, the sub-chunked decays,
the solve, the absorbed MLA, the grouped expert product), which moves a
float32 logit by a few 1e-6; a wrong decay, state, window, mask or
routing moves it by 1e-2 or more.  KDA's two forms are held to 1e-5 at
the layer, where outputs are about 0.3.

The last tests hold the kernels and the decode step's CUDA graph to their
plain versions on the card (marker ``cuda``); they skip here.  This file
imports neither jax nor the JAX package.
"""
from __future__ import annotations

import dataclasses
import datetime
import importlib.util
import json
import math
import multiprocessing
import os
import tempfile
from pathlib import Path

import pytest
import torch

import plain_kimi_linear as ref
from audio_processor_tpu_torch.models.llm import checkpoint as ck
from audio_processor_tpu_torch.models.llm import generate, kda
from audio_processor_tpu_torch.models.llm import model as M
from audio_processor_tpu_torch.models.llm.config import (PRESETS, KimiLinearConfig, get_config,
                                                         on_mesh)
from audio_processor_tpu_torch.models.llm.generate import Engine, _chunks
from audio_processor_tpu_torch.ops.kernels import kda as kernels

ROOT = Path(__file__).resolve().parents[1]
CFG = get_config("tiny-kimi")
ATOL = 1e-4  # float32 on both sides; only the order of sums differs (module note)


def hf_config(cfg: KimiLinearConfig) -> dict:
    """The published keys of a port config, as the reference reads them."""
    e0, e1 = cfg.expert_range
    full = [i + 1 for i in cfg.full_attn_layers]
    return dict(
        hidden_size=cfg.hidden_size, num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads, kv_lora_rank=cfg.kv_lora_rank,
        qk_nope_head_dim=cfg.qk_nope_head_dim, qk_rope_head_dim=cfg.qk_rope_head_dim,
        v_head_dim=cfg.v_head_dim, rms_norm_eps=cfg.rms_norm_eps,
        linear_attn_config=dict(
            full_attn_layers=full, head_dim=cfg.kda_head_dim, num_heads=cfg.kda_num_heads,
            kda_layers=[i for i in range(1, cfg.num_hidden_layers + 1) if i not in full],
            short_conv_kernel_size=cfg.conv_size),
        num_experts=e1 - e0, experts_published=cfg.n_routed_experts, experts_held=[e0, e1],
        num_experts_per_token=cfg.num_experts_per_tok, moe_renormalize=True,
        routed_scaling_factor=cfg.routed_scaling_factor,
        first_k_dense_replace=cfg.first_k_dense_replace, moe_layer_freq=cfg.moe_layer_freq)


@pytest.fixture(scope="module")
def tiny():
    params = ck.random_params(CFG, 20260126, "cpu", torch.float32)
    return params, ck.to_hf(params, CFG), hf_config(CFG)


def prompt(seed: int, n: int) -> list[int]:
    return torch.randint(0, 500, (n,), generator=torch.Generator().manual_seed(seed)).tolist()


def reference_logits(weights, hcfg, ids: list[int]) -> torch.Tensor:
    return ref.forward(weights, hcfg, torch.tensor(ids))


def close(got, want, atol=ATOL):
    assert torch.allclose(got, want, atol=atol, rtol=0), (got - want).abs().max()


def test_prefill_in_one_chunk_matches_the_reference(tiny):
    """150 tokens: three KDA chunks of 64, the last partial."""
    params, weights, hcfg = tiny
    ids = prompt(1, 150)
    got = M.full_forward(params, CFG, torch.tensor(ids))
    assert got.shape == (150, CFG.vocab_size)
    close(got, reference_logits(weights, hcfg, ids))


def prefill_groups(params, seqs: list[list[int]], limit: int):
    """Every token's logits of each sequence, prefilled as a prefix in
    chunks of at most ``limit`` tokens packed across the sequences."""
    G = len(seqs)
    pc = torch.zeros(CFG.mla_layers, G, max(map(len, seqs)), CFG.latent_dim)
    states = kda.States.zeros(CFG, G, torch.float32, "cpu")
    out = [[] for _ in seqs]
    for chunk in _chunks([len(s) for s in seqs], limit):
        ids, segs, s = [], [], 0
        for g, a, b in chunk:
            ids += seqs[g][a:b]
            segs.append((g, a, s, s + b - a))
            s += b - a
        x, _ = M.prefill_chunk(params, CFG, pc, torch.tensor(ids), segs, None, q_block=64,
                               states=states)
        lg = M.logits(params, CFG, x)
        for g, a, s0, s1 in segs:
            out[g].append(lg[s0:s1])
    return [torch.cat(o) for o in out], pc, states


@pytest.mark.parametrize("limit", [100, 77])
def test_prefill_split_mid_recording_and_packed_with_another_group(tiny, limit):
    """Two recordings through chunks of 100 (or 77) tokens: the first cut
    mid-way, its tail packed with the second's head; each group's state
    and window carry across its chunks and stay apart from the other's."""
    params, weights, hcfg = tiny
    seqs = [prompt(2, 130), prompt(3, 90)]
    got, _, _ = prefill_groups(params, seqs, limit)
    for s, g in zip(seqs, got):
        close(g, reference_logits(weights, hcfg, s))


def teacher_forced(params, rows: list[list[int]], plen: int, own: int) -> list[torch.Tensor]:
    """Logits past position ``plen + own - 1`` of each row, through the
    caches: the rows' shared first ``plen`` tokens as one group's prefix in
    chunks of 64, the fork, each row's next ``own`` tokens as its prompt
    (the chunked form), then one token a step, fed the row's own tokens."""
    K = len(rows)
    (_,), pc, states = prefill_groups(params, [rows[0][:plen]], 64)
    cap = max(len(r) for r in rows) - plen
    sc = torch.zeros(CFG.mla_layers, K, cap, CFG.latent_dim)
    rs = kda.States(states.state.repeat_interleave(K, 1), states.win.repeat_interleave(K, 1))
    plens = torch.tensor([plen])
    tok = torch.tensor([r[plen:plen + own] for r in rows])
    h, _ = M.forward_rows(params, CFG, tok, torch.ones(K, own, dtype=torch.bool), pc, plens,
                          sc, torch.zeros(K, dtype=torch.long), None, states=rs,
                          lengths=[own] * K)
    out = [[lg] for lg in M.logits(params, CFG, h[:, -1])]
    for t in range(plen + own, max(len(r) for r in rows) - 1):
        tok = torch.tensor([[r[t] if t < len(r) else 0] for r in rows])
        valid = torch.tensor([[t < len(r) - 1] for r in rows])
        h, _ = M.forward_rows(params, CFG, tok, valid, pc, plens, sc,
                              torch.full((K,), t - plen), None, states=rs)
        lg = M.logits(params, CFG, h[:, 0])
        for k, r in enumerate(rows):
            if t < len(r) - 1:
                out[k].append(lg[k])
    return [torch.stack(o) for o in out]


def test_a_prefix_forked_into_two_rows_decodes_as_each_rows_full_pass(tiny):
    """A 100-token prefix forked into two rows with prompts of 7 tokens,
    then decoded a token a step: each row's logits equal the reference's
    full forward pass of that row."""
    params, weights, hcfg = tiny
    shared = prompt(5, 100)
    rows = [shared + prompt(6, 19), shared + prompt(7, 12)]
    forked = teacher_forced(params, rows, len(shared), 7)
    for row, got in zip(rows, forked):
        want = reference_logits(weights, hcfg, row)[len(shared) + 6:len(row) - 1]
        close(got, want)


def kda_inputs(T: int, H: int = 2, D: int = 16, seed: int = 0):
    g_ = torch.Generator().manual_seed(seed)
    q = ref._l2norm(torch.randn(T, H, D, generator=g_)) * D ** -0.5
    k = ref._l2norm(torch.randn(T, H, D, generator=g_))
    v = torch.randn(T, H, D, generator=g_)
    # strong and weak decays alike: up to e^-40 a token
    g = -torch.rand(T, H, D, generator=g_) ** 3 * 40
    beta = torch.rand(T, H, generator=g_)
    return q, k, v, g, beta


def test_kda_chunk_form_matches_the_token_form():
    """The reference's two forms agree, and so do the port's chunked inputs
    and sequential pass (the kernel's plain version), over two segments,
    one continuing a state."""
    q, k, v, g, beta = kda_inputs(300)
    o_tok, S_tok = ref.kda_tokens(q, k, v, g, beta)
    for at_once in (64, 3):  # the blocks' decays and solves formed all at once, or 3 at a time
        o_chk, S_chk = ref.kda_chunks(q, k, v, g, beta, blocks_at_once=at_once)
        assert torch.allclose(o_chk, o_tok, atol=1e-5, rtol=0), (o_chk - o_tok).abs().max()
        assert torch.allclose(S_chk, S_tok, atol=1e-5, rtol=0)
    # the port: tokens 0..169 continue a state, 170..299 start fresh
    S0 = torch.randn(2, 16, 16, generator=torch.Generator().manual_seed(9)) * 0.1
    want_a, Sa = ref.kda_tokens(q[:170], k[:170], v[:170], g[:170], beta[:170], S0.clone())
    want_b, Sb = ref.kda_tokens(q[170:], k[170:], v[170:], g[170:], beta[170:])
    p = kda.plan([(1, 0, 170), (0, 170, 300)], 2, 4, "cpu")
    state = torch.stack((torch.zeros(2, 16, 16), S0))
    o = kernels.kda_chunk_state(*kda.chunk_inputs(q, k, v, g, beta, p), p.first, p.end, p.slot,
                                state)
    o = o.transpose(1, 2).reshape(-1, 2, 16).index_select(0, p.dst)
    for got, want in ((o[:170], want_a), (o[170:], want_b), (state[1], Sa), (state[0], Sb)):
        assert torch.allclose(got, want, atol=1e-5, rtol=0), (got - want).abs().max()


def test_kda_step_matches_the_token_form_and_skips_finished_rows():
    q, k, v, g, beta = kda_inputs(3, seed=4)
    S0 = torch.randn(3, 2, 16, 16, generator=torch.Generator().manual_seed(1)) * 0.1
    state = S0.clone()
    active = torch.tensor([True, False, True])
    o = kernels.kda_step(q, k, v, g, beta, active, state)
    for r in (0, 2):
        want, S = ref.kda_tokens(q[r:r + 1], k[r:r + 1], v[r:r + 1], g[r:r + 1],
                                 beta[r:r + 1], S0[r].clone())
        assert torch.allclose(o[r], want[0], atol=1e-6) and torch.allclose(state[r], S, atol=1e-6)
    assert torch.equal(state[1], S0[1]) and not o[1].any()


def test_sigmoid_router_renormalises_then_scales(tiny):
    """Kimi's choice is top-k of sigmoid plus the bias; the weights are the
    unbiased sigmoids, renormalised, then times 2.446."""
    params, _, _ = tiny
    lp = params["layers"][1]
    x = torch.randn(23, CFG.hidden_size, generator=torch.Generator().manual_seed(3))
    got, touched = M.moe(x, lp, CFG)
    want = M.mlp(x, lp["shared_gate_up"], lp["shared_down"])
    chosen = set()
    for t in range(x.shape[0]):
        s = torch.sigmoid(x[t] @ lp["router"])
        idx = (s + lp["router_bias"]).topk(CFG.num_experts_per_tok).indices
        w = s[idx] / s[idx].sum() * 2.446
        for wi, e in zip(w, idx.tolist()):
            chosen.add(e)
            want[t] += wi * M.mlp(x[t:t + 1], lp["experts_gate_up"][e], lp["experts_down"][e])[0]
    close(got, want, 1e-5)
    assert int(touched) == len(chosen) and CFG.route_scale == 2.446


@pytest.mark.parametrize("norm", [False, True])
def test_deepseek_routing_weights_are_unchanged(norm):
    """DeepSeek-V2's softmax router: scaled by ``routed_scaling_factor``
    only where it does not renormalise, as ``MoEGate`` does."""
    cfg = dataclasses.replace(get_config("tiny"), routed_scaling_factor=2.0, norm_topk_prob=norm)
    params = ck.random_params(cfg, 3, "cpu", torch.float32)
    lp = params["layers"][1]
    x = torch.randn(9, cfg.hidden_size, generator=torch.Generator().manual_seed(4))
    got, _ = M.moe(x, lp, cfg)
    want = M.mlp(x, lp["shared_gate_up"], lp["shared_down"])
    for t in range(x.shape[0]):
        w, idx = torch.softmax(x[t] @ lp["router"], -1).topk(cfg.num_experts_per_tok)
        w = w / w.sum() if norm else w * 2.0
        for wi, e in zip(w, idx.tolist()):
            want[t] += wi * M.mlp(x[t:t + 1], lp["experts_gate_up"][e], lp["experts_down"][e])[0]
    close(got, want, 1e-5)


def test_mla_without_rotary_positions(tiny):
    """A Kimi-Linear of MLA layers alone: the NoPE latent attention, through
    the expanded prefill and the absorbed rows, equals the reference."""
    cfg = dataclasses.replace(CFG, full_attn_layers=(0, 1, 2, 3))
    params = ck.random_params(cfg, 8, "cpu", torch.float32)
    weights = ck.to_hf(params, cfg)
    ids = prompt(11, 90)
    want = ref.forward(weights, hf_config(cfg), torch.tensor(ids))
    close(M.full_forward(params, cfg, torch.tensor(ids), q_block=64), want)
    assert cfg.kda_layers == 0 and not cfg.rope


def test_two_expert_shares_add_up_to_the_uncut_layer(tiny):
    """The routed parts of experts 0-3 and 4-7, with the shared expert
    counted once, are the whole layer's output."""
    params, _, _ = tiny
    lp = params["layers"][2]
    x = torch.randn(31, CFG.hidden_size, generator=torch.Generator().manual_seed(5))
    whole, _ = M.moe(x, lp, CFG)
    shared = M.mlp(x, lp["shared_gate_up"], lp["shared_down"])
    parts = []
    for e0, e1 in ((0, 4), (4, 8)):
        cfg = dataclasses.replace(CFG, experts_held=(e0, e1))
        share = dict(lp, experts_gate_up=lp["experts_gate_up"][e0:e1],
                     experts_down=lp["experts_down"][e0:e1])
        y, _ = M.moe(x, share, cfg)
        parts.append(y - shared)
    close(parts[0] + parts[1] + shared, whole, 1e-5)


def _share_rank(rank: int, store: str, sd: dict, ids: list[int], out) -> None:
    import torch.distributed as dist

    from audio_processor_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh(2, device="cpu")
        cfg = on_mesh(CFG, mesh)
        params = ck.params_from_hf(sd, cfg)
        served = Engine(params, cfg, "cpu", mesh).generate(
            [[ids[:50] + [1, 2], ids[:50] + [3]]], [[4, 3]])
        # by value (numpy): a tensor would pass as a handle into this
        # process's memory, which ends with it
        out.put((rank, cfg.expert_range,
                 M.full_forward(params, cfg, torch.tensor(ids), mesh=mesh).numpy(), served))
    finally:
        dist.destroy_process_group()


def test_a_two_rank_expert_parallel_world_gives_the_uncut_logits(tiny):
    """Two gloo ranks of one model group (``parallel/mesh.py``), each
    holding half of every layer's experts and summing the routed part over
    the group, give the reference's logits of the whole model, and serve
    its greedy tokens through the engine."""
    _, weights, hcfg = tiny
    ids = prompt(13, 70)
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_share_rank,
                             args=(r, os.path.join(tmp, "store"), weights, ids, out))
                 for r in range(2)]
        for p in procs:
            p.start()
        got = {r: (held, torch.from_numpy(logits), served)
               for r, held, logits, served in (out.get(timeout=120) for _ in procs)}
        for p in procs:
            p.join(timeout=30)
    want = reference_logits(weights, hcfg, ids)
    assert got[0][0] == (0, 4) and got[1][0] == (4, 8)
    close(got[0][1], want)
    assert torch.equal(got[0][1], got[1][1]) and got[0][2] == got[1][2]
    for row, gen in zip([ids[:50] + [1, 2], ids[:50] + [3]], got[0][2][0]):
        lg = reference_logits(weights, hcfg, row + gen[:-1])[len(row) - 1:]
        gap = lg.max(-1).values - lg.gather(1, torch.tensor(gen)[:, None])[:, 0]
        assert float(gap.max()) <= ATOL


def test_prefill_score_blocks_are_sized_by_bytes(tiny, monkeypatch):
    """Queries attend in blocks whose scores stay under the byte budget: a
    prefill whose blocks shrink to 64 rows crosses block edges with the
    same logits; DeepSeek-V2-Lite keeps its 1,024-row blocks at 14k keys,
    Kimi-Linear takes 128 at 113k."""
    params, weights, hcfg = tiny
    cfg = dataclasses.replace(CFG, full_attn_layers=(0, 2))
    params = ck.random_params(cfg, 9, "cpu", torch.float32)
    ids = torch.tensor(prompt(14, 200))
    wide = M.full_forward(params, cfg, ids, q_block=1024)
    seen = []
    real = M._attend_expanded

    def spy(q_nope, *a):
        seen.append(q_nope.shape[0])
        return real(q_nope, *a)

    monkeypatch.setattr(M, "_attend_expanded", spy)
    monkeypatch.setattr(M, "PREFILL_BLOCK_BYTES", 64 * 4 * 256 * 4)  # 64 rows at 256 keys
    narrow = M.full_forward(params, cfg, ids, q_block=1024)
    close(narrow, wide, 1e-5)
    close(narrow, ref.forward(ck.to_hf(params, cfg), hf_config(cfg), ids))
    assert seen == [200, 200]

    def rows(nh, keys):
        kb = -(-keys // 64) * 64
        return max(64, min(1024, (1 << 30) // (nh * kb * 2) // 64 * 64))

    assert rows(16, 14_100) == 1024 and rows(32, 112_800) == 128


def test_published_names_map_into_the_port_and_back(tiny):
    """A state dict under ``modeling_kimi.py``'s names (KDA's ``q_conv1d``,
    ``A_log``, ``f_b_proj``; ``block_sparse_moe.experts.{j}.w1``, the
    router's ``e_score_correction_bias``) goes into the port's layout and
    back; a share reads only its experts."""
    params, weights, _ = tiny
    assert "model.layers.0.self_attn.q_conv1d.weight" in weights
    assert weights["model.layers.1.self_attn.A_log"].shape == (1, 1, 2, 1)
    assert "model.layers.3.block_sparse_moe.experts.7.w1.weight" in weights
    assert "model.layers.2.block_sparse_moe.gate.e_score_correction_bias" in weights
    assert "model.layers.2.self_attn.kv_b_proj.weight" in weights
    assert "model.layers.0.mlp.down_proj.weight" in weights
    back = ck.to_hf(ck.params_from_hf(weights, CFG), CFG)
    assert set(back) == set(weights) and all(torch.equal(back[k], weights[k]) for k in weights)
    half = dataclasses.replace(CFG, experts_held=(4, 8))
    lp = ck.params_from_hf(weights, half)["layers"][1]
    assert torch.equal(lp["experts_down"], params["layers"][1]["experts_down"][4:])
    assert lp["router"].shape == (CFG.hidden_size, 8) and lp["A_log"].dtype == torch.float32


def test_the_published_config_reads_as_kimi_linear():
    """The benchmark's file: the published keys with 128 of the 256 experts
    held; the port's preset; 49.1 B parameters published, 2.01 B outside
    the routed experts, 25.6 B on this card."""
    cfg = json.loads((ROOT / "portbench" / "configs" / "kimi-linear-48b-a3b.json").read_text())
    conf = KimiLinearConfig.from_dict(cfg, name="kimi-linear-48b-a3b")
    assert dataclasses.replace(conf, bos_token_id=163584, eos_token_id=163586) == PRESETS[
        "kimi-linear-48b-a3b"]
    assert conf.kda_layers == 20 and conf.mla_layers == 7 and conf.moe_layers == 26
    assert conf.expert_range == (0, 128) and conf.n_routed_experts == 256
    held = sum(math.prod(s) for _, s, _, _ in ck.param_spec(conf))
    expert = 3 * 2304 * 1024
    assert held - 26 * 128 * expert == 2_012_259_200
    assert round((held + 26 * 128 * expert) / 1e9, 1) == 49.1
    assert round(held / 1e9, 1) == 25.6
    for key, value in (("mla_use_nope", False), ("moe_router_activation_func", "softmax"),
                       ("num_expert_group", 8), ("q_lora_rank", 1536)):
        with pytest.raises(NotImplementedError, match=key):
            KimiLinearConfig.from_dict(dict(cfg, **{key: value}))


def test_the_benchmarks_copy_of_the_reference_gives_the_same_logits(tiny):
    _, weights, hcfg = tiny
    spec = importlib.util.spec_from_file_location(
        "bench_kimi_ref", ROOT / "portbench" / "reference" / "kimi_linear.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    assert (ROOT / "portbench" / "reference" / "kimi_linear.py").read_text() == Path(
        ref.__file__).read_text()
    ids = torch.tensor(prompt(15, 70))
    assert torch.equal(bench.forward(weights, hcfg, ids), ref.forward(weights, hcfg, ids))


@pytest.fixture
def small_blocks(monkeypatch):
    for name, v in (("CHUNK_TOKENS", 96), ("CACHE_BLOCK", 64), ("READBACK_EVERY", 3),
                    ("MAX_BUFFERS", 2)):
        monkeypatch.setattr(generate, name, v)


def test_generate_serves_the_references_greedy_tokens_and_counts(tiny, small_blocks):
    """Two groups of two rows through the engine: shared prefixes in packed
    chunks, the fork, the rows' prompts, greedy steps; each served token is
    the reference's best at its position, and the call counts its KDA work."""
    from audio_processor_tpu_torch.runtime import trace

    params, weights, hcfg = tiny
    shared = prompt(20, 150)
    groups = [[shared + prompt(21, 5), shared + prompt(22, 3)],
              [prompt(23, 60) + prompt(24, 2), prompt(23, 60) + prompt(25, 7)]]
    caps = [[9, 4], [1, 6]]
    with trace.request() as rec:
        out = Engine(params, CFG, "cpu").generate(groups, caps)
    for grp, cs, outs in zip(groups, caps, out):
        for p, c, o in zip(grp, cs, outs):
            assert len(o) == c
            lg = reference_logits(weights, hcfg, p + o[:-1])[len(p) - 1:]
            gap = lg.max(-1).values - lg.gather(1, torch.tensor(o)[:, None])[:, 0]
            assert float(gap.max()) <= ATOL
    c = rec.summary()["counters"]
    assert c["llm.kda.forks"] == 4
    assert c["llm.kda.prefill_tokens"] == 150 + 60 + 5 + 3 + 2 + 7
    steps = c["llm.decode.steps"]
    assert steps == 8
    row = kda.States.zeros(CFG, 1, torch.float32, "cpu").row_bytes()
    # active rows a step: 4 for the first 3 steps (row caps 9, 4, 1, 6), ...
    active = sum(sum(1 for cap in (9, 4, 1, 6) if s + 1 < cap) for s in range(steps))
    assert c["llm.kda.state_bytes"] == 2 * row * active
    assert "llm.prefill.fork" in rec.summary()["spans"]


def test_the_job_client_runs_kimi_linear_by_name():
    """``LocalLLMClient`` builds Kimi-Linear by preset name and writes up a
    batch of meetings through it; the card budget counts this card's
    experts."""
    from audio_processor_tpu_torch.integrations.local_llm import LocalLLMClient

    llm = LocalLLMClient.random_init("tiny-kimi", device="cpu")
    llm.speaker_tokens, llm.summary_tokens, llm.notes_tokens = 3, 4, 5
    out = llm.summary_and_notes_many([("SPEAKER_00: Hi Bob.", ""), ("SPEAKER_01: Yes.", "")])
    assert len(out) == 2 and all("title" in summary for summary, _ in out)
    assert LocalLLMClient.card_bytes("kimi-linear-48b-a3b") == 2 * 25_567_470_464 + 15 * 10**9


@pytest.mark.parametrize("name, meetings, calls", [
    ("tiny-kimi", 4, [[1, 1, 1, 1], [1], [2, 2, 2, 2], [2]]),
    ("tiny", 16, [[1] * 5, [2] * 5])])
def test_a_call_holds_at_most_the_presets_measured_meetings(name, meetings, calls, monkeypatch):
    """Each preset's calls hold at most the meetings its card budget was
    measured on: Kimi-Linear's 4 all-day recordings, DeepSeek-V2's 16 (the
    rows of each group of each call: the speaker task's one, then the
    summary's and the notes')."""
    from audio_processor_tpu_torch.integrations.local_llm import LocalLLMClient

    llm = LocalLLMClient.random_init(name, device="cpu")
    assert llm.max_meetings == get_config(name).max_meetings == meetings
    seen = []

    def generate(groups, caps):
        seen.append([len(g) for g in groups])
        return [[[] for _ in g] for g in groups]

    monkeypatch.setattr(llm.engine, "generate", generate)
    segs = [{"speaker": "SPEAKER_00", "text": "Hi.", "start": 0.0, "end": 1.0}]
    llm.identify_speakers_many([segs] * 5)
    llm.summary_and_notes_many([("SPEAKER_00: Hi.", "")] * 5)
    assert seen == calls


def test_a_share_without_a_mesh_warns_that_it_computes_only_its_experts(caplog):
    """One card holding a share of the experts, with no mesh for the rest,
    says so when its engine loads; a preset holding every expert does not."""
    share = dataclasses.replace(CFG, experts_held=(0, 4))
    with caplog.at_level("WARNING", logger=generate.__name__):
        Engine(ck.random_params(share, 0, "cpu", torch.float32), share, "cpu")
    assert "holds experts 0-3 of each layer's 8" in caplog.text
    caplog.clear()
    with caplog.at_level("WARNING", logger=generate.__name__):
        Engine(ck.random_params(CFG, 0, "cpu", torch.float32), CFG, "cpu")
    assert not caplog.text


@pytest.mark.cuda
def test_the_kernels_equal_their_plain_versions_at_the_published_widths():
    """On the card: ``kda_chunk_state`` over three packed segments and
    ``kda_step`` over 8 rows with 3 finished, at 32 heads of 128, against
    the plain versions in float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the KDA kernels are Triton and run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    q, k, v, g, beta = (t.to(dev) for t in kda_inputs(700, 32, 128, seed=2))
    p = kda.plan([(2, 0, 300), (0, 300, 365), (1, 365, 700)], 3, 4, dev)
    ins = kda.chunk_inputs(q, k, v, g, beta, p)
    s0 = torch.randn(3, 32, 128, 128, device=dev) * 0.05
    s_kernel, s_plain = s0.clone(), s0.clone()
    got = kernels.kda_chunk_state(*ins, p.first, p.end, p.slot, s_kernel)
    want = kernels.kda_chunk_state_reference(*ins, p.first.cpu(), p.end.cpu(), p.slot.cpu(),
                                             s_plain)
    torch.cuda.synchronize()
    assert (got - want).abs().max() < 1e-4 and (s_kernel - s_plain).abs().max() < 1e-4
    q, k, v, g, beta = (t.to(dev).contiguous() for t in kda_inputs(8, 32, 128, seed=3))
    active = torch.tensor([1, 1, 0, 1, 0, 1, 1, 0], dtype=torch.bool, device=dev)
    s0 = torch.randn(8, 32, 128, 128, device=dev) * 0.05
    s_kernel, s_plain = s0.clone(), s0.clone()
    got = kernels.kda_step(q, k, v, g, beta, active, s_kernel)
    want = kernels.kda_step_reference(q, k, v, g, beta, active, s_plain)
    torch.cuda.synchronize()
    assert (got - want).abs().max() < 1e-5 and (s_kernel - s_plain).abs().max() < 1e-5


@pytest.mark.cuda
def test_one_graph_replay_of_the_kimi_step_equals_the_eager_step(small_blocks):
    """On the card: the captured decode step, with its KDA step kernel and
    in-place row states, replayed once, leaves the state of the eager step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the decode step's CUDA graph exists only on the card")
    dev = torch.device("cuda")
    params = ck.random_params(CFG, 5, dev, torch.bfloat16)
    eng = Engine(params, CFG, dev)
    shared = prompt(30, 140)
    with torch.inference_mode():
        eng.generate([[shared + [1, 2, 3], shared + [4]]] * 2, [[12, 7]] * 2)
        (sess,) = eng._sessions.values()
        assert sess.graph is not None
        sess.active[::2] = True
        sess.cap.fill_(50)
        extra = [sess.sc, sess.states.state, sess.states.win]
        start = [t.clone() for t in list(sess._state()) + extra]
        sess.graph.replay()
        replayed = [t.clone() for t in list(sess._state()) + extra]
        for t, s in zip(list(sess._state()) + extra, start):
            t.copy_(s)
        sess.step()
        for a, b in zip(replayed, list(sess._state()) + extra):
            assert torch.equal(a, b)
        assert not torch.equal(replayed[-2], start[-2])  # the step moved the states
