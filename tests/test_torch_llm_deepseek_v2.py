"""The port's DeepSeek-V2 (``models/llm``) against the plain float32
reference (``tests/plain_deepseek_v2.py``), on the CPU at a tiny size.

Seeded random weights at the ``tiny`` preset (d 64, 4 heads, nope 16, rope
8, v 16, latent 32, 8 experts top-2, 1 shared, 3 layers with the first
dense, vocab 512, YaRN factor 40 over an original 32), every tensor in
float32, prompts past the original context so YaRN's blend matters.
Logits are compared, not sampled tokens.  The tolerance is 1e-4 on logits
of magnitude about 4: both sides compute in float32 and differ only in the
order of their sums (chunked and blocked products, the absorbed form's
reassociation of ``W_UK`` and ``W_UV``, the grouped expert product),
which moves a float32 logit by a few 1e-6; a wrong mask, position,
rotation or routing moves it by 1e-2 or more.

The last test holds the CUDA graph of the decode step to the eager step
on the card (marker ``cuda``); it skips here.  This file imports neither
jax nor the JAX package.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
from pathlib import Path

import pytest
import torch

import plain_deepseek_v2 as ref
from audio_processor_tpu_torch.models.llm import checkpoint as ck
from audio_processor_tpu_torch.models.llm import model as M
from audio_processor_tpu_torch.models.llm.config import (PRESETS, DeepseekV2Config,
                                                         get_config)
from audio_processor_tpu_torch.models.llm import generate
from audio_processor_tpu_torch.models.llm.generate import Engine, _chunks, _common_prefix

ROOT = Path(__file__).resolve().parents[1]
CFG = get_config("tiny")
ATOL = 1e-4  # float32 on both sides; only the order of sums differs (module note)


def hf_config(cfg: DeepseekV2Config) -> dict:
    """The published keys of a port config, as the reference reads them."""
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d["rope_scaling"] = {"type": "yarn", "factor": cfg.rope_factor,
                         "original_max_position_embeddings": cfg.rope_original_max_position,
                         "beta_fast": cfg.rope_beta_fast, "beta_slow": cfg.rope_beta_slow,
                         "mscale": cfg.rope_mscale, "mscale_all_dim": cfg.rope_mscale_all_dim}
    return d


@pytest.fixture(scope="module")
def tiny():
    params = ck.random_params(CFG, 20260101, "cpu", torch.float32)
    return params, ck.to_hf(params, CFG), hf_config(CFG)


def prompt(seed: int, n: int) -> list[int]:
    return torch.randint(0, 500, (n,), generator=torch.Generator().manual_seed(seed)).tolist()


def reference_logits(weights, hcfg, ids: list[int]) -> torch.Tensor:
    return ref.forward(weights, hcfg, torch.tensor(ids), q_block=16)


def teacher_forced(params, rows: list[list[int]], plen: int, chunk: int) -> list[torch.Tensor]:
    """Logits at every position past ``plen`` of each row, through the
    cache: the rows' common first ``plen`` tokens prefilled in chunks of
    ``chunk``, each row's next token in the absorbed form, then one token a
    step, fed the row's own tokens."""
    K = len(rows)
    cap = max(len(r) for r in rows)
    pc = torch.zeros(CFG.num_hidden_layers, 1, plen + 8, CFG.latent_dim)
    sc = torch.zeros(CFG.num_hidden_layers, K, cap, CFG.latent_dim)
    inv = M.yarn_inv_freq(CFG)
    for segs in _chunks([plen], chunk):
        ids = torch.tensor(sum((rows[0][a:b] for _, a, b in segs), []))
        M.prefill_chunk(params, CFG, pc, ids, [(g, a, a - segs[0][1], b - segs[0][1])
                                                for g, a, b in segs], inv, q_block=8)
    plens = torch.tensor([plen])
    out = [[] for _ in rows]
    for t in range(plen, cap):
        tok = torch.tensor([[r[t] if t < len(r) else 0] for r in rows])
        valid = torch.tensor([[t < len(r)] for r in rows])
        h, _ = M.forward_rows(params, CFG, tok, valid, pc, plens, sc,
                              torch.full((K,), t - plen), inv)
        lg = M.logits(params, CFG, h[:, 0])
        for k, r in enumerate(rows):
            if t < len(r):
                out[k].append(lg[k])
    return [torch.stack(o) for o in out]


def test_full_forward_matches_the_reference(tiny):
    params, weights, hcfg = tiny
    ids = prompt(1, 90)
    got = M.full_forward(params, CFG, torch.tensor(ids), q_block=16)
    want = reference_logits(weights, hcfg, ids)
    assert got.shape == (90, CFG.vocab_size)
    assert torch.allclose(got, want, atol=ATOL, rtol=0), (got - want).abs().max()


@pytest.mark.parametrize("plen,chunk,total", [(70, 24, 96), (33, 33, 60), (1, 8, 40)])
def test_chunked_prefill_then_absorbed_decode_matches_the_full_pass(tiny, plen, chunk, total):
    """Every position past the prefill, through the cache, equals the
    reference's full forward pass at that position."""
    params, weights, hcfg = tiny
    ids = prompt(plen + total, total)
    (got,) = teacher_forced(params, [ids], plen, chunk)
    want = reference_logits(weights, hcfg, ids)[plen:]
    assert torch.allclose(got, want, atol=ATOL, rtol=0), (got - want).abs().max()


def test_a_prefix_forked_into_two_rows_matches_the_two_prompts_apart(tiny):
    params, weights, hcfg = tiny
    shared = prompt(5, 50)
    rows = [shared + prompt(6, 17), shared + prompt(7, 9)]
    forked = teacher_forced(params, rows, len(shared), 16)
    for row, got in zip(rows, forked):
        alone = teacher_forced(params, [row], len(shared), 16)[0]
        want = reference_logits(weights, hcfg, row)[len(shared):]
        assert torch.allclose(got, alone, atol=ATOL, rtol=0)
        assert torch.allclose(got, want, atol=ATOL, rtol=0), (got - want).abs().max()


@pytest.mark.parametrize("masked", [False, True])
def test_grouped_moe_matches_per_token_routing(tiny, masked):
    """One grouped product per projection over the sorted (token, expert)
    pairs equals routing each token through its own top-k experts; tokens
    left out (finished rows) get the shared experts alone."""
    params, _, _ = tiny
    lp = params["layers"][1]
    x = torch.randn(37, CFG.hidden_size, generator=torch.Generator().manual_seed(2))
    valid = torch.arange(37) % 3 != 0 if masked else None
    got, touched = M.moe(x, lp, CFG, valid)
    want = torch.empty_like(x)
    chosen = set()
    fe = CFG.moe_intermediate_size
    for t in range(x.shape[0]):
        y = M.mlp(x[t:t + 1], lp["shared_gate_up"], lp["shared_down"])[0]
        if valid is None or valid[t]:
            p = torch.softmax(x[t] @ lp["router"], -1)
            w, idx = p.topk(CFG.num_experts_per_tok)
            for wi, e in zip(w, idx.tolist()):
                chosen.add(e)
                gu = lp["experts_gate_up"][e]
                y = y + wi * M.mlp(x[t:t + 1], gu, lp["experts_down"][e])[0]
                assert gu.shape == (CFG.hidden_size, 2 * fe)
        want[t] = y
    assert torch.allclose(got, want, atol=1e-5, rtol=0), (got - want).abs().max()
    assert int(touched) == len(chosen)


def test_the_benchmarks_copy_of_the_reference_gives_the_same_logits(tiny):
    _, weights, hcfg = tiny
    spec = importlib.util.spec_from_file_location(
        "bench_ref", ROOT / "portbench" / "reference" / "deepseek_v2.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    ids = torch.tensor(prompt(9, 70))
    assert torch.equal(bench.forward(weights, hcfg, ids, q_block=16),
                       ref.forward(weights, hcfg, ids, q_block=16))


def test_published_names_map_into_the_port_and_back(tiny):
    """A seeded state dict under the published checkpoint's names
    (``kv_a_proj_with_mqa``, ``kv_b_proj``, ``mlp.gate``,
    ``mlp.experts.{j}.*_proj``, ``mlp.shared_experts.*``, ``lm_head``, ...)
    goes into the port's layout, where it computes the reference's logits;
    ``to_hf`` gives the same tensors back."""
    _, _, hcfg = tiny
    g = torch.Generator().manual_seed(11)
    shapes = {k: v.shape for k, v in ck.to_hf(ck.random_params(CFG, 0, "cpu", torch.float32),
                                               CFG).items()}
    sd = {k: torch.randn(s, generator=g) / 4 for k, s in shapes.items()}
    assert "model.layers.1.mlp.experts.7.down_proj.weight" in sd
    assert "model.layers.0.mlp.gate_proj.weight" in sd and "lm_head.weight" in sd
    assert "model.layers.2.mlp.shared_experts.up_proj.weight" in sd
    params = ck.params_from_hf(sd, CFG)
    back = ck.to_hf(params, CFG)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    ids = prompt(12, 60)
    got = M.full_forward(params, CFG, torch.tensor(ids))
    assert torch.allclose(got, reference_logits(sd, hcfg, ids), atol=ATOL, rtol=0)


def test_the_published_config_reads_as_deepseek_v2_lite():
    cfg = json.loads((ROOT / "portbench" / "configs" / "deepseek-v2-lite.json").read_text())
    conf = DeepseekV2Config.from_dict(cfg, name="deepseek-v2-lite")
    assert conf == PRESETS["deepseek-v2-lite"]
    assert conf.softmax_scale == pytest.approx(192 ** -0.5 * (0.1 * 0.707 * 3.6888794541 + 1) ** 2)
    assert conf.softmax_scale == pytest.approx(0.11472, abs=1e-5)
    assert conf.moe_layers == 26 and conf.latent_dim == 576
    # 15.71 B parameters: embedding and head, final norm, 27 attention blocks
    # (q, kv_a, kv_b, o and three norms), the dense MLP, 26 MoE layers (64
    # experts, the shared pair at width 2,816, the router)
    n = sum(math.prod(shape) for _, shape, _, _ in ck.param_spec(conf))
    attn = 2048 * 3072 + 2048 * 576 + 512 * 4096 + 2048 * 2048 + 2 * 2048 + 512
    moe = 64 * 3 * 2048 * 1408 + 3 * 2048 * 2816 + 2048 * 64
    assert n == 2 * 102_400 * 2048 + 2048 + 27 * attn + 3 * 2048 * 10_944 + 26 * moe
    assert n == 15_706_484_224


@pytest.mark.parametrize("key,value", [("q_lora_rank", 1536), ("scoring_func", "sigmoid"),
                                       ("topk_method", "group_limited_greedy"), ("n_group", 8),
                                       ("tie_word_embeddings", True)])
def test_a_variant_the_port_does_not_compute_is_refused(key, value):
    cfg = json.loads((ROOT / "portbench" / "configs" / "deepseek-v2-lite.json").read_text())
    with pytest.raises(NotImplementedError, match=key):
        DeepseekV2Config.from_dict(dict(cfg, **{key: value}))


def test_yarn_frequencies_and_scale_are_the_references(tiny):
    _, _, hcfg = tiny
    pos = torch.arange(0, 200, 7)
    rot = M.rope_tables(pos, M.yarn_inv_freq(CFG), M.rope_mscale(CFG))
    cos, sin, scale = ref._rotary(hcfg, pos)
    assert torch.allclose(rot.real, cos[:, :CFG.qk_rope_head_dim // 2], atol=1e-6)
    assert torch.allclose(rot.imag, sin[:, :CFG.qk_rope_head_dim // 2], atol=1e-6)
    assert scale == pytest.approx(CFG.softmax_scale, rel=1e-12)


def test_prefill_chunks_pack_groups_in_order():
    assert list(_chunks([5, 3, 9], 8)) == [[(0, 0, 5), (1, 0, 3)], [(2, 0, 8)], [(2, 8, 9)]]
    assert list(_chunks([0, 4], 4)) == [[(1, 0, 4)]]
    assert _common_prefix([[1, 2, 3], [1, 2, 4], [1, 2]]) == 2


@pytest.fixture
def small_blocks(monkeypatch):
    """Chunks, cache blocks and read-backs of a tiny size."""
    for name, v in (("CHUNK_TOKENS", 40), ("CACHE_BLOCK", 64), ("READBACK_EVERY", 3),
                    ("MAX_BUFFERS", 1)):
        monkeypatch.setattr(generate, name, v)


def test_generate_serves_greedy_tokens_of_the_reference_and_counts(tiny, small_blocks):
    """Grouped greedy rows: each served token is the reference's best at
    its position (within the tolerance), rows stop at their caps, and the
    call's spans and counters land in the open request."""
    from audio_processor_tpu_torch.runtime import trace

    params, weights, hcfg = tiny
    shared = prompt(20, 75)
    groups = [[shared + prompt(21, 5), shared + prompt(22, 3)],
              [prompt(23, 30), prompt(23, 30)[:20] + prompt(24, 4)]]
    caps = [[9, 4], [1, 6]]
    with trace.request() as rec:
        out = Engine(params, CFG, "cpu").generate(groups, caps)
    for grp, cs, outs in zip(groups, caps, out):
        for p, c, o in zip(grp, cs, outs):
            assert len(o) == c
            lg = reference_logits(weights, hcfg, p + o[:-1])[len(p) - 1:]
            gap = lg.max(-1).values - lg.gather(1, torch.tensor(o)[:, None])[:, 0]
            assert float(gap.max()) <= ATOL
    s = rec.summary()
    assert s["counters"]["llm.decode.rows"] == 4
    assert s["counters"]["llm.decode.steps"] == 8  # the longest row's cap less its first token
    assert s["counters"]["llm.prefill_tokens"] == 75 + 20 + 5 + 3 + 10 + 4  # prefixes once
    assert 0 < s["counters"]["llm.moe.experts_touched"] <= 8 * 2 * CFG.n_routed_experts
    assert s["counters"]["llm.decode.cache_tokens"] > 0
    assert set(s["spans"]) == {"llm.prefill", "llm.decode", "llm.decode.step", "llm.decode.wait"}
    assert s["spans"]["llm.decode.wait"]["count"] == 3  # every third step, and the last


def test_sessions_are_kept_by_shape_and_the_oldest_dropped(tiny, small_blocks):
    params, _, _ = tiny
    eng = Engine(params, CFG, "cpu")
    eng.generate([[prompt(1, 10)]], [[2]])
    first = eng._sessions[(1, 1, 64, 256)]
    eng.generate([[prompt(2, 12)]], [[3]])
    assert eng._sessions[(1, 1, 64, 256)] is first
    eng.generate([[prompt(3, 100)]], [[2]])
    assert list(eng._sessions) == [(1, 1, 128, 256)] and list(eng._buffers) == [(1, 128)]
    with pytest.raises(ValueError, match="same number of rows"):
        eng.generate([[prompt(1, 4)], [prompt(1, 4), prompt(2, 4)]], [[1], [1, 1]])
    with pytest.raises(ValueError, match="at least one token"):
        eng.generate([[[]]], [[1]])
    with pytest.raises(ValueError, match="1281 positions"):
        eng.generate([[prompt(1, 1200)]], [[81]])


@pytest.mark.cuda
def test_one_graph_replay_of_the_step_equals_the_eager_step(small_blocks):
    """On the card: the captured decode step, replayed once, leaves the
    same state (tokens, lengths, finished flags, outputs, cache) as the
    eager step from the same state."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the decode step's CUDA graph exists only on the card")
    dev = torch.device("cuda")
    params = ck.random_params(CFG, 5, dev, torch.bfloat16)
    eng = Engine(params, CFG, dev)
    shared = prompt(30, 70)
    with torch.inference_mode():
        eng.generate([[shared + [1, 2], shared + [3]]] * 3, [[12, 7]] * 3)
        (sess,) = eng._sessions.values()
        assert sess.graph is not None
        sess.active[::2] = True
        sess.cap.fill_(50)
        start = [t.clone() for t in sess._state()] + [sess.sc.clone()]
        sess.graph.replay()
        replayed = [t.clone() for t in sess._state()] + [sess.sc.clone()]
        for t, s in zip(list(sess._state()) + [sess.sc], start):
            t.copy_(s)
        sess.step()
        eager = list(sess._state()) + [sess.sc]
        for a, b in zip(replayed, eager):
            assert torch.equal(a, b)
        assert not torch.equal(replayed[5], start[5])  # the step wrote tokens
