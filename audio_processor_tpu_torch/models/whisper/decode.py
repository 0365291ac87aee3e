"""Batched KV-cache decode for Whisper, in PyTorch: greedy/sampling,
prompted (per-row <|startofprev|> context) and beam search.

The port of the JAX package's ``models/whisper/decode.py``: special tokens
and suppress lists, the KV cache (the int4 nibble-packed and int8 kernel
layouts of the cross cache), the cached decoder forward with left-padded
per-row prompts, Whisper's logit rules, the greedy/sampling loop with
best_of ranking, prompted greedy decode, beam search with openai's
BeamSearchDecoder semantics, language detection, and the host-side seek
and segment helpers.  Each decode's cache and prefill, each step of its
loop, and each read-back of the finished flags are spans of the open
request's trace (``decode.prefill``, ``decode.step``, ``decode.wait``;
``runtime/trace.py``), and the counter ``decode.steps`` counts the steps:
a step's host issue time is its span less its wait.

Every greedy or sampling decode runs in one loop, a session of fixed
buffers (``_DecodeSession``): each step has fixed shapes (the token's
slot is a device tensor, and self-attention reads every slot of the
cache with the later ones masked, as the JAX package's while_loop does),
and the finished flags are read every ``READBACK_EVERY`` steps.  On the
card a greedy decode (temperature 0, no model split, nothing requiring
grad) takes a session kept per shape, whose steps from the third on
replay CUDA graphs captured once, cut at each launch of a hand-written
cross-attention kernel, which runs between them through its wrapper; the
counter ``decode.graph_steps`` counts the replayed steps.  Every other
decode (the CPU, sampling, tp > 1, grad, or every kept session of its
shape busy) runs a session made for it alone, eagerly, to the same
tokens: no decode falls back to another loop.  Beam search has its own
loop, which reads the flags every step.

Differences in idiom from the JAX version:
  * The self-attention cache is head-major, (L, B, H, T_max, Dh), so the
    per-step attention matmuls read it without a transposing copy, and it
    is written IN PLACE (the JAX version's dynamic_update_slice returns a
    new array), which saves a copy of the cache per step.  Beam search
    reorders only the written positions of the self cache, in place (the
    JAX version gathers the whole cache along the batch axis).
  * The token loops are Python loops that stop once every row has emitted
    EOT (greedy/sampling, at the next read of the flags) or every element
    holds its finished hypotheses (beam), the JAX package's lax.while_loop
    conditions.  The outputs are the same: steps past a row's EOT write
    EOT and add 0, and the JAX loops' extra final forward produces logits
    nobody reads.
  * Sampling at T > 0 draws by Gumbel-max from a counter-based stream
    keyed by (``rng_seed``, the row's index in the whole batch, the step,
    the vocab id), so a row's draws do not depend on the batch shape or
    the data-parallel degree; its numbers differ from ``jax.random``'s.
  * Beam search breaks ties as ``jax.lax.top_k`` and the stable
    ``jnp.argsort`` do, toward the lower index (``_top_k_lower_index``,
    ``torch.argsort(stable=True)``); ``torch.topk`` promises no order.
  * Under a (data, model) mesh (``mesh=``) the parameters are this model
    rank's slices (``parallel/sharding.py``) and the decodes run on the
    rank's rows: self- and cross-attention on its heads (the caches hold
    only those), the three row-parallel products summed over the model
    group, and the int4 cross-attention through kernel #5.  The logits
    follow the all-reduce and a replicated unembedding, so they, and every
    token picked from them, are the same on every rank of a model group;
    a data rank samples its rows from their streams in the whole batch, as
    one process would.  JAX shards one program
    over the mesh instead (GSPMD).
"""
from __future__ import annotations

import math
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ...ops.kernels.decode_attention import (
    cross_attention_int4_stacked,
    cross_attention_int4_stacked_tp,
    cross_attention_int8,
    pack_int4_time,
)
from ...runtime import trace
from .config import WhisperConfig
from .model import (
    Params,
    layer,
    layer_norm,
    linear,
    local_heads,
    merge_heads,
    mlp,
    row_parallel_linear,
    split_heads,
)

NEG_INF = float("-inf")


# ---------------------------------------------------------------------------
# Special-token layout (derived from vocab size — no vocab file needed)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SpecialTokens:
    """Whisper special-token ids, derived from the vocabulary size.

    Multilingual vocab (>=51865): text tokens end at 50257 (GPT-2 vocab),
    then eot, sot, language tokens, task tokens, timestamps.  The .en models
    are shifted down by one (50256-base).
    """

    eot: int
    sot: int
    lang_begin: int
    num_languages: int
    translate: int
    transcribe: int
    startoflm: int
    startofprev: int
    no_speech: int
    no_timestamps: int
    timestamp_begin: int
    n_vocab: int

    @classmethod
    def for_config(cls, cfg: WhisperConfig) -> "SpecialTokens":
        if cfg.n_vocab >= 51865:
            eot = 50257
            num_languages = cfg.n_vocab - 51765 - 1  # 99 (v2) or 100 (v3)
        elif cfg.n_vocab == 51864:
            eot = 50256
            num_languages = 99
        else:  # tiny test vocabs: reserve the tail of the vocab
            num_languages = 2
            eot = cfg.n_vocab - (num_languages + 10 + 16)
        sot = eot + 1
        lang_begin = sot + 1
        translate = lang_begin + num_languages
        transcribe = translate + 1
        startoflm = transcribe + 1
        startofprev = startoflm + 1
        no_speech = startofprev + 1
        no_timestamps = no_speech + 1
        timestamp_begin = no_timestamps + 1
        return cls(
            eot=eot,
            sot=sot,
            lang_begin=lang_begin,
            num_languages=num_languages,
            translate=translate,
            transcribe=transcribe,
            startoflm=startoflm,
            startofprev=startofprev,
            no_speech=no_speech,
            no_timestamps=no_timestamps,
            timestamp_begin=timestamp_begin,
            n_vocab=cfg.n_vocab,
        )

    def sot_sequence(
        self, language: int | None = None, task: str = "transcribe",
        timestamps: bool = True,
    ) -> list[int]:
        seq = [self.sot]
        if self.n_vocab >= 51865:
            seq.append(self.lang_begin if language is None else self.lang_begin + language)
            seq.append(self.transcribe if task == "transcribe" else self.translate)
        if not timestamps:
            seq.append(self.no_timestamps)
        return seq


# ---------------------------------------------------------------------------
# Standard suppress list (openai-whisper's SuppressTokens default)
# ---------------------------------------------------------------------------

_NON_SPEECH_SYMBOLS = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』') + (
    "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪".split()
)
_MISC_SYMBOLS = set("♩♪♫♬♭♮♯")


def non_speech_token_ids(tokenizer) -> list[int]:
    """Token ids of non-speech annotation symbols (openai's list)."""
    ids: set[int] = set()
    for prefix in (" -", " '"):
        toks = tokenizer.encode(prefix)
        if toks:
            ids.add(toks[0])
    for symbol in _NON_SPEECH_SYMBOLS + list(_MISC_SYMBOLS):
        for variant in (symbol, " " + symbol):
            toks = tokenizer.encode(variant)
            if len(toks) == 1:
                ids.add(toks[0])
            elif toks and symbol in _MISC_SYMBOLS:
                ids.add(toks[0])
    return sorted(ids)


def always_suppressed_specials(st: SpecialTokens) -> list[int]:
    """The special ids openai suppresses regardless of suppress_tokens."""
    return [st.sot, st.translate, st.transcribe, st.startoflm,
            st.startofprev, st.no_speech]


def build_suppress_mask(tokenizer, st: SpecialTokens) -> np.ndarray:
    """(V,) bool mask of always-suppressed ids: non-speech symbols +
    sot/task/lm/prev/nospeech specials."""
    mask = np.zeros(st.n_vocab, bool)
    for t in always_suppressed_specials(st) + non_speech_token_ids(tokenizer):
        if 0 <= t < st.n_vocab:
            mask[t] = True
    return mask


def space_blank_token_id(tokenizer, st: SpecialTokens) -> int | None:
    """Id of the " " token for the SuppressBlank rule (first sample)."""
    toks = tokenizer.encode(" ")
    if toks and 0 <= toks[0] < st.n_vocab:
        return int(toks[0])
    return None


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

@dataclass
class Cache:
    self_k: torch.Tensor  # (L, B, H, T_max, Dh), written in place; int8 when quantized
    self_v: torch.Tensor
    # float: (L, B, Ta, H, Dh); int8: (L, B, Ta, H, Dh); int8 kernel
    # layout: K (L, B, H, Dh, Tpad), V (L, B, H, Tpad, Dh); int4 kernel
    # layout: K (L, B, H, Dh, Tpad/2), V (L, B, H, Tpad/2, Dh)
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    cross_k_scale: torch.Tensor | None = None  # (L, B, 1, H, Dh)
    cross_v_scale: torch.Tensor | None = None
    cross_bits: int = 8  # precision of a quantized cross cache: 8 or 4
    # per-token scales of the int8 self cache (L, B, H, T_max, 1): each new
    # token is quantized over its channels when it is written, K's scale
    # folds into the scores after QK^T and V's into the probabilities
    self_k_scale: torch.Tensor | None = None
    self_v_scale: torch.Tensor | None = None


def _cross_kv(bp: Params, n_head: int, audio_states: torch.Tensor):
    """One decoder layer's cross K/V over the encoder states: (B, Ta, H, Dh)
    for the n_head heads held here."""
    k = split_heads(linear(bp["cross_attn"]["k"], audio_states), n_head)
    v = split_heads(linear(bp["cross_attn"]["v"], audio_states), n_head)
    return k, v


def precompute_cross_attn(
    params: Params, cfg: WhisperConfig, audio_states: torch.Tensor, mesh=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K/V over encoder states for every decoder layer: (L, B, Ta, H, Dh),
    H the heads of this model rank."""
    blocks = params["decoder"]["blocks"]
    h = local_heads(cfg.n_text_head, mesh)
    ck = cv = None
    for l in range(cfg.n_text_layer):  # filled a layer at a time: one copy live
        k, v = _cross_kv(layer(blocks, l), h, audio_states)
        if ck is None:
            ck = k.new_empty((cfg.n_text_layer,) + k.shape)
            cv = v.new_empty((cfg.n_text_layer,) + v.shape)
        ck[l], cv[l] = k, v
    return ck, cv


def _quantize_kv(x: torch.Tensor, bits: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(layer, batch, head, channel) symmetric int8/int4 over time
    (axis 2 of (L, B, T, H, Dh)).  torch.round rounds half to even, as
    jnp.round does."""
    qmax = 127.0 if bits == 8 else 7.0
    amax = x.abs().amax(dim=2, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / qmax
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int8)
    return q, scale.float()


def init_cache(
    params: Params,
    cfg: WhisperConfig,
    audio_states: torch.Tensor,
    max_len: int,
    dtype: torch.dtype = torch.float32,
    quantize_cross_kv: bool = False,
    kernel_layout: bool = False,
    kv_bits: int = 8,
    mesh=None,
    quantize_self_kv: bool = False,
    into: Cache | None = None,
) -> Cache:
    """Preallocate the self cache and precompute the cross cache, for the
    heads of this model rank under a mesh.

    quantize_self_kv: the self cache is int8 with a float32 scale per
    (layer, row, head, token), written by ``decoder_forward_cached``.

    quantize_cross_kv: int8 per (layer, batch, head, channel).  With
    kernel_layout the cache is transposed to K (L, B, H, Dh, Tpad) and V
    (L, B, H, Tpad, Dh) and zero-padded to Tpad = ceil(Ta/128)*128 for the
    decode kernels; kv_bits=4 further quantizes to int4 and nibble-packs
    the time axis.  The quantized cache is built one layer at a time, so
    the float K/V of only one layer is live at once (the result equals
    quantizing the stack).  The quantization is per head, so a rank's
    cache bytes are the head slice of the whole cache's.

    into: a cache of these shapes (``_new_cache``) to fill in place, its
    self cache zeroed, instead of allocating one.
    """
    if quantize_cross_kv and kernel_layout and kv_bits not in (4, 8):
        raise ValueError(f"kv_bits must be 4 or 8, got {kv_bits}")
    bits = kv_bits if (quantize_cross_kv and kernel_layout) else 8
    b, ta = audio_states.shape[:2]
    if into is None:
        cache = _new_cache(cfg, b, ta, max_len, dtype, quantize_cross_kv, kernel_layout, bits,
                           mesh, quantize_self_kv, audio_states.device, float_cross=False)
    else:
        cache = into
        for c in (cache.self_k, cache.self_v, cache.self_k_scale, cache.self_v_scale):
            if c is not None:
                c.zero_()
    h = local_heads(cfg.n_text_head, mesh)
    audio = audio_states.to(dtype)
    if not quantize_cross_kv:
        ck, cv = precompute_cross_attn(params, cfg, audio, mesh)
        if into is None:
            cache.cross_k, cache.cross_v = ck.to(dtype), cv.to(dtype)
        else:
            cache.cross_k.copy_(ck)
            cache.cross_v.copy_(cv)
        return cache
    tpad = ta + (-ta) % 128
    blocks = params["decoder"]["blocks"]
    for l in range(cfg.n_text_layer):
        k, v = _cross_kv(layer(blocks, l), h, audio)
        k8, cache.cross_k_scale[l] = _quantize_kv(k[None].float(), bits=bits)
        v8, cache.cross_v_scale[l] = _quantize_kv(v[None].float(), bits=bits)
        k8, v8 = k8[0], v8[0]
        if kernel_layout:
            pad = tpad - ta
            k8 = torch.nn.functional.pad(k8.permute(0, 2, 3, 1), (0, pad))  # (B,H,Dh,Tpad)
            v8 = torch.nn.functional.pad(v8.permute(0, 2, 1, 3), (0, 0, 0, pad))  # (B,H,Tpad,Dh)
            if bits == 4:
                k8, v8 = pack_int4_time(k8, v8)
        cache.cross_k[l] = k8
        cache.cross_v[l] = v8
    return cache


def _new_cache(cfg, b, ta, max_len, dtype, quantize_cross_kv, kernel_layout, bits, mesh,
               quantize_self_kv, device, float_cross=True) -> Cache:
    """An unfilled cache of ``init_cache``'s shapes, the self cache zeroed.
    float_cross=False leaves an unquantized cross cache out (None), for
    init_cache to stack."""
    n_layer, h = cfg.n_text_layer, local_heads(cfg.n_text_head, mesh)
    dh = cfg.n_text_state // cfg.n_text_head  # the model's head width under any split
    shape = (n_layer, b, h, max_len, dh)
    self_dtype = torch.int8 if quantize_self_kv else dtype
    self_k = torch.zeros(shape, dtype=self_dtype, device=device)
    self_v = torch.zeros(shape, dtype=self_dtype, device=device)
    scales = {}
    if quantize_self_kv:
        scales = dict(
            self_k_scale=torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=device),
            self_v_scale=torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=device),
        )
    if not quantize_cross_kv:
        if not float_cross:
            return Cache(self_k, self_v, None, None, **scales)
        ck = torch.empty((n_layer, b, ta, h, dh), dtype=dtype, device=device)
        return Cache(self_k, self_v, ck, torch.empty_like(ck), **scales)
    tpad = ta + (-ta) % 128
    if kernel_layout:
        cols = tpad // 2 if bits == 4 else tpad
        ck = torch.empty((n_layer, b, h, dh, cols), dtype=torch.int8, device=device)
        cv = torch.empty((n_layer, b, h, cols, dh), dtype=torch.int8, device=device)
    else:
        ck = torch.empty((n_layer, b, ta, h, dh), dtype=torch.int8, device=device)
        cv = torch.empty_like(ck)
    ks = torch.empty((n_layer, b, 1, h, dh), dtype=torch.float32, device=device)
    return Cache(self_k, self_v, ck, cv, ks, torch.empty_like(ks), cross_bits=bits, **scales)


# ---------------------------------------------------------------------------
# Cached decoder forward (prefill with T>1, or single-step with T=1)
# ---------------------------------------------------------------------------

def _cached_attention(q, kh, vh, t_valid=None, min_valid=None, k_scale=None, v_scale=None):
    """q (B,T,H,Dh) against head-major keys/values kh, vh (B,H,Tk,Dh).
    t_valid: (T,) how many cache positions each query sees (causality
    inside the prefill window); None = all of them.  min_valid: (B,) first
    visible cache position of each row, which hides the left padding of
    prompted rows.  Scores are softmaxed in float32.  k_scale/v_scale:
    (B,H,Tk,1) per-token scales of an int8 cache: K's multiplies the
    scores after QK^T, V's the probabilities before they round to q's
    dtype, as in the JAX ``_cached_attention``."""
    dh = q.shape[-1]
    qh = q.transpose(1, 2)  # (B, H, T, Dh)
    if k_scale is not None:
        kh, vh = kh.to(q.dtype), vh.to(q.dtype)
    scores = torch.matmul(qh, kh.transpose(-1, -2)).float() * (1.0 / math.sqrt(dh))
    if k_scale is not None:
        scores = scores * k_scale.transpose(-1, -2)  # (B, H, 1, Tk)
    if t_valid is not None:
        pos = torch.arange(kh.shape[2], device=q.device)
        mask = pos[None, :] < t_valid[:, None]  # (T, Tk)
        if min_valid is not None:
            # padding queries must still see THEMSELVES: a fully masked row
            # softmaxes to NaN, and 0 x NaN in the value sum then poisons
            # every later layer for the real tokens too.  Real tokens sit at
            # positions >= min_valid, so the self term changes nothing for
            # them; pad outputs are finite and never read.
            self_vis = pos[None, :] == (t_valid - 1)[:, None]  # (T, Tk)
            vis = (pos[None, None, :] >= min_valid[:, None, None]) | self_vis[None]
            mask = (mask[None] & vis)[:, None]  # (B, 1, T, Tk)
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale.transpose(-1, -2)
    out = torch.matmul(probs.to(q.dtype), vh)
    return out.transpose(1, 2).to(q.dtype)


def _quantize_token(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8 over the channel axis: (..., Dh) -> (int8
    values, (..., 1) float32 scales)."""
    x = x.float()
    scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), scale


def decoder_forward_cached(
    params: Params,
    cfg: WhisperConfig,
    tokens: torch.Tensor,  # (B, T)
    cache: Cache,
    pos,  # write offset into the self cache: an int, or a (1,) long tensor when T == 1
    *,
    pos_offset: torch.Tensor | None = None,  # (B,) per-row logical offset
    min_valid: torch.Tensor | None = None,  # (B,) first visible cache slot
    compute_dtype: torch.dtype | None = None,
    kernel_layout: bool = False,
    logit_positions: tuple[int, ...] | None = None,
    unembed: torch.Tensor | None = None,
    mesh=None,
) -> tuple[torch.Tensor, Cache]:
    """Run the decoder over T new tokens, writing their K/V into the cache
    at ``pos`` (in place).  Returns (logits (B, T', V) float32, cache).

    pos as a device tensor (one token): the step of fixed shapes that the
    decode session runs and captures (``_decoder_layers``).
    pos_offset/min_valid serve LEFT-padded per-row prompts: a row whose
    real tokens start at slot ``pad`` takes positional embeddings counted
    from 0 at that slot (pos_offset=pad) and never attends to the padding
    (min_valid=pad).
    kernel_layout: the quantized cross cache is in the kernel layout
    (init_cache's kernel_layout), read through kernel B (an int4 cache) or
    the int8 kernel (an int8 cache).
    logit_positions: unembed only these token positions (the prefill reads
    the sot slot and the last position).
    unembed: the token embedding in float32, when the caller holds one
    across steps (the decode loops convert it once per decode).
    mesh: the params and the cache are this model rank's (its heads); the
    int4 cross-attention runs through kernel #5 when tp > 1.
    """
    layers = _decoder_layers(
        params, cfg, tokens, cache, pos, pos_offset=pos_offset, min_valid=min_valid,
        compute_dtype=compute_dtype, kernel_layout=kernel_layout,
        logit_positions=logit_positions, unembed=unembed, mesh=mesh,
    )
    return _drive(layers, lambda l, q: _cross_kernel(cache, cfg, mesh, l, q)), cache


def _drive(layers, launch):
    """Run a ``_decoder_layers`` generator to its logits, answering each
    kernel request (l, q) with ``launch(l, q)``."""
    try:
        req = next(layers)
        while True:
            req = layers.send(launch(*req))
    except StopIteration as done:
        return done.value


def _cross_kernel(cache: Cache, cfg: WhisperConfig, mesh, l: int, q: torch.Tensor, out=None):
    """Layer l's cross-attention through the hand-written kernel of the
    cache's layout (kernel B, #5 when tp > 1, or #3), q (B, T, H, Dh)
    float32 with K's scale folded in.  Each wrapper is looked up by its
    module name at the call, so a wrapper put on that name sees every
    launch.  out: the output buffer (kernels B and #3)."""
    out = {} if out is None else {"out": out}
    if cache.cross_bits == 4 and mesh is not None and mesh.tp > 1:
        return cross_attention_int4_stacked_tp(
            mesh, q, cache.cross_k, cache.cross_v, l,
            valid_len=cfg.n_audio_ctx, n_head=cfg.n_text_head,
        )
    if cache.cross_bits == 4:
        return cross_attention_int4_stacked(
            q, cache.cross_k, cache.cross_v, l, valid_len=cfg.n_audio_ctx, **out,
        )
    return cross_attention_int8(
        q, cache.cross_k[l], cache.cross_v[l], valid_len=cfg.n_audio_ctx, **out,
    )


def _decoder_layers(
    params, cfg, tokens, cache, pos, *, pos_offset, min_valid, compute_dtype,
    kernel_layout, logit_positions, unembed, mesh,
):
    """``decoder_forward_cached`` as a generator: where a hand-written
    cross-attention kernel runs it yields (layer, q) and takes the
    kernel's (B, T, H, Dh) float32 output; it returns the logits.  So the
    graph-replayed decode can cut its captures at the launches.

    pos a (1,) long tensor (T == 1): the token goes to that slot by an
    indexed write and attends over every slot of the cache, the slots past
    it masked (they softmax to exactly 0), so no shape depends on it."""
    p = params["decoder"]
    b, t = tokens.shape
    static = isinstance(pos, torch.Tensor)
    quantized_self = cache.self_k_scale is not None
    if compute_dtype is not None:
        dtype = compute_dtype
    elif quantized_self:
        # an int8 self cache carries no activation dtype: the float cross
        # cache's, else float32
        dtype = cache.cross_k.dtype if cache.cross_k.is_floating_point() else torch.float32
    else:
        dtype = cache.self_k.dtype
    steps = pos if static else pos + torch.arange(t, device=tokens.device)
    if pos_offset is not None:
        pe = p["pos_emb"][torch.clamp(steps[None, :] - pos_offset[:, None], min=0)]
    elif static:
        pe = p["pos_emb"][pos]
    else:
        pe = p["pos_emb"][pos : pos + t]
    x = p["token_emb"][tokens].to(dtype) + pe.to(dtype)
    t_valid = steps + 1
    # positions past pos+t are masked for every query: leave them out,
    # unless the step's shapes must not depend on pos
    seen = slice(None) if static else slice(0, pos + t)
    quantized = cache.cross_k_scale is not None
    n_head = local_heads(cfg.n_text_head, mesh)
    for l in range(cfg.n_text_layer):
        bp = layer(p["blocks"], l)
        # --- causal self-attention against the running cache
        xn = layer_norm(bp["attn_ln"], x)
        q = split_heads(linear(bp["attn"]["q"], xn), n_head)
        k_new = split_heads(linear(bp["attn"]["k"], xn), n_head)
        v_new = split_heads(linear(bp["attn"]["v"], xn), n_head)
        scales = {}
        if quantized_self:
            k8, k_sc = _quantize_token(k_new.transpose(1, 2))
            v8, v_sc = _quantize_token(v_new.transpose(1, 2))
            writes = ((cache.self_k, k8), (cache.self_v, v8),
                      (cache.self_k_scale, k_sc), (cache.self_v_scale, v_sc))
            scales = dict(k_scale=cache.self_k_scale[l, :, :, seen],
                          v_scale=cache.self_v_scale[l, :, :, seen])
        else:
            writes = ((cache.self_k, k_new.transpose(1, 2)), (cache.self_v, v_new.transpose(1, 2)))
        for c, new in writes:
            if static:
                c[l].index_copy_(2, pos, new)
            else:
                c[l, :, :, pos : pos + t] = new
        o = _cached_attention(
            q, cache.self_k[l, :, :, seen], cache.self_v[l, :, :, seen],
            t_valid, min_valid, **scales,
        )
        x = x + row_parallel_linear(bp["attn"]["out"], merge_heads(o), mesh)
        # --- cross-attention against the precomputed encoder K/V
        xa = layer_norm(bp["cross_attn_ln"], x)
        qx = split_heads(linear(bp["cross_attn"]["q"], xa), n_head)
        if quantized:
            # K's dequant scale folds into q, V's after the probs matmul
            qx = qx * cache.cross_k_scale[l].to(qx.dtype)
            if kernel_layout:
                ox = (yield l, qx.float().contiguous()).to(x.dtype)
            else:
                ox = _cached_attention(
                    qx, cache.cross_k[l].to(x.dtype).transpose(1, 2),
                    cache.cross_v[l].to(x.dtype).transpose(1, 2),
                )
            ox = ox * cache.cross_v_scale[l].to(ox.dtype)
        else:
            ox = _cached_attention(
                qx, cache.cross_k[l].transpose(1, 2), cache.cross_v[l].transpose(1, 2)
            )
        x = x + row_parallel_linear(bp["cross_attn"]["out"], merge_heads(ox), mesh)
        # --- MLP
        x = x + mlp(bp, layer_norm(bp["mlp_ln"], x), mesh)
    if logit_positions is not None:
        x = x[:, [q % t for q in logit_positions]]
    x = layer_norm(p["ln"], x)
    # unembed in float32 (products of bf16 values are exact in float32, so
    # this is the JAX dot with preferred_element_type=float32): bf16 logits
    # would round away the argmax margin
    if unembed is None:
        unembed = p["token_emb"].float()
    return torch.matmul(x.float(), unembed.T)


# ---------------------------------------------------------------------------
# Logit rules (vectorised ApplyTimestampRules / SuppressBlank / SuppressTokens)
# ---------------------------------------------------------------------------

def apply_logit_rules(
    logits: torch.Tensor,  # (B, V) float32
    st: SpecialTokens,
    *,
    step: int,  # tokens sampled so far (0 at first sample)
    last_token: torch.Tensor,  # (B,)
    penultimate_token: torch.Tensor,  # (B,)
    max_ts_token: torch.Tensor,  # (B,) highest timestamp sampled so far (or tb-1)
    suppress_mask: torch.Tensor | None,  # (V,) bool — True = suppress
    use_timestamps: bool,
    max_initial_timestamp_index: int | None = 50,
    space_blank_id: int | None = None,
) -> torch.Tensor:
    """All Whisper sampling constraints as one vectorised mask pass (the
    JAX ``apply_logit_rules``, rule for rule)."""
    v = logits.shape[-1]
    vocab_ids = torch.arange(v, device=logits.device)
    tb = st.timestamp_begin

    # 1. static suppress list (non-speech symbols, sot/notimestamps/...)
    if suppress_mask is not None:
        logits = logits.masked_fill(suppress_mask[None, :], NEG_INF)

    # 2. suppress blank at the first sample: " " and EOT
    if space_blank_id is not None and step == 0:
        blank = (vocab_ids == space_blank_id) | (vocab_ids == st.eot)
        logits = logits.masked_fill(blank[None, :], NEG_INF)

    if not use_timestamps:
        return logits

    is_ts = vocab_ids >= tb  # (V,)
    last_was_ts = last_token >= tb
    penult_was_ts = (penultimate_token >= tb) | (step < 2)

    # 2b. <|notimestamps|> is never legal in timestamp mode
    logits = logits.masked_fill((vocab_ids == st.no_timestamps)[None, :], NEG_INF)

    # 3. ts-pairing: after <ts> <ts> force text; after text <ts> force ts/EOT
    mask_ts = last_was_ts & penult_was_ts
    mask_text = last_was_ts & ~penult_was_ts
    text_ids = vocab_ids < st.eot
    logits = logits.masked_fill(mask_ts[:, None] & is_ts[None, :], NEG_INF)
    logits = logits.masked_fill(mask_text[:, None] & text_ids[None, :], NEG_INF)

    # 4. timestamps are non-decreasing (a lone timestamp may repeat once)
    lone_ts = last_was_ts & ~penult_was_ts
    floor = torch.where(lone_ts, max_ts_token, max_ts_token + 1)
    below = vocab_ids[None, :] < floor[:, None]
    logits = logits.masked_fill(below & is_ts[None, :], NEG_INF)

    # 5. first sample must be a timestamp, capped at max_initial_timestamp
    if step == 0:
        logits = logits.masked_fill(~is_ts[None, :], NEG_INF)
        if max_initial_timestamp_index is not None:
            too_late = vocab_ids > tb + max_initial_timestamp_index
            logits = logits.masked_fill(too_late[None, :], NEG_INF)

    # 6. if total timestamp probability beats the best text token, force ts
    logprobs = torch.log_softmax(logits, dim=-1)
    ts_lp = torch.logsumexp(logprobs.masked_fill(~is_ts[None, :], NEG_INF), dim=-1)
    max_text_lp = logprobs.masked_fill(is_ts[None, :], NEG_INF).amax(dim=-1)
    force_ts = ts_lp > max_text_lp
    return logits.masked_fill(force_ts[:, None] & ~is_ts[None, :], NEG_INF)


# ---------------------------------------------------------------------------
# Greedy / sampling decode loop
# ---------------------------------------------------------------------------

class DecodeResult(NamedTuple):
    tokens: torch.Tensor  # (B, max_new) int64, EOT-padded
    lengths: torch.Tensor  # (B,) number of valid tokens (excluding EOT)
    sum_logprob: torch.Tensor  # (B,)
    no_speech_prob: torch.Tensor  # (B,) P(no_speech) at the SOT position


_U64 = (1 << 64) - 1


def _i64(x: int) -> int:
    """The int64 whose bits are the low 64 bits of x."""
    x &= _U64
    return x - (1 << 64) if x >> 63 else x


_GOLDEN = _i64(0x9E3779B97F4A7C15)
_MIX1 = _i64(0xBF58476D1CE4E5B9)
_MIX2 = _i64(0x94D049BB133111EB)
_STEP = _i64(0xD1B54A32D192ED03)


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's >> is arithmetic)."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finaliser on int64 tensors (products wrap mod 2^64)."""
    x = (x ^ _shr(x, 30)) * _MIX1
    x = (x ^ _shr(x, 27)) * _MIX2
    return x ^ _shr(x, 31)


def sampling_row_keys(seed: int, rows: torch.Tensor) -> torch.Tensor:
    """(B,) int64 keys of the sampling streams of batch rows ``rows``
    (their indices in the whole batch) under ``seed``."""
    seed_key = _mix64(torch.tensor(_i64(int(seed) + _GOLDEN), device=rows.device))
    return _mix64(seed_key + rows.long() * _GOLDEN)


def sample_tokens(masked: torch.Tensor, temperature: float, row_keys: torch.Tensor,
                  step: int) -> torch.Tensor:
    """One categorical draw a row from softmax(masked / temperature), by
    Gumbel-max: argmax(masked / T - log(-log u)), u uniform in (0, 1) from
    a 64-bit hash of (seed, row, step, vocab id).  A row's draws depend on
    its key and nothing else: not the batch shape, not the data ranks."""
    v = masked.shape[-1]
    vocab = torch.arange(v, device=masked.device) * _GOLDEN
    h = _mix64((row_keys ^ _i64((step + 1) * _STEP))[:, None] + vocab[None, :])
    u = (_shr(h, 11).double() + 0.5) * 2.0**-53  # 53 bits, never 0 or 1
    return (masked.double() / temperature - torch.log(-torch.log(u))).argmax(dim=-1)


# ---------------------------------------------------------------------------
# The decode session: fixed buffers, replayed as CUDA graphs where kept
# ---------------------------------------------------------------------------

READBACK_EVERY = 16  # decode steps between reads of the finished flags
MAX_SESSIONS = 4  # captured sessions (buffers and graphs) kept between decodes
_sessions: OrderedDict = OrderedDict()  # (shape key, copy) -> _DecodeSession, LRU order
_sessions_lock = threading.Lock()


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


class _DecodeSession:
    """Greedy and sampling decodes of one shape, their state in fixed
    buffers: the caches, the float32 unembedding, the suppress mask, the
    prompts' pads, the rows' sampling keys, the tokens, the rule state
    (last, penultimate, highest timestamp), finished flags, summed
    logprobs, and the step's cache slot and token column as device
    tensors.  Every step has fixed shapes; steps run eagerly unless
    ``_capture`` has run (``_acquire_session`` calls it for the greedy
    sessions it keeps on the card): then the step from step 2 on (where the
    logit rules no longer branch on the step) replays CUDA graphs cut at
    each hand-written cross-attention kernel's launch, and the kernels run
    between the graphs through their wrappers (``_cross_kernel``), into a
    fixed output buffer.  A captured session and an eager one give the same
    tokens."""

    def __init__(self, params, cfg, b, ta, p_len, max_new, dtype, quantize_cross_kv,
                 kernel_layout, bits, quantize_self_kv, use_timestamps, suppress, prompted,
                 mesh, device):
        self.leaves = _leaves(params["decoder"])  # held: the graphs read them in place
        self.params, self.cfg, self.mesh = {"decoder": params["decoder"]}, cfg, mesh
        self.st = SpecialTokens.for_config(cfg)
        self.p_len, self.max_new, self.dtype = p_len, max_new, dtype
        self.kernel_layout, self.use_timestamps = kernel_layout, use_timestamps
        self.cache_kw = dict(quantize_cross_kv=quantize_cross_kv, kernel_layout=kernel_layout,
                             kv_bits=bits, mesh=mesh, quantize_self_kv=quantize_self_kv)
        self.cache = _new_cache(cfg, b, ta, p_len + max_new, dtype, quantize_cross_kv,
                                kernel_layout, bits, mesh, quantize_self_kv, device)
        token_emb = params["decoder"]["token_emb"]
        self.unembed = torch.empty(token_emb.shape, dtype=torch.float32, device=device)
        self.suppress = (torch.zeros(cfg.n_vocab, dtype=torch.bool, device=device)
                         if suppress else None)
        self.pad = torch.zeros(b, dtype=torch.long, device=device) if prompted else None
        self.row_keys = torch.zeros(b, dtype=torch.long, device=device)
        self.tokens = torch.empty((b, max_new), dtype=torch.long, device=device)
        self.last, self.penult, self.max_ts = (
            torch.zeros(b, dtype=torch.long, device=device) for _ in range(3))
        self.finished = torch.zeros(b, dtype=torch.bool, device=device)
        self.sum_lp = torch.zeros(b, dtype=torch.float32, device=device)
        self.pos = torch.zeros(1, dtype=torch.long, device=device)  # the slot `last` goes to
        self.col = torch.zeros(1, dtype=torch.long, device=device)  # the column a step writes
        self.space_blank_id = self.max_initial_ts_index = None
        self.temperature = 0.0
        h, dh = local_heads(cfg.n_text_head, mesh), cfg.n_text_state // cfg.n_text_head
        self.out = torch.zeros((b, 1, h, dh), dtype=torch.float32, device=device)
        self.graphs: list = []
        self.requests: list = []  # (layer, q) of each kernel launch between the graphs
        self.busy = False

    def _launch(self, l, q):
        return _cross_kernel(self.cache, self.cfg, self.mesh, l, q, out=self.out)

    def _pick(self, logits, step: int) -> None:
        """The rules at ``step``, the draw (the argmax at temperature 0),
        and the bookkeeping, in place."""
        st = self.st
        masked = apply_logit_rules(
            logits, st, step=step, last_token=self.last, penultimate_token=self.penult,
            max_ts_token=self.max_ts, suppress_mask=self.suppress,
            use_timestamps=self.use_timestamps,
            max_initial_timestamp_index=self.max_initial_ts_index,
            space_blank_id=self.space_blank_id,
        )
        if self.temperature > 0:
            next_tok = sample_tokens(masked, self.temperature, self.row_keys, step)
        else:
            next_tok = masked.argmax(dim=-1)
        logprob = torch.log_softmax(masked, dim=-1).gather(1, next_tok[:, None])[:, 0]
        finished = self.finished
        next_tok = torch.where(finished, st.eot, next_tok)
        self.sum_lp.add_(torch.where(finished, 0.0, logprob))
        self.max_ts.copy_(torch.where((next_tok >= st.timestamp_begin) & ~finished,
                                      torch.maximum(self.max_ts, next_tok), self.max_ts))
        finished |= next_tok == st.eot
        self.tokens.index_copy_(1, self.col, next_tok[:, None])
        self.penult.copy_(self.last)
        self.last.copy_(next_tok)
        self.pos.add_(1)
        self.col.add_(1)

    def _step(self, step: int):
        """Step ``step`` >= 1 as a ``_decoder_layers`` generator: the
        decoder over ``last`` at slot ``pos``, then ``_pick``."""
        logits = yield from _decoder_layers(
            self.params, self.cfg, self.last[:, None], self.cache, self.pos,
            pos_offset=self.pad, min_valid=self.pad, compute_dtype=self.dtype,
            kernel_layout=self.kernel_layout, logit_positions=None, unembed=self.unembed,
            mesh=self.mesh,
        )
        self._pick(logits[:, -1], step)

    def _capture(self) -> None:
        """Capture step 2's greedy pieces, one graph each, in one memory
        pool: a warm-up step on a side stream first (kernels not launched),
        then the captures on it.  The buffers it writes are all set again
        by ``decode`` before they are read."""
        dev = self.out.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            _drive(self._step(2), lambda l, q: self.out)
            pool = torch.cuda.graph_pool_handle()
            pieces = self._step(2)
            answer = None
            while True:
                g = torch.cuda.CUDAGraph()
                g.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    req = pieces.send(answer)
                except StopIteration:
                    req = None
                finally:
                    g.capture_end()
                self.graphs.append(g)
                if req is None:
                    break
                self.requests.append(req)  # keeps q, read by the launch, alive
                answer = self.out
        torch.cuda.current_stream(dev).wait_stream(side)

    def _replay(self) -> None:
        for g, req in zip(self.graphs, self.requests):
            g.replay()
            self._launch(*req)
        self.graphs[-1].replay()

    def decode(self, params, audio_states, prompt, pad_len, *, sot_len, last_init,
               penult_init, suppress_mask, space_blank_id, max_initial_ts_index,
               temperature=0.0, rng_seed=0) -> DecodeResult:
        """Cache, prefill (the no-speech read at the fixed sot slot) and the
        loop, in the session's buffers; the finished flags are read every
        ``READBACK_EVERY`` steps and at the last (steps after every row has
        finished write EOT and add 0).  temperature > 0 samples each row
        from its stream (``sampling_row_keys`` over the rows' indices in
        the whole batch, across the data ranks)."""
        st, cfg = self.st, self.cfg
        self.space_blank_id, self.max_initial_ts_index = space_blank_id, max_initial_ts_index
        self.temperature = temperature
        with trace.span("decode.prefill"):
            init_cache(params, cfg, audio_states, self.p_len + self.max_new, dtype=self.dtype,
                       into=self.cache, **self.cache_kw)
            self.unembed.copy_(params["decoder"]["token_emb"])
            if self.suppress is not None:
                self.suppress.copy_(suppress_mask)
            if self.pad is not None:
                self.pad.copy_(pad_len)
            if temperature > 0:
                b = self.row_keys.shape[0]
                row0 = 0 if self.mesh is None else self.mesh.data_rank * b
                self.row_keys.copy_(sampling_row_keys(
                    rng_seed, torch.arange(row0, row0 + b, device=self.row_keys.device)))
            logits, _ = decoder_forward_cached(
                params, cfg, prompt, self.cache, 0, logit_positions=(self.p_len - sot_len, -1),
                pos_offset=self.pad, min_valid=self.pad, compute_dtype=self.dtype,
                kernel_layout=self.kernel_layout, unembed=self.unembed, mesh=self.mesh,
            )
        no_speech_prob = _no_speech_prob(st, cfg, logits[:, 0])
        self.tokens.fill_(st.eot)
        self.last.copy_(last_init)
        self.penult.copy_(penult_init)
        self.max_ts.fill_(st.timestamp_begin - 1)
        self.finished.zero_()
        self.sum_lp.zero_()
        self.pos.fill_(self.p_len - 1)  # `last` sits in the prompt's last slot
        self.col.zero_()
        for step in range(self.max_new):
            with trace.span("decode.step"):
                trace.count("decode.steps")
                if step == 0:
                    self._pick(logits[:, 1], 0)
                elif step >= 2 and self.graphs:
                    self._replay()
                    trace.count("decode.graph_steps")
                else:
                    _drive(self._step(step), self._launch)
                if (step + 1) % READBACK_EVERY == 0 or step + 1 == self.max_new:
                    with trace.span("decode.wait"):
                        if bool(self.finished.all()):
                            break
        tokens = self.tokens.clone()
        return DecodeResult(tokens, (tokens != st.eot).sum(dim=-1), self.sum_lp.clone(),
                            no_speech_prob)


def _graphs_serve(leaves, audio_states, temperature: float, mesh) -> bool:
    """Whether a decode's session is kept and captured: greedy (a sampled
    step's draw depends on the host's step), on the card, with no model
    split (kernel #5 and the row-parallel all-reduce stay eager) and
    nothing requiring grad (``leaves``: the decoder's parameters).  Every
    other decode runs a session of its own eagerly."""
    return (audio_states.is_cuda and temperature == 0 and (mesh is None or mesh.tp == 1)
            and not audio_states.requires_grad and not any(t.requires_grad for t in leaves))


def _acquire_session(key: tuple, make) -> _DecodeSession:
    """A free kept session of ``key`` (one decode holds a session at a
    time); when none is free, one made with ``make()`` and captured, the
    least recently used free sessions going past ``MAX_SESSIONS``.  When
    every kept session is busy, ``make()`` uncaptured and not kept: that
    decode runs its session eagerly, to the same tokens."""
    with _sessions_lock:
        i = 0
        while (key, i) in _sessions:
            sess = _sessions[(key, i)]
            if not sess.busy:
                _sessions.move_to_end((key, i))
                sess.busy = True
                return sess
            i += 1
        while len(_sessions) >= MAX_SESSIONS:
            free = next((k for k, s in _sessions.items() if not s.busy), None)
            if free is None:
                return make()
            del _sessions[free]
        sess = make()
        sess._capture()
        _sessions[(key, i)] = sess
        sess.busy = True
        return sess


def _release_session(sess: _DecodeSession) -> None:
    with _sessions_lock:
        sess.busy = False


def _rank_groups(tokens, lengths, sum_logprob, no_speech_prob, b, g):
    """Best of g sampling candidates per element by average logprob
    (openai's MaximumLikelihoodRanker over a best_of group)."""
    tokens = tokens.reshape(b, g, -1)
    lengths = lengths.reshape(b, g)
    sum_logprob = sum_logprob.reshape(b, g)
    avg = sum_logprob / torch.clamp(lengths, min=1).float()
    best = avg.argmax(dim=-1)  # (B,)
    rows = torch.arange(b, device=tokens.device)
    return DecodeResult(
        tokens=tokens[rows, best],
        lengths=lengths[rows, best],
        sum_logprob=sum_logprob[rows, best],
        no_speech_prob=no_speech_prob.reshape(b, g)[:, 0],
    )


def _kernel_layout(quantize_cross_kv: bool, use_pallas_kernel: bool, kv_bits: int) -> bool:
    """The JAX package's rule: an int4 cache is always in the kernel layout;
    an int8 one only when the kernel is asked for, else it is the plain int8
    cache read through plain attention (init_cache then ignores kv_bits)."""
    return quantize_cross_kv and (use_pallas_kernel or kv_bits == 4)


def _no_speech_prob(st: SpecialTokens, cfg: WhisperConfig, sot_logits: torch.Tensor):
    """P(<|nospeech|>) from the logits at the <|sot|> slot (B, V)."""
    if st.no_speech < cfg.n_vocab:
        return torch.softmax(sot_logits.float(), dim=-1)[:, st.no_speech]
    return torch.zeros(sot_logits.shape[0], device=sot_logits.device)


def _decode_rows(
    params: Params,
    cfg: WhisperConfig,
    audio_states: torch.Tensor,  # (B, Ta, d)
    prompt: torch.Tensor,  # (B, P) long, every row ending in the sot sequence
    pad_len: torch.Tensor | None,  # (B,) left padding of each row, or None
    *,
    sot_len: int,
    last_init: torch.Tensor,
    penult_init: torch.Tensor,
    max_new_tokens: int,
    use_timestamps: bool,
    suppress_mask,
    space_blank_id,
    dtype_name: str,
    quantize_cross_kv: bool,
    use_pallas_kernel: bool,
    kv_bits: int,
    temperature: float,
    rng_seed: int,
    best_of: int,
    max_initial_ts_index: int | None,
    mesh=None,
    quantize_self_kv: bool = False,
) -> DecodeResult:
    """The greedy/sampling decode of greedy_decode and
    prompted_greedy_decode: best_of expansion, the decode in a session
    (kept and captured where ``_graphs_serve``, else made for this decode
    and run eagerly) and the ranking."""
    dtype = getattr(torch, dtype_name)
    b0 = audio_states.shape[0]
    group = best_of if (best_of > 1 and temperature > 0) else 1
    if group > 1:
        audio_states = audio_states.repeat_interleave(group, dim=0)
        prompt = prompt.repeat_interleave(group, dim=0)
        last_init = last_init.repeat_interleave(group, dim=0)
        penult_init = penult_init.repeat_interleave(group, dim=0)
        if pad_len is not None:
            pad_len = pad_len.repeat_interleave(group, dim=0)
    b, p_len = prompt.shape
    kernel_layout = _kernel_layout(quantize_cross_kv, use_pallas_kernel, kv_bits)
    leaves = _leaves(params["decoder"])
    ta, bits = audio_states.shape[1], (kv_bits if kernel_layout else 8)
    shape = (b, ta, p_len, max_new_tokens, dtype, quantize_cross_kv, kernel_layout, bits,
             quantize_self_kv, use_timestamps, suppress_mask is not None, pad_len is not None)

    def make():
        return _DecodeSession(params, cfg, *shape, mesh=mesh, device=audio_states.device)

    if _graphs_serve(leaves, audio_states, temperature, mesh):
        sess = _acquire_session((tuple(map(id, leaves)), audio_states.device) + shape, make)
    else:
        sess = make()
    try:
        res = sess.decode(
            params, audio_states, prompt, pad_len, sot_len=sot_len, last_init=last_init,
            penult_init=penult_init, suppress_mask=suppress_mask, space_blank_id=space_blank_id,
            max_initial_ts_index=max_initial_ts_index, temperature=temperature,
            rng_seed=rng_seed,
        )
    finally:
        _release_session(sess)
    if group > 1:
        return _rank_groups(*res, b0, group)
    return res


def greedy_decode(
    params: Params,
    cfg: WhisperConfig,
    audio_states: torch.Tensor,  # (B, Ta, d) encoder output
    *,
    sot_sequence: tuple[int, ...],
    max_new_tokens: int = 224,
    use_timestamps: bool = True,
    suppress_mask: torch.Tensor | None = None,
    space_blank_id: int | None = None,
    dtype_name: str = "float32",
    quantize_cross_kv: bool = False,
    use_pallas_kernel: bool = False,
    kv_bits: int = 8,
    temperature: float = 0.0,
    rng_seed: int = 0,
    best_of: int = 1,
    max_initial_ts_index: int | None = 50,
    mesh=None,
    quantize_self_kv: bool = False,
) -> DecodeResult:
    """Batched greedy/sampling decode with Whisper's rules.

    temperature == 0 -> argmax; > 0 -> categorical sampling.  best_of > 1
    at temperature > 0 samples that many candidates per element (rows ride
    the batch axis) and returns the best by average logprob.
    quantize_cross_kv with kv_bits=4 builds the int4 kernel-layout cache,
    read through kernel B on the card; with kv_bits=8 the int8 cache, in
    the kernel layout read through the int8 kernel when use_pallas_kernel
    (the JAX package's name for it), else read through plain attention.
    quantize_self_kv: the self-attention cache is int8 with per-token
    scales (the cross cache and its kernels are unchanged).
    mesh: decode this rank's rows on its shard (module docstring).
    """
    b, dev = audio_states.shape[0], audio_states.device
    prompt = torch.tensor(sot_sequence, dtype=torch.long, device=dev)[None].repeat(b, 1)
    return _decode_rows(
        params, cfg, audio_states, prompt, None,
        sot_len=len(sot_sequence),
        last_init=torch.full((b,), sot_sequence[-1], device=dev),
        penult_init=torch.full((b,), sot_sequence[0], device=dev),
        max_new_tokens=max_new_tokens, use_timestamps=use_timestamps,
        suppress_mask=suppress_mask, space_blank_id=space_blank_id,
        dtype_name=dtype_name, quantize_cross_kv=quantize_cross_kv,
        use_pallas_kernel=use_pallas_kernel, kv_bits=kv_bits,
        temperature=temperature, rng_seed=rng_seed, best_of=best_of,
        max_initial_ts_index=max_initial_ts_index, mesh=mesh,
        quantize_self_kv=quantize_self_kv,
    )


# ---------------------------------------------------------------------------
# Prompted greedy decode (condition_on_previous_text, initial_prompt)
# ---------------------------------------------------------------------------

def prompted_greedy_decode(
    params: Params,
    cfg: WhisperConfig,
    audio_states: torch.Tensor,  # (B, Ta, d)
    prompt_tokens,  # (B, P) LEFT-padded rows whose suffix is the sot sequence
    prompt_lens,  # (B,) real tokens per row (right-aligned)
    *,
    sot_len: int,  # length of the trailing sot sequence (the same for all rows)
    max_new_tokens: int = 224,
    use_timestamps: bool = True,
    suppress_mask: torch.Tensor | None = None,
    space_blank_id: int | None = None,
    dtype_name: str = "float32",
    quantize_cross_kv: bool = False,
    use_pallas_kernel: bool = False,
    kv_bits: int = 8,
    temperature: float = 0.0,
    rng_seed: int = 0,
    best_of: int = 1,
    max_initial_ts_index: int | None = 50,
    mesh=None,
    quantize_self_kv: bool = False,
) -> DecodeResult:
    """Greedy/sampling decode with PER-ROW prompts: openai-whisper's
    <|startofprev|> + previous text + sot sequence, batched.  Rows are
    left-padded to a common length; the padding is invisible (min_valid)
    and each row's positions count from its first real token, exactly as
    if it were decoded alone.  Options as in greedy_decode.
    (build_prompt_rows makes the rows.)"""
    dev = audio_states.device
    prompt = torch.as_tensor(np.asarray(prompt_tokens), device=dev).long()
    lens = torch.as_tensor(np.asarray(prompt_lens), device=dev).long()
    p_len = prompt.shape[1]
    return _decode_rows(
        params, cfg, audio_states, prompt, p_len - lens,
        sot_len=sot_len,
        last_init=prompt[:, -1],
        penult_init=prompt[:, -2] if p_len >= 2 else prompt[:, -1],
        max_new_tokens=max_new_tokens, use_timestamps=use_timestamps,
        suppress_mask=suppress_mask, space_blank_id=space_blank_id,
        dtype_name=dtype_name, quantize_cross_kv=quantize_cross_kv,
        use_pallas_kernel=use_pallas_kernel, kv_bits=kv_bits,
        temperature=temperature, rng_seed=rng_seed, best_of=best_of,
        max_initial_ts_index=max_initial_ts_index, mesh=mesh,
        quantize_self_kv=quantize_self_kv,
    )


def build_prompt_rows(
    histories: list[list[int]],  # per-row previous-window TEXT tokens
    sot_sequence: tuple[int, ...],
    st: SpecialTokens,
    ctx_tokens: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Left-padded prompt rows for prompted decode: [eot pad ...]
    [<|startofprev|>][last <= ctx_tokens history tokens][sot sequence].
    An empty history gives just the sot sequence, which decodes exactly as
    plain greedy_decode does."""
    sot = list(sot_sequence)
    p_len = 1 + ctx_tokens + len(sot)
    rows = np.full((len(histories), p_len), st.eot, np.int32)
    lens = np.zeros(len(histories), np.int32)
    for i, hist in enumerate(histories):
        text = [t for t in hist if t < st.eot]
        ctx = text[-ctx_tokens:] if ctx_tokens else []  # [-0:] is the whole list
        real = ([st.startofprev] + ctx if ctx else []) + sot
        rows[i, p_len - len(real):] = real
        lens[i] = len(real)
    return rows, lens


# ---------------------------------------------------------------------------
# Beam search
# ---------------------------------------------------------------------------

def _top_k_lower_index(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top k of each row of x (B, N), largest first, equal values in index
    order: ``jax.lax.top_k``'s order.  torch.topk finds the k-th value;
    among the entries equal to it the lowest indices are kept."""
    kth = torch.topk(x, k, dim=-1).values[:, -1:]
    above = x > kth
    equal = x == kth
    need = k - above.sum(dim=-1, keepdim=True)
    take = above | (equal & (torch.cumsum(equal, dim=-1) <= need))
    idx = take.nonzero()[:, 1].reshape(x.shape[0], k)  # ascending per row
    vals = x.gather(1, idx)
    order = torch.sort(vals, dim=-1, descending=True, stable=True).indices
    return vals.gather(1, order), idx.gather(1, order)


def beam_decode(
    params: Params,
    cfg: WhisperConfig,
    audio_states: torch.Tensor,  # (B, Ta, d)
    *,
    sot_sequence: tuple[int, ...],
    beam_size: int = 5,
    max_new_tokens: int = 224,
    use_timestamps: bool = True,
    suppress_mask: torch.Tensor | None = None,
    length_penalty: float | None = None,
    patience: float = 1.0,
    dtype_name: str = "float32",
    quantize_cross_kv: bool = False,
    use_pallas_kernel: bool = False,
    kv_bits: int = 8,
    prompt_tokens=None,  # (B, P) LEFT-padded rows (build_prompt_rows)
    prompt_lens=None,  # (B,) real tokens per row
    max_initial_ts_index: int | None = 50,
    space_blank_id: int | None = None,
    mesh=None,
    quantize_self_kv: bool = False,
) -> DecodeResult:
    """Batched beam search with openai-whisper's BeamSearchDecoder
    semantics.

    Beams ride the batch axis: the cache holds B*K rows.  Each step takes
    the top 2K of the K*V candidate scores per element; candidates ending
    in EOT that rank above the K-th non-EOT one join the element's
    FINISHED set (first come, never evicted, round(K * patience) of them);
    the best K non-EOT candidates become the live beams, and the written
    positions of the self cache are reordered to them.  The loop ends once
    every element holds its finished hypotheses (openai's is_done);
    elements still short at the token cap are topped up from the live beams
    by raw score (openai's finalize).  The winner is ranked by sum_logprob /
    length (length_penalty=None, openai's default) or by the Google-NMT
    ((5 + len) / 6) ** length_penalty.  The cross cache is built from the
    audio states repeated K times, as in JAX: each element's cross K/V is
    projected, stored and read once per beam (K times the bytes), and it is
    never reordered, since beams do not move between elements.

    prompt_tokens/prompt_lens replace the uniform sot prefill with per-row
    <|startofprev|> prompts, padding invisible as in prompted_greedy_decode;
    the pad lengths are per element, so the beam reorder (which permutes
    beams within an element) leaves them unchanged.  no_speech_prob is
    read from beam 0's prefill (the beams are identical there).  mesh:
    decode this rank's rows on its shard (module docstring).
    """
    st = SpecialTokens.for_config(cfg)
    dtype = getattr(torch, dtype_name)
    b, dev = audio_states.shape[0], audio_states.device
    k = beam_size
    m_fin = max(1, int(round(k * patience)))  # openai's max_candidates
    cap = max(k, m_fin)  # finished-set width (finalize may top up to K)
    prompted = prompt_tokens is not None
    if prompted:
        prompt_tokens = torch.as_tensor(np.asarray(prompt_tokens), device=dev).long()
        prompt_lens = torch.as_tensor(np.asarray(prompt_lens), device=dev).long()
    prompt_len = prompt_tokens.shape[1] if prompted else len(sot_sequence)
    kernel_layout = _kernel_layout(quantize_cross_kv, use_pallas_kernel, kv_bits)
    unembed = params["decoder"]["token_emb"].float()
    row_kw = dict(compute_dtype=dtype, kernel_layout=kernel_layout, unembed=unembed, mesh=mesh)
    if prompted:
        prompt = prompt_tokens.repeat_interleave(k, dim=0)
        pad_len = (prompt_len - prompt_lens).repeat_interleave(k, dim=0)  # (B*K,)
        row_kw.update(pos_offset=pad_len, min_valid=pad_len)
        last = prompt_tokens[:, -1, None].expand(b, k)
        penult = prompt_tokens[:, -2 if prompt_len >= 2 else -1, None].expand(b, k)
    else:
        prompt = torch.tensor(sot_sequence, dtype=torch.long, device=dev)[None].repeat(b * k, 1)
        last = torch.full((b, k), sot_sequence[-1], dtype=torch.long, device=dev)
        penult = torch.full((b, k), sot_sequence[0], dtype=torch.long, device=dev)
    sot_slot = prompt_len - len(sot_sequence)
    with trace.span("decode.prefill"):
        cache = init_cache(
            params, cfg, audio_states.repeat_interleave(k, dim=0), prompt_len + max_new_tokens,
            dtype=dtype, quantize_cross_kv=quantize_cross_kv, kernel_layout=kernel_layout,
            kv_bits=kv_bits, mesh=mesh, quantize_self_kv=quantize_self_kv,
        )
        logits, cache = decoder_forward_cached(
            params, cfg, prompt, cache, 0, logit_positions=(sot_slot, -1), **row_kw,
        )
    no_speech_prob = _no_speech_prob(st, cfg, logits[:, 0]).reshape(b, k)[:, 0]
    logits = logits[:, 1]  # (B*K, V)

    tb, eot, v = st.timestamp_begin, st.eot, logits.shape[-1]
    tokens = torch.full((b, k, max_new_tokens), eot, dtype=torch.long, device=dev)
    # only beam 0 is live at first (the prompts are identical; openai gets
    # the same from its candidate dict collapsing equal sequences)
    scores = torch.full((b, k), NEG_INF, device=dev)
    scores[:, 0] = 0.0
    max_ts = torch.full((b, k), tb - 1, dtype=torch.long, device=dev)
    # the finished set carries one spare slot, ``cap``: candidates that do
    # not qualify are written there and the slot is dropped at the end (the
    # JAX version's scatter with mode="drop")
    fin_tokens = torch.full((b, cap + 1, max_new_tokens), eot, dtype=torch.long, device=dev)
    fin_scores = torch.full((b, cap + 1), NEG_INF, device=dev)
    fin_lengths = torch.zeros((b, cap + 1), dtype=torch.long, device=dev)
    fin_count = torch.zeros(b, dtype=torch.long, device=dev)
    rows_b = torch.arange(b, device=dev)
    pos2k = torch.arange(2 * k, device=dev)[None, :]

    def rows_of(x, idx):  # x (B, K', ...) gathered along the beam axis
        return x.gather(1, idx.reshape(*idx.shape, *([1] * (x.dim() - 2))).expand(
            -1, -1, *x.shape[2:]))

    n_steps = 0
    for step in range(max_new_tokens):
        with trace.span("decode.step"):
            trace.count("decode.steps")
            masked = apply_logit_rules(
                logits, st, step=step, last_token=last.reshape(-1),
                penultimate_token=penult.reshape(-1), max_ts_token=max_ts.reshape(-1),
                suppress_mask=suppress_mask, use_timestamps=use_timestamps,
                max_initial_timestamp_index=max_initial_ts_index,
                space_blank_id=space_blank_id,
            )
            cand = scores[:, :, None] + torch.log_softmax(masked, dim=-1).reshape(b, k, v)
            # top 2K: at most one EOT candidate per live beam, so this holds at
            # least K non-EOT continuations and every EOT candidate that could
            # outrank the K-th of them
            top2, idx2 = _top_k_lower_index(cand.reshape(b, k * v), 2 * k)
            tok2, src2 = idx2 % v, idx2 // v
            is_eot2 = tok2 == eot

            # live beams: the first K non-EOT candidates in score order
            order = torch.argsort(torch.where(is_eot2, 2 * k + pos2k, pos2k), dim=-1)[:, :k]
            next_tok = tok2.gather(1, order)
            src_beam = src2.gather(1, order)
            new_scores = top2.gather(1, order)

            # finished set: EOT candidates ranked above the K-th non-EOT one
            # take the next free slots; the source beam's buffer still holds EOT
            # at ``step``, which is the terminator
            not_eot = (~is_eot2).long()
            qual = is_eot2 & (torch.cumsum(not_eot, dim=-1) - not_eot < k)
            qual_l = qual.long()
            slot = fin_count[:, None] + torch.cumsum(qual_l, dim=-1) - qual_l
            take_it = qual & (slot < m_fin)
            slot = torch.where(take_it, slot, cap)
            fin_tokens.scatter_(1, slot[:, :, None].expand(-1, -1, max_new_tokens),
                                rows_of(tokens, src2))
            fin_scores.scatter_(1, slot, top2)
            fin_lengths.scatter_(1, slot, torch.full_like(slot, step))
            fin_count = torch.clamp(fin_count + take_it.sum(dim=-1), max=m_fin)

            tokens = rows_of(tokens, src_beam)
            tokens[:, :, step] = next_tok
            penult = last.gather(1, src_beam)
            max_ts = max_ts.gather(1, src_beam)
            max_ts = torch.where(next_tok >= tb, torch.maximum(max_ts, next_tok), max_ts)
            last = next_tok
            scores = new_scores
            n_steps = step + 1
            if n_steps == max_new_tokens:
                break
            with trace.span("decode.wait"):
                done = bool((fin_count >= m_fin).all())
            if done:
                break
            # reorder the self cache to the new beams: only the positions
            # written so far, in place (flat row = element * K + source beam)
            row_idx = (rows_b[:, None] * k + src_beam).reshape(-1)
            written = prompt_len + step
            for c in (cache.self_k, cache.self_v, cache.self_k_scale, cache.self_v_scale):
                if c is not None:
                    c[:, :, :, :written] = c[:, row_idx, :, :written]
            logits, cache = decoder_forward_cached(
                params, cfg, next_tok.reshape(b * k, 1), cache, prompt_len + step, **row_kw,
            )
            logits = logits[:, -1]

    # openai's finalize: elements short of K finished hypotheses are topped
    # up from the live beams by raw score, with no EOT logprob added
    live_order = torch.argsort(-scores, dim=-1, stable=True)
    fill = fin_count[:, None] + torch.arange(k, device=dev)[None, :]
    fill = torch.where(fill < k, fill, cap)
    fin_tokens.scatter_(1, fill[:, :, None].expand(-1, -1, max_new_tokens),
                        rows_of(tokens, live_order))
    fin_scores.scatter_(1, fill, scores.gather(1, live_order))
    fin_lengths.scatter_(1, fill, torch.full_like(fill, n_steps))
    fin_tokens, fin_scores, fin_lengths = (
        fin_tokens[:, :cap], fin_scores[:, :cap], fin_lengths[:, :cap]
    )

    # openai's MaximumLikelihoodRanker
    lengths_f = torch.clamp(fin_lengths, min=1).float()
    norm = lengths_f if length_penalty is None else ((5.0 + lengths_f) / 6.0) ** length_penalty
    best = (fin_scores / norm).argmax(dim=-1)
    return DecodeResult(
        tokens=fin_tokens[rows_b, best],
        lengths=fin_lengths[rows_b, best],
        sum_logprob=fin_scores[rows_b, best],
        no_speech_prob=no_speech_prob,
    )


# ---------------------------------------------------------------------------
# Language detection (openai-whisper's detect_language equivalent)
# ---------------------------------------------------------------------------

# Rows a language detection runs at once: each holds a float32 cross cache of
# every decoder layer (295 MB a row at medium's widths, 491 at large-v3's).
DETECT_ROWS = 8


def detect_language(
    params: Params, cfg: WhisperConfig, audio_states: torch.Tensor, mesh=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One decoder step on <|sot|> over an UNQUANTIZED float32 cache,
    ``DETECT_ROWS`` rows at a time; returns (lang_index (B,), probs
    (B, n_lang)), the index relative to SpecialTokens.lang_begin."""
    st = SpecialTokens.for_config(cfg)
    parts = []
    for states in audio_states.split(DETECT_ROWS):
        cache = init_cache(params, cfg, states, max_len=1, mesh=mesh)
        sot = torch.full((states.shape[0], 1), st.sot, dtype=torch.long, device=states.device)
        logits, _ = decoder_forward_cached(params, cfg, sot, cache, 0, mesh=mesh)
        parts.append(logits[:, 0, st.lang_begin : st.lang_begin + st.num_languages])
    probs = torch.softmax(torch.cat(parts), dim=-1)
    return probs.argmax(dim=-1), probs


# ---------------------------------------------------------------------------
# Seek semantics (openai-whisper's transcribe-loop window advance; numpy)
# ---------------------------------------------------------------------------

def seek_consumed(
    row: np.ndarray, st: SpecialTokens, chunk_length_s: float = 30.0
) -> tuple[float, bool]:
    """How much of a 30 s window this decode actually CONSUMED:
    (chunk_length_s, False) for a clean ending, or (last closed end
    timestamp, True) when unclosed text trails the last closed segment
    (openai rewinds seek there and re-decodes the straddler)."""
    toks = [int(t) for t in row if int(t) != st.eot]
    if not toks:
        return chunk_length_s, False
    if toks[-1] >= st.timestamp_begin:
        if len(toks) >= 2 and toks[-2] >= st.timestamp_begin:
            # consecutive-timestamp ending: openai rewinds to the FIRST
            # timestamp of the pair
            consumed = (toks[-2] - st.timestamp_begin) * 0.02
            if consumed <= 0.0 or consumed >= chunk_length_s:
                return chunk_length_s, False
            return consumed, True
        return chunk_length_s, False  # single-timestamp ending: clean
    last_closed_end = None
    cur_start = None
    trailing_text = False
    for t in toks:
        if t >= st.timestamp_begin:
            if cur_start is None:
                cur_start = t
            else:
                last_closed_end = t
                cur_start = None
            trailing_text = False
        elif t < st.eot:
            trailing_text = True
    if last_closed_end is None or not trailing_text:
        return chunk_length_s, False
    consumed = (last_closed_end - st.timestamp_begin) * 0.02
    if consumed <= 0.0:
        return chunk_length_s, False  # degenerate: never rewind to 0
    return consumed, True


def truncate_row_after_seek(row: np.ndarray, st: SpecialTokens) -> np.ndarray:
    """Copy of ``row`` with every token after the last CLOSED timestamp
    pair replaced by EOT."""
    out = np.asarray(row).copy()
    last_close_idx = None
    cur_start = None
    for i, t in enumerate(int(x) for x in out):
        if t == st.eot:
            break
        if t >= st.timestamp_begin:
            if cur_start is None:
                cur_start = i
            else:
                last_close_idx = i
                cur_start = None
    if last_close_idx is not None:
        out[last_close_idx + 1:] = st.eot
    return out


def keep_closed_segments_before(
    row: np.ndarray, st: SpecialTokens, cut_s: float
) -> tuple[np.ndarray, float | None]:
    """Keep only the CLOSED segments that start (window-local) before
    ``cut_s``; returns (new_row, last kept end in seconds or None)."""
    out = np.asarray(row).copy()
    cur_start = None
    last_keep_idx = None
    last_end_s = None
    for i, t in enumerate(int(x) for x in out):
        if t == st.eot:
            break
        if t >= st.timestamp_begin:
            if cur_start is None:
                cur_start = (t - st.timestamp_begin) * 0.02
            else:
                if cur_start < cut_s:
                    last_keep_idx = i
                    last_end_s = (t - st.timestamp_begin) * 0.02
                cur_start = None
    if last_keep_idx is None:
        return np.full_like(out, st.eot), None
    out[last_keep_idx + 1:] = st.eot
    return out, last_end_s


def drop_segments_before(
    row: np.ndarray, st: SpecialTokens, cut_s: float
) -> np.ndarray:
    """Drop a row's leading segments that START (window-local) before
    ``cut_s``; keep everything from the first segment at/after the cut."""
    out = np.asarray(row).copy()
    toks = [int(t) for t in out]
    cur_start_idx = None
    keep_from = None
    for i, t in enumerate(toks):
        if t == st.eot:
            break
        if t >= st.timestamp_begin:
            if cur_start_idx is None:
                cur_start_idx = i
                if (t - st.timestamp_begin) * 0.02 >= cut_s:
                    keep_from = i
                    break
            else:
                cur_start_idx = None
    if keep_from is None:
        return np.full_like(out, st.eot)
    kept = out[keep_from:]
    res = np.full_like(out, st.eot)
    res[: len(kept)] = kept
    return res


# ---------------------------------------------------------------------------
# Token sequence -> timestamped segments (host-side, numpy)
# ---------------------------------------------------------------------------

def tokens_to_segments(
    token_rows: np.ndarray,  # (B, T) decoded rows (EOT-padded)
    st: SpecialTokens,
    chunk_offsets_s: np.ndarray,  # (B,) start time of each 30 s chunk
    decode_text,  # callable: list[int] -> str
    chunk_length_s: float = 30.0,
    chunk_durations_s: np.ndarray | None = None,  # (B,) actual audio seconds
    row_meta: list[dict] | None = None,  # (B,) per-window decode metadata
) -> list[dict]:
    """Parse timestamp tokens into Whisper-schema segments ("seek",
    "start", "end", "text", "tokens", plus the window's row_meta).  A
    trailing unclosed segment ends at the chunk's actual audio duration."""
    if chunk_durations_s is None:
        chunk_durations_s = np.full(len(token_rows), chunk_length_s)
    if row_meta is None:
        row_meta = [{}] * len(token_rows)
    segments: list[dict] = []
    for row, offset, chunk_dur, meta in zip(
        token_rows, chunk_offsets_s, chunk_durations_s, row_meta
    ):
        toks = [int(t) for t in row if int(t) != st.eot]
        seek = int(round(float(offset) * 100.0))  # openai frame units
        cur_start = None
        cur_text: list[int] = []
        cur_toks: list[int] = []
        last_end = 0.0
        for t in toks:
            if t >= st.timestamp_begin:
                ts = (t - st.timestamp_begin) * 0.02
                if cur_start is None:
                    cur_start = ts
                    cur_toks = [t]
                else:
                    text = decode_text(cur_text).strip()
                    if text:
                        segments.append(
                            {
                                "seek": seek,
                                "start": float(offset + cur_start),
                                "end": float(offset + ts),
                                "text": text,
                                "tokens": cur_toks + [t],
                                **meta,
                            }
                        )
                    last_end = ts
                    cur_start = None
                    cur_text = []
                    cur_toks = []
            elif t < st.eot:
                if cur_start is None:  # no-timestamp decode: one big segment
                    cur_start = last_end
                cur_text.append(t)
                cur_toks.append(t)
        if cur_text:
            text = decode_text(cur_text).strip()
            if text:
                start = cur_start
                # clamp keeps end > start even when the unclosed segment
                # opens exactly at chunk_length_s
                end = min(
                    max(float(chunk_dur), start + 0.02),
                    max(chunk_length_s, start + 0.02),
                )
                segments.append(
                    {
                        "seek": seek,
                        "start": float(offset + start),
                        "end": float(offset + end),
                        "text": text,
                        "tokens": list(cur_toks),
                        **meta,
                    }
                )
    return segments
