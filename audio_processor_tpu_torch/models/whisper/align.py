"""Word-level timestamps from cross-attention alignment and DTW, in PyTorch.

The port of the JAX package's ``models/whisper/align.py`` (openai-whisper's
``word_timestamps=True`` recipe): the decoder runs teacher-forced over the
decoded tokens in float32 and keeps its cross-attention maps, over the
checkpoint's alignment heads when ``cfg.alignment_heads`` is set (each head
apart), else pooled as the mean over every head of the last half of the
layers.  On the host the maps are cropped to the window's real frames,
z-scored over the token axis, median-filtered along time, and a monotonic
token -> frame path comes from DTW (``ops/kernels/dtw.py``: the C++ function
on the card's path, its numpy twin on the CPU's); token spans then split
into words.

The teacher-forced pass runs where the encoder states are (on the card in
serving), with plain matmuls, as the JAX pass runs outside any Pallas
kernel.  Under a (data, model) mesh it runs on the rank's slices of the
decoder (its heads, the row-parallel products summed over the model
group, as ``decode`` runs them) and gathers each weighted layer's
cross-attention over the model group before pooling, so that the pooled
map sums the heads in the one process's order (the DTW is exact on its
values); ``calibrate_alignment_heads`` and ``all_head_attention_maps``
stay single-process.  The JAX pass pads the token width and the batch to powers of two
to spare XLA recompiles; the port runs the real rows at their own width
(the rows past a row's terminator are causal-masked away, and padded batch
rows are independent), so the words are those of the padded pass.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...ops.kernels.dtw import dtw_starts
from ...parallel import mesh as mesh_lib
from .config import WhisperConfig
from .decode import SpecialTokens
from .model import (
    Params,
    causal_mask,
    layer,
    layer_norm,
    linear,
    local_heads,
    merge_heads,
    mlp,
    row_parallel_linear,
    self_attention,
    split_heads,
)

AUDIO_FRAME_S = 0.02  # one encoder position = 20 ms

# openai-whisper's word-merge defaults (whisper/transcribe.py
# prepend_punctuations / append_punctuations): opening quotes and brackets
# attach to the FOLLOWING word, closing marks to the PRECEDING one
PREPEND_PUNCTUATIONS = "\"'“¿([{-"
APPEND_PUNCTUATIONS = "\"'.。,，!！?？:：”)]}、"
# languages written without spaces: words are unicode codepoints (openai's
# split_tokens_on_unicode path)
_SPACELESS_LANGUAGES = frozenset({"zh", "ja", "th", "lo", "my", "yue"})
_ASCII_PUNCTUATION = "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~"
_MEDIAN_WIDTH = 7  # openai's medfilt_width


def _split_tokens_on_unicode(toks: list[int], decode_text) -> tuple[list[str], list[list[int]]]:
    """Group BPE tokens into complete unicode units: tokens accumulate until
    the decoded string holds no U+FFFD, unless the full decode really holds
    one at that offset (openai's split_tokens_on_unicode).  Returns
    (subwords, index groups into ``toks``)."""
    decoded_full = decode_text(toks)
    rc = "�"
    subwords: list[str] = []
    sub_idx: list[list[int]] = []
    cur: list[int] = []
    cur_idx: list[int] = []
    unicode_offset = 0
    for k, tok in enumerate(toks):
        cur.append(tok)
        cur_idx.append(k)
        decoded = decode_text(cur)
        complete = rc not in decoded
        if not complete:
            at = unicode_offset + decoded.index(rc)
            complete = at < len(decoded_full) and decoded_full[at] == rc
        if complete:
            subwords.append(decoded)
            sub_idx.append(cur_idx)
            cur, cur_idx = [], []
            unicode_offset += len(decoded)
    return subwords, sub_idx


def _split_words(toks: list[int], decode_text, language: str | None) -> tuple[list[str], list[list[int]]]:
    """openai's split_to_word_tokens: unicode units for spaceless languages,
    else grouping at spaces and punctuation."""
    subwords, sub_idx = _split_tokens_on_unicode(toks, decode_text)
    if language in _SPACELESS_LANGUAGES:
        return subwords, sub_idx
    words: list[str] = []
    word_idx: list[list[int]] = []
    for sw, si in zip(subwords, sub_idx):
        if not words or sw.startswith(" ") or sw.strip() in _ASCII_PUNCTUATION:
            words.append(sw)
            word_idx.append(list(si))
        else:
            words[-1] += sw
            word_idx[-1].extend(si)
    return words, word_idx


def _merge_punctuations(words: list[dict], prepended: str, appended: str) -> list[dict]:
    """openai's merge_punctuations: opening marks fold into the next word,
    closing marks into the previous one; the base word keeps its own start,
    end and probability."""
    i, j = len(words) - 2, len(words) - 1
    while i >= 0:
        prev, following = words[i], words[j]
        if prev["word"].startswith(" ") and prev["word"].strip() in prepended:
            following["word"] = prev["word"] + following["word"]
            prev["word"] = ""
        else:
            j = i
        i -= 1
    i, j = 0, 1
    while j < len(words):
        prev, following = words[i], words[j]
        if not prev["word"].endswith(" ") and following["word"] in appended:
            prev["word"] = prev["word"] + following["word"]
            following["word"] = ""
        else:
            i = j
        j += 1
    return [w for w in words if w["word"]]


# ---------------------------------------------------------------------------
# The teacher-forced pass (float32)
# ---------------------------------------------------------------------------

def _embed(params: Params, tokens: torch.Tensor, audio_states: torch.Tensor):
    """float32 token + position embeddings, the causal mask and the float32
    encoder states of a teacher-forced pass."""
    p = params["decoder"]
    t = tokens.shape[1]
    x = p["token_emb"][tokens].float() + p["pos_emb"][:t].float()
    return x, causal_mask(t, tokens.device), audio_states.float()


def _decoder_block(bp, cfg: WhisperConfig, x, audio_states, causal, mesh=None):
    """One teacher-forced decoder block -> (x_next, cross-attention
    probabilities (B, H, T, Ta)); the one definition the pooled, per-head
    and all-heads passes run.  mesh: ``bp`` holds this model rank's slices,
    and the probabilities are its heads (``local_heads``)."""
    n_head = local_heads(cfg.n_text_head, mesh)
    x = x + self_attention(bp["attn"], layer_norm(bp["attn_ln"], x), n_head, causal, mesh=mesh)
    xa = layer_norm(bp["cross_attn_ln"], x)
    qx = split_heads(linear(bp["cross_attn"]["q"], xa), n_head).transpose(1, 2)
    kx = split_heads(linear(bp["cross_attn"]["k"], audio_states), n_head).transpose(1, 2)
    vx = split_heads(linear(bp["cross_attn"]["v"], audio_states), n_head).transpose(1, 2)
    scores = torch.matmul(qx, kx.transpose(-1, -2)) / math.sqrt(qx.shape[-1])
    probs = torch.softmax(scores, dim=-1)  # (B, H, T, Ta)
    ox = torch.matmul(probs, vx).transpose(1, 2)
    x = x + row_parallel_linear(bp["cross_attn"]["out"], merge_heads(ox), mesh)
    x = x + mlp(bp, layer_norm(bp["mlp_ln"], x), mesh)
    return x, probs


def _all_heads(probs: torch.Tensor, cfg: WhisperConfig, mesh) -> torch.Tensor:
    """A layer's cross-attention of every head (B, H, T, Ta), in head
    order, from this model rank's heads."""
    return mesh_lib.model_all_gather(probs, mesh, dim=1, units=cfg.n_text_head)


def _head_weights(cfg: WhisperConfig) -> np.ndarray:
    """(L, H) weights of the pooled map, summing to 1: the alignment heads,
    else every head of the last half of the layers."""
    w = np.zeros((cfg.n_text_layer, cfg.n_text_head), np.float32)
    if cfg.alignment_heads:
        for l, h in cfg.alignment_heads:
            w[l, h] = 1.0
    else:
        w[cfg.n_text_layer // 2 :, :] = 1.0
    return w / max(w.sum(), 1.0)


def _teacher_forced_scan(params: Params, cfg: WhisperConfig, tokens, audio_states, mesh=None):
    """(final hidden states (B, T, d), pooled cross-attention (B, T, Ta)).
    A layer whose heads all weigh 0 adds nothing to the map, so only the
    weighted layers' maps are gathered over the model group (an exact 0
    added to the sum would leave it as it is)."""
    x, causal, audio = _embed(params, tokens, audio_states)
    weights = _head_weights(cfg)
    head_w = torch.from_numpy(weights).to(x.device)
    acc = torch.zeros((tokens.shape[0], tokens.shape[1], audio.shape[1]), device=x.device)
    for l in range(cfg.n_text_layer):
        x, probs = _decoder_block(layer(params["decoder"]["blocks"], l), cfg, x, audio, causal,
                                  mesh)
        if weights[l].any():
            acc = acc + torch.einsum("h,bhqk->bqk", head_w[l], _all_heads(probs, cfg, mesh))
    return x, acc


def cross_attention_map(params: Params, cfg: WhisperConfig, tokens, audio_states,
                        mesh=None) -> torch.Tensor:
    """Teacher-forced pass -> the pooled cross-attention (B, T, Ta)."""
    return _teacher_forced_scan(params, cfg, tokens, audio_states, mesh)[1]


def cross_attention_map_and_probs(
    params: Params, cfg: WhisperConfig, tokens, audio_states, vocab_cap: int | None = None,
    mesh=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``cross_attention_map`` plus the per-token probabilities (B, T):
    probs[:, i] = P(tokens[i] | tokens[:i], audio), 1.0 at position 0;
    ``vocab_cap`` normalises over the first vocab_cap logits (openai's
    ``logits[..., :eot]``).  The probabilities read the replicated
    ``token_emb`` after the final layer norm: nothing is gathered."""
    x, acc = _teacher_forced_scan(params, cfg, tokens, audio_states, mesh)
    return acc, _token_probs_from_hidden(params["decoder"], x, tokens, vocab_cap)


def _token_probs_from_hidden(p, x, tokens, vocab_cap, max_elems: int = 1 << 26) -> torch.Tensor:
    """Final hidden states -> next-token probabilities (B, T) of the fed
    tokens, position 0 at 1.0.  The (B, T, V) logits are made a block of
    positions at a time (at most ``max_elems`` logits live at once)."""
    xn = layer_norm(p["ln"], x)
    emb = p["token_emb"].float()
    if vocab_cap is not None:
        emb = emb[:vocab_cap]
    b, t = tokens.shape
    nxt = tokens[:, 1:].clamp(max=emb.shape[0] - 1)  # pad rows: unused values
    step = max(1, max_elems // max(1, b * emb.shape[0]))
    parts = []
    for lo in range(0, t - 1, step):
        lp = torch.log_softmax(torch.matmul(xn[:, lo : lo + step], emb.T), dim=-1)
        parts.append(lp.gather(-1, nxt[:, lo : lo + step, None])[..., 0])
    ones = torch.ones((b, 1), device=x.device)
    return torch.cat([ones, *[torch.exp(q) for q in parts]], dim=1)


def alignment_head_maps(
    params: Params, cfg: WhisperConfig, tokens, audio_states,
    vocab_cap: int | None = None, want_probs: bool = False, mesh=None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Teacher-forced pass -> each alignment head's cross-attention map
    (K, B, T, Ta) in ``cfg.alignment_heads`` order, plus the per-token
    probabilities (B, T) with ``want_probs``.  openai z-scores and
    median-filters each head apart and averages them last, which the pooled
    map cannot reproduce."""
    if not cfg.alignment_heads:
        raise ValueError("alignment_head_maps requires cfg.alignment_heads")
    x, causal, audio = _embed(params, tokens, audio_states)
    maps: list[torch.Tensor | None] = [None] * len(cfg.alignment_heads)
    for l in range(cfg.n_text_layer):
        x, probs = _decoder_block(layer(params["decoder"]["blocks"], l), cfg, x, audio, causal,
                                  mesh)
        slots = [(slot, h) for slot, (hl, h) in enumerate(cfg.alignment_heads) if hl == l]
        if slots:
            probs = _all_heads(probs, cfg, mesh)
        for slot, h in slots:
            maps[slot] = probs[:, h]
    out = torch.stack(maps)
    if not want_probs:
        return out, None
    return out, _token_probs_from_hidden(params["decoder"], x, tokens, vocab_cap)


def all_head_attention_maps(params: Params, cfg: WhisperConfig, tokens, audio_states) -> torch.Tensor:
    """Teacher-forced pass -> every head's cross-attention (L, B, H, T, Ta)
    (calibration only: it holds every map)."""
    x, causal, audio = _embed(params, tokens, audio_states)
    maps = []
    for l in range(cfg.n_text_layer):
        x, probs = _decoder_block(layer(params["decoder"]["blocks"], l), cfg, x, audio, causal)
        maps.append(probs)
    return torch.stack(maps)


def calibrate_alignment_heads(
    params: Params,
    cfg: WhisperConfig,
    audio_states: torch.Tensor,  # (B, Ta, d) calibration utterance(s)
    token_rows: np.ndarray,  # (B, T) decoded text tokens, EOT-padded
    st: SpecialTokens,
    top_k: int = 6,
    sot_sequence: tuple[int, ...] | None = None,
) -> tuple[tuple[int, int], ...]:
    """The (layer, head) pairs that track the audio timeline: each head's map
    over the served teacher-forced rows ``[*sot_sequence, <|notimestamps|>,
    *text, <|eot|>]`` is scored by the mean mass along its own DTW path,
    averaged over rows, and the top_k win (the JAX package's
    ``calibrate_alignment_heads``)."""
    prefix, texts, forced = _teacher_forced_rows(token_rows, st, sot_sequence)
    b = len(texts)
    tok = torch.from_numpy(forced).to(audio_states.device)
    maps = all_head_attention_maps(params, cfg, tok, audio_states).cpu().numpy()
    n_layers, _, n_heads = maps.shape[:3]
    lo = len(prefix)
    scores = np.zeros((n_layers, n_heads), np.float64)
    counts = np.zeros((n_layers, n_heads), np.int64)
    for row_i in range(b):
        text_pos = list(range(lo, lo + len(texts[row_i])))
        if len(text_pos) < 2:
            continue
        for l in range(n_layers):
            for h in range(n_heads):
                m = maps[l, row_i, h][text_pos]  # (n_text, Ta)
                m = m / np.maximum(m.sum(-1, keepdims=True), 1e-9)
                path = dtw_path(m, audio_states.device)
                scores[l, h] += float(np.mean(m[np.arange(len(text_pos)), path]))
                counts[l, h] += 1
    scores = scores / np.maximum(counts, 1)
    flat = np.argsort(scores, axis=None)[::-1][:top_k]
    return tuple(sorted((int(i // n_heads), int(i % n_heads)) for i in flat))


# ---------------------------------------------------------------------------
# The host chain: median filter and DTW
# ---------------------------------------------------------------------------

def _median_filter(x: np.ndarray, width: int) -> np.ndarray:
    """openai's median_filter: odd-width running median along the last axis
    with reflect padding; the identity when the axis is too short to
    reflect-pad (openai's early return at ``shape[-1] <= width // 2``)."""
    if width <= 1 or x.shape[-1] <= width // 2:
        return x
    pad = width // 2
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    win = np.lib.stride_tricks.sliding_window_view(xp, width, axis=-1)
    return np.median(win, axis=-1)


def dtw_path(matrix: np.ndarray, device="cpu") -> np.ndarray:
    """Monotonic alignment through a (T_text, T_audio) similarity matrix of
    attention weights: DTW on the -log cost surface."""
    return dtw_path_from_cost(-np.log(np.maximum(matrix, 1e-9)), device)


def dtw_path_from_cost(cost: np.ndarray, device="cpu") -> np.ndarray:
    """For each text row of a (T_text, T_audio) COST matrix, the audio
    column where it starts (openai-whisper's dtw_cpu backtrace: float32
    sums, ties to the right step).  ``device`` picks the C++ function (a
    CUDA device) or the numpy twin (``ops/kernels/dtw.py``)."""
    t, ta = cost.shape
    return dtw_starts(cost[None], [t], [ta], device)[0]


def alignment_costs(
    attn: np.ndarray, texts: list[list[int]], lo: int, n_audio: int,
    content_frames: np.ndarray | None, per_head: bool,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The host chain from the alignment maps to a padded batch of DTW
    costs: per row, the crop to its content frames and row renormalisation,
    the z-score over the full fed token axis (prefix rows included, openai's
    std_mean before its row crop), the width-7 median filter along frames,
    the head mean and openai's row window ``[lo-1, lo+len(text)]`` (row k
    predicts text[k]; the last row predicts <|eot|>), negated.
    ``attn``: (K, B, T, Ta) per-head maps, or (B, T, Ta) pooled.  Returns
    (cost (B, T', Ta'), rows (B,), frames (B,)); empty rows have 0 rows."""
    b = len(texts)
    mats = []
    for row_i, text in enumerate(texts):
        if not text:
            mats.append(None)
            continue
        nf = n_audio
        if content_frames is not None:
            nf = max(2, min(n_audio, int(content_frames[row_i])))
        if per_head:
            w = attn[:, row_i, : lo + len(text) + 1, :nf]  # (K, rows, nf)
        else:
            w = attn[row_i][None, : lo + len(text) + 1, :nf]
        w = w / np.maximum(w.sum(-1, keepdims=True), 1e-9)
        mean = w.mean(axis=-2, keepdims=True)
        # openai's torch.std_mean(unbiased=False); the 1e-9 clamp guards a
        # constant column (openai would emit nan there)
        std = np.maximum(w.std(axis=-2, keepdims=True), 1e-9)
        w = _median_filter((w - mean) / std, _MEDIAN_WIDTH)
        mats.append(-w.mean(axis=0)[lo - 1 : lo + len(text)])
    rows = np.asarray([0 if m is None else m.shape[0] for m in mats], np.int64)
    frames = np.asarray([0 if m is None else m.shape[1] for m in mats], np.int64)
    cost = np.zeros((b, max(rows.max(initial=0), 1), max(frames.max(initial=0), 1)), np.float32)
    for row_i, m in enumerate(mats):
        if m is not None:
            cost[row_i, : m.shape[0], : m.shape[1]] = m
    return cost, rows, frames


def _teacher_forced_rows(token_rows: np.ndarray, st: SpecialTokens, sot_sequence):
    """(prefix, text rows, forced (B, W) int64): ``[*sot_sequence,
    <|notimestamps|>, *text, <|eot|>]`` per row, EOT-padded."""
    prefix = list(sot_sequence) if sot_sequence else [st.sot]
    prefix.append(st.no_timestamps)
    texts = [[int(tok) for tok in row if tok < st.eot] for row in token_rows]
    width = len(prefix) + max((len(x) for x in texts), default=0) + 1
    forced = np.full((len(texts), width), st.eot, np.int64)
    for i, text in enumerate(texts):
        forced[i, : len(prefix)] = prefix
        forced[i, len(prefix) : len(prefix) + len(text)] = text
        # position len(prefix)+len(text) stays eot: the terminator row
    return prefix, texts, forced


def alignment_maps(
    params: Params, cfg: WhisperConfig, audio_states: torch.Tensor, forced: np.ndarray,
    vocab_cap: int, with_probabilities: bool, mesh=None,
) -> tuple[np.ndarray, np.ndarray | None]:
    """The teacher-forced pass over ``forced`` rows where the states are,
    read back to the host: per-head maps (K, B, T, Ta) with
    ``cfg.alignment_heads``, else the pooled map (B, T, Ta); and the token
    probabilities (B, T) with ``with_probabilities``.  mesh: ``params`` are
    this model rank's slices; every model rank returns the whole maps."""
    tok = torch.from_numpy(forced).to(audio_states.device)
    if cfg.alignment_heads:
        maps, probs = alignment_head_maps(
            params, cfg, tok, audio_states, vocab_cap=vocab_cap, want_probs=with_probabilities,
            mesh=mesh,
        )
    elif with_probabilities:
        maps, probs = cross_attention_map_and_probs(params, cfg, tok, audio_states, vocab_cap,
                                                    mesh)
    else:
        maps, probs = cross_attention_map(params, cfg, tok, audio_states, mesh), None
    return maps.cpu().numpy(), None if probs is None else probs.cpu().numpy()


def word_timestamps(
    params: Params,
    cfg: WhisperConfig,
    audio_states: torch.Tensor,  # (B, Ta, d)
    token_rows: np.ndarray,  # (B, T) decoded text tokens, EOT-padded
    st: SpecialTokens,
    decode_text,
    chunk_offsets_s: np.ndarray,
    with_probabilities: bool = False,
    language: str | None = None,
    prepend_punctuations: str = PREPEND_PUNCTUATIONS,
    append_punctuations: str = APPEND_PUNCTUATIONS,
    sot_sequence: tuple[int, ...] | None = None,
    content_frames: np.ndarray | None = None,
    mesh=None,
) -> list[list[dict]]:
    """Per window: [{"word", "start", "end"[, "probability"]}] on the global
    timeline, openai's find_alignment recipe as the JAX package's
    ``word_timestamps`` runs it: the teacher-forced rows carry the decode's
    sot sequence, the maps are cropped to each window's content frames
    (``content_frames``), each alignment head is z-scored and filtered apart
    and the heads averaged last (the pooled map when there are none), and
    DTW runs over openai's row window with the final <|eot|> row giving the
    last word's end.  Words split at unicode units, then at spaces (a
    codepoint a word for spaceless ``language``s), and punctuation merges
    into its neighbour.  ``probability`` is the mean token probability over
    the text vocabulary (openai's ``logits[..., :eot]``), which the
    hallucination filter reads.  mesh: ``params`` are this model rank's
    slices (the rows are this data rank's: nothing crosses the data group
    here)."""
    b, t = token_rows.shape
    if t == 0:
        return [[] for _ in range(b)]
    prefix, texts, forced = _teacher_forced_rows(token_rows, st, sot_sequence)
    attn, tok_probs = alignment_maps(params, cfg, audio_states, forced, st.eot, with_probabilities,
                                     mesh)
    lo = len(prefix)
    cost, rows, frames = alignment_costs(
        attn, texts, lo, attn.shape[-1], content_frames, bool(cfg.alignment_heads),
    )
    starts = dtw_starts(cost, rows, frames, audio_states.device)
    return assemble_words(
        texts, starts, tok_probs, lo, chunk_offsets_s, decode_text, language,
        prepend_punctuations, append_punctuations,
    )


def assemble_words(
    texts, starts, tok_probs, lo, chunk_offsets_s, decode_text, language,
    prepend_punctuations=PREPEND_PUNCTUATIONS, append_punctuations=APPEND_PUNCTUATIONS,
) -> list[list[dict]]:
    """Token starts -> each row's merged words: a word starts at its first
    token's frame and ends where the next word starts (the <|eot|> row's
    frame for the last)."""
    out: list[list[dict]] = []
    for row_i, text in enumerate(texts):
        if not text:
            out.append([])
            continue
        row_starts = starts[row_i]
        offset = float(chunk_offsets_s[row_i])
        word_strs, word_idx = _split_words(text, decode_text, language)
        words: list[dict] = []
        for wi, (wstr, kidx) in enumerate(zip(word_strs, word_idx)):
            start_f = float(row_starts[kidx[0]])
            if wi + 1 < len(word_idx):
                end_f = float(row_starts[word_idx[wi + 1][0]])
            else:
                end_f = float(row_starts[len(text)])  # the eot row's frame
            w = {
                "word": wstr,
                "start": round(offset + start_f * AUDIO_FRAME_S, 3),
                "end": round(offset + end_f * AUDIO_FRAME_S, 3),
            }
            if tok_probs is not None:
                w["probability"] = float(np.mean(tok_probs[row_i][[lo + k for k in kidx]]))
            words.append(w)
        out.append(_merge_punctuations(words, prepend_punctuations, append_punctuations))
    return out
