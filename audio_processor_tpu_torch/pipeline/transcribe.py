"""End-to-end transcription: audio -> timestamped segments, in PyTorch.

The port of the JAX package's ``pipeline/transcribe.py``: the recording
is cut into 30 s windows that run through the fused log-mel kernel, the
encoder (optionally through the encoder-attention kernel) and the decode
in slabs of windows, followed by openai-whisper's quality-retry ladder,
no-speech gate, seek repair and segment assembly.  The decode is greedy
over the int4 cross-KV cache by default, or beam search, prompted by
``initial_prompt``, continued from a ``prefix``, or conditioned on the
previous windows' text in window groups, over an int8 self-attention
cache with ``quantize_self_kv``.  Option defaults are the JAX package's.
With ``word_timestamps`` each slab's encoder states are kept for a
teacher-forced alignment pass and a DTW on the host
(``models/whisper/align.py``), which give every segment its words;
``hallucination_silence_threshold`` then drops anomalous segments next to
silence.  ``transcribe_batch`` packs the windows of several recordings
into shared slabs.  Audio at another rate than 16 kHz is resampled on the
device (``ops/frontend.resample``).

Slabs run one after another: PyTorch queues the card's work
asynchronously, and the decode loop reads back one flag per token.
``transcribe`` and ``transcribe_batch`` each open a request of the port's
tracer (``runtime/trace.py``) whose summary the result carries as
"trace": the spans ``transcribe.ingest``, ``.trim``, ``.slab_cut``,
``.encode``, ``.language``, ``.decode``, ``.collect``, ``.seek_repair`` and
``.segments`` under ``transcribe``, the decode loops' spans, and the
counters ``transcribe.windows`` (real windows), ``transcribe.slabs`` (grid
slabs, cut by ``slab_plan``) and ``decode.rows`` (slab rows, padding
included).

Under a (data, model) mesh (``parallel/mesh.py``; one process per rank)
every rank holds its shard of the parameters (``parallel/sharding.py``)
and cuts the same slabs, each rounded to a multiple of the data axis.  A
data rank frontends, encodes and decodes its rows of a slab; the decode
results are all-gathered over the data axis, and every rank then runs the
same host logic (retry ladder, no-speech gate, seek repair, segments) and
returns the same result.  With word timestamps a data rank aligns its own
rows of each slab (the teacher-forced pass on the rank's heads, the host
chain and the DTW) and the word lists are all-gathered over the data
axis.  int8 decoder weights serve on a data-only mesh (tp=1: whole
weights on every rank); a model axis raises, as in the JAX package.
"""
from __future__ import annotations

import logging
import math
import os
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from . import ingest
from ..models.whisper import decode as decode_lib
from ..models.whisper import model as model_lib
from ..models.whisper.config import WhisperConfig, get_config
from ..models.whisper.tokenizer import (
    WHISPER_LANGUAGES,
    WHISPER_LANGUAGES_V3,
    ByteTokenizer,
)
from ..ops import frontend
from ..ops.kernels.log_mel import log_mel
from ..parallel import mesh as mesh_lib
from ..parallel import sharding as sharding_lib
from ..runtime import trace
from ..runtime.device import resolve_device
from ..utils import timestamps as timestamps_lib
from ..utils.timestamps import TimeMap

logger = logging.getLogger(__name__)

CHUNK_SAMPLES = frontend.N_SAMPLES  # 480_000 = 30 s @ 16 kHz

# openai's default retry rungs ((0, .2, .4, .6, .8, 1) minus the 0 base)
DEFAULT_TEMPERATURE_LADDER = (0.2, 0.4, 0.6, 0.8, 1.0)

# openai-whisper's punctuation set for the hallucination anomaly score
# (whisper/transcribe.py `punctuation`): pure-punctuation "words" carry no
# evidence either way and are left out of the score
_PUNCTUATION = "\"'“¿([{-\"'.。,，!！?？:：”)]}、"


def _word_anomaly_score(word: dict) -> float:
    """openai-whisper's word_anomaly_score: improbable or implausibly
    short or long words score high."""
    probability = word.get("probability", 0.0)
    duration = word["end"] - word["start"]
    score = 0.0
    if probability < 0.15:
        score += 1.0
    if duration < 0.133:
        score += (0.133 - duration) * 15
    if duration > 2.0:
        score += duration - 2.0
    return score


def _is_segment_anomaly(seg_words: list[dict]) -> bool:
    """openai-whisper's is_segment_anomaly over a segment's words."""
    words = [w for w in seg_words if w["word"] not in _PUNCTUATION][:8]
    if not words:
        return False
    score = sum(_word_anomaly_score(w) for w in words)
    return score >= 3 or score + 0.01 >= len(words)


def filter_hallucinations(
    segments: list[dict], words: list[dict], threshold: float, total_duration: float,
) -> tuple[list[dict], list[dict]]:
    """openai's hallucination_silence_threshold as a pass over the final
    timeline (the JAX package's ``filter_hallucinations``): an anomalous
    segment with silence longer than ``threshold`` (or another anomaly) on
    both sides is dropped, with its words.  openai grants the end of the
    recording a fixed 2.0 s window.  Returns (segments, words)."""
    if not segments:
        return segments, words

    def words_in(seg: dict) -> list[dict]:
        return [w for w in words
                if seg["start"] - 0.05 <= (w["start"] + w["end"]) / 2 <= seg["end"] + 0.05]

    anomalous = [_is_segment_anomaly(words_in(s)) for s in segments]
    kept: list[dict] = []
    dropped_spans: list[tuple[float, float]] = []
    for si, seg in enumerate(segments):
        if not anomalous[si]:
            kept.append(seg)
            continue
        prev_end = kept[-1]["end"] if kept else 0.0
        nxt = segments[si + 1] if si + 1 < len(segments) else None
        next_start = nxt["start"] if nxt is not None else total_duration
        silence_before = seg["start"] - prev_end > threshold or seg["start"] < threshold
        silence_after = (
            next_start - seg["end"] > threshold
            or total_duration - seg["end"] < 2.0
            or (nxt is not None and anomalous[si + 1])
        )
        if silence_before and silence_after:
            dropped_spans.append((seg["start"], seg["end"]))
        else:
            kept.append(seg)
    if not dropped_spans:
        return segments, words
    kept_words = [
        w for w in words
        if not any(s - 0.05 <= (w["start"] + w["end"]) / 2 <= e + 0.05 for s, e in dropped_spans)
    ]
    return kept, kept_words


def _has_int8_weights(params) -> bool:
    """True when a decoder linear holds int8 weights (quantize_decoder)."""
    found = []
    model_lib.map_params(lambda t: found.append(t.dtype == torch.int8), params["decoder"])
    return any(found)


def _f32_to_i16(x: np.ndarray) -> np.ndarray:
    """Float32 [-1, 1] audio -> int16, the wire dtype shipped to the card.
    One definition for the grid windows and the seek-repair patches."""
    return np.clip(x * 32768.0, -32768, 32767).astype(np.int16)


def _bucket(n: int, max_bucket: int = 64) -> int:
    """Round a chunk count up to the next power of two; above max_bucket,
    to a multiple of max_bucket."""
    if n >= max_bucket:
        return -(-n // max_bucket) * max_bucket
    return 1 << max(0, n - 1).bit_length()


def slab_rows(n: int) -> int:
    """Rows of a slab of n windows: the next power of two below 8, the next
    multiple of 8 from 8 on.  The decode keeps a captured session per row
    count (``decode.MAX_SESSIONS``), so the slabs take few shapes."""
    return 1 << max(0, n - 1).bit_length() if n <= 8 else -(-n // 8) * 8


def slab_plan(n: int, cap: int, multiple: int = 1) -> list[tuple[int, int, int]]:
    """How n windows are cut into slabs of at most ``cap`` rows, each rounded
    up to a multiple of ``multiple`` (the data axis): (first window, windows,
    rows) of each slab.  ceil(n / cap) slabs share the windows about evenly;
    every slab but the last is all windows, and the last has the rows of its
    own windows."""
    def up(x):
        return -(-x // multiple) * multiple

    cap = up(cap)
    k = max(1, -(-n // cap))
    stride = up(min(slab_rows(-(-n // k)), cap))
    return [(lo, min(stride, n - lo), up(min(slab_rows(min(stride, n - lo)), cap)))
            for lo in range(0, n, stride)]


# The most rows a slab takes: a bound on how long a slab's first streamed
# segment waits, and the cap wherever no card sizes it (the CPU).
SLAB_ROWS = 128
# The card's share that no slab may take: the CUDA context, the caching
# allocator's fragmentation and the Diarizer's passes.
CARD_HEADROOM = 0.1
MLP_RATIO = 4  # Whisper's MLP hidden over its width
# The windows ``Transcriber.warmup`` transcribes by default: a 30 min
# recording, the meeting service's own, so its slabs' shapes are warm.
WARMUP_WINDOWS = 60


def row_bytes(cfg: WhisperConfig, compute_dtype: str, quantize_cross_kv: bool = True,
              cross_kv_bits: int = 4, quantize_self_kv: bool = False) -> tuple[int, int]:
    """(kept, passing): the bytes of one slab row on the card that a kept
    decode session holds between decodes, and those the row's decode holds
    only while it runs, from the widths.

    Kept: the cross cache (int4 nibble-packed over 128-padded time, int8, or
    unquantized), the self cache over the whole text context, and four
    float32 rows of logits (logits, masked, log-softmax, sampled) in the
    graphs' pool.  Passing: the encoder states, and the larger of the
    encoder's transient (at T = 1500: the residual, its layer norm, the MLP
    hidden and its GELU) and the cross cache's build (one layer's K and V,
    then in float32 for the quantization).  At turbo's widths (bf16, int4)
    that is 7.9 + 9.2 + 0.8 = 17.9 MB kept and 3.8 + max(38.4, 23.0) =
    42.2 MB passing.  Checked on an H100 80GB, one decode of 16 and of 48
    rows: a row kept 11.5, 59.3 and 100.6 MB after the decode and took 48.2,
    59.0 and 81.8 MB at its peak for turbo, medium and large-v3, under the
    60.1, 116.4 and 179.4 MB here (an unprompted decode fills half the self
    cache)."""
    eb = torch.finfo(getattr(torch, compute_dtype)).bits // 8
    t, da, dt, n_layer = cfg.n_audio_ctx, cfg.n_audio_state, cfg.n_text_state, cfg.n_text_layer
    tpad = t + (-t) % 128
    if not quantize_cross_kv:
        cross = build = n_layer * 2 * t * dt * eb
    else:
        cross = n_layer * 2 * dt * (tpad // 2 if cross_kv_bits == 4 else tpad)
        build = 2 * t * dt * (eb + 4)
    self_cache = n_layer * 2 * cfg.n_text_ctx * dt * (1 if quantize_self_kv else eb)
    kept = cross + self_cache + 4 * cfg.n_vocab * 4
    encode = t * (2 + 2 * MLP_RATIO) * da * eb
    return kept, t * da * eb + max(encode, build)


def detect_bytes(cfg: WhisperConfig) -> int:
    """Bytes a language detection holds on the card at once: the float32
    states and cross cache of every decoder layer for ``DETECT_ROWS`` rows
    (``decode.detect_language``).  On an H100 80GB a 16-row decode peaked
    4.82 and 7.99 GB over medium's and large-v3's weights with that cache
    stacked from a list of layers (twice this), 2.70 and 4.31 GB with it
    filled a layer at a time."""
    t, da, dt = cfg.n_audio_ctx, cfg.n_audio_state, cfg.n_text_state
    return decode_lib.DETECT_ROWS * (cfg.n_text_layer * 2 * t * dt + t * da) * 4


def card_slab_cap(total_bytes: int, fixed_bytes: int, row: int, dp: int = 1) -> int:
    """Windows a slab on cards of ``total_bytes`` each: what is left past
    ``CARD_HEADROOM`` and ``fixed_bytes`` (a card's weights, buffers and
    co-resident models) at ``row`` bytes a window on each of ``dp`` data
    ranks, at most ``SLAB_ROWS``, rounded down to a row count of
    ``slab_rows``."""
    fit = int((total_bytes * (1 - CARD_HEADROOM) - fixed_bytes) // row) * dp
    cap = max(1, min(SLAB_ROWS, fit))
    return cap // 8 * 8 if cap >= 8 else 1 << (cap.bit_length() - 1)


@dataclass
class Transcriber:
    """Holds params for one Whisper variant on one device.

    ``device=None`` runs on the card and raises without one; pass
    ``device="cpu"`` for the plain PyTorch path.  With ``mesh`` (a
    ``parallel.mesh.Mesh``; every rank builds its own Transcriber with the
    same options and whole params) the device is the mesh's.
    """

    params: Any
    cfg: WhisperConfig
    tokenizer: Any = field(default_factory=ByteTokenizer)
    language: int | None = None  # language token index, None = detect
    compute_dtype: str = "bfloat16"
    # parameter storage dtype: "auto" stores params in compute_dtype when
    # that isn't float32; None keeps them as given
    weights_dtype: str | None = "auto"
    max_new_tokens: int = 224
    device: Any = None
    quantize_cross_kv: bool = True
    # 4: nibble-packed int4 cross-KV read by the CUDA decode kernel; 8:
    # the plain int8 cache (no kernel), as in the JAX package
    cross_kv_bits: int = 4
    # sampling candidates per window on T>0 decodes (openai's best_of)
    best_of: int = 5
    # 0 = greedy; > 0 = beam search at T=0, sampling retries at T>0
    beam_size: int = 0
    # openai's beam patience: collect round(beam_size * patience) finished
    # hypotheses before stopping
    patience: float = 1.0
    # beam ranking: None = average logprob (openai's default), a float =
    # the Google-NMT ((5 + len) / 6) ** length_penalty form
    length_penalty: float | None = None
    # base decode temperature; > 0 samples from the start, no retries
    temperature: float = 0.0
    temperature_ladder: tuple[float, ...] | None = None
    logprob_threshold: float | None = -1.0
    compression_ratio_threshold: float | None = 2.4
    enable_fallback: bool = True
    no_speech_threshold: float | None = 0.6
    # openai's suppress_tokens: None or [-1] = the default non-speech set
    suppress_tokens: list[int] | None = None
    # windows per slab: None = sized from the card's memory for one decode
    # at a time (``card_slab_cap``; ``build_services`` sizes it for its
    # service), 128 on the CPU
    max_chunk_batch: int | None = None
    task: str = "transcribe"
    auto_language: bool = True
    seek_repair: bool = True
    without_timestamps: bool = False
    max_initial_timestamp: float | None = 1.0
    # encoder self-attention through the encoder-attention CUDA kernel also
    # where it would run plain (float32 on CUDA); bfloat16 on CUDA takes the
    # kernel without it (``encoder_attention.kernel_serves``)
    use_pallas_encoder_attn: bool = False
    # openai's initial_prompt: <|startofprev|> context for the first window
    # (kept through its retries); with condition_on_previous_text it seeds
    # the first group's rolling context
    initial_prompt: str | None = None
    # openai's carry_initial_prompt: the initial prompt prefixes EVERY
    # window's context, the rolling history trimmed to what still fits
    carry_initial_prompt: bool = False
    # openai's DecodingOptions.prefix: text after the sot sequence that the
    # decode continues from; it never reaches the output
    prefix: str | None = None
    # openai's condition_on_previous_text in window groups: each window is
    # prompted with the text of the earlier windows of its group of
    # condition_group_size consecutive windows; groups decode in parallel
    condition_on_previous_text: bool = False
    condition_group_size: int = 8
    condition_ctx_tokens: int = 48
    # parallel.mesh.Mesh: serve on a (data, model) mesh, one process a rank
    mesh: Any = None
    # openai's word_timestamps: a teacher-forced alignment pass over each
    # window's tokens and a DTW give every segment its "words"; spaceless
    # languages (zh/ja/th/lo/my/yue) split per codepoint, others at
    # spaces, punctuation merged into its neighbour by the two strings
    word_timestamps: bool = False
    prepend_punctuations: str = "\"'“¿([{-"
    append_punctuations: str = "\"'.。,，!！?？:：”)]}、"
    # openai's hallucination_silence_threshold (seconds): drop anomalous
    # segments next to silence longer than this; needs word_timestamps
    hallucination_silence_threshold: float | None = None
    # int8 self-attention cache with per-token scales (the JAX package's
    # memory option; the cross cache and its kernels are unchanged)
    quantize_self_kv: bool = False
    # accepted for configs written for the JAX package, where it picks the
    # Pallas log-mel kernel on a TPU backend; the port's card path runs
    # kernel A (csrc/log_mel.cu) whatever its value, and the CPU path its
    # plain version
    use_pallas_frontend: bool = False

    def __post_init__(self):
        if self.task not in ("transcribe", "translate"):
            raise ValueError(f"task must be transcribe|translate, got {self.task!r}")
        if self.hallucination_silence_threshold is not None and not self.word_timestamps:
            raise ValueError(
                "hallucination_silence_threshold requires word_timestamps=True "
                "(the anomaly score reads word probabilities and durations, as "
                "in openai-whisper)"
            )
        if self.mesh is not None and self.mesh.tp > 1 and _has_int8_weights(self.params):
            raise ValueError(
                "int8 decoder weights need model_parallel=1: the model-parallel "
                "split reads float linears (serve them on a data-only mesh)"
            )
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.mesh is None:
            self.device = resolve_device(self.device)
        elif self.device is None or resolve_device(self.device) == self.mesh.device:
            self.device = self.mesh.device
        else:
            raise ValueError(f"device {self.device} is not the mesh's {self.mesh.device}")
        self._max_initial_ts_index = (
            None if self.max_initial_timestamp is None
            else int(round(self.max_initial_timestamp / 0.02))
        )
        # openai's temperature option: a single float means one decode; the
        # default ladder applies only to a zero base temperature
        if self.temperature_ladder is None:
            self._ladder = () if self.temperature > 0 else DEFAULT_TEMPERATURE_LADDER
        else:
            self._ladder = tuple(t for t in self.temperature_ladder if t > self.temperature)
        self.special = decode_lib.SpecialTokens.for_config(self.cfg)
        if self.language is not None and self.language >= self.special.num_languages:
            raise ValueError(
                f"language index {self.language} is out of range for this "
                f"model's {self.special.num_languages}-language vocabulary"
            )
        wd = self.weights_dtype
        if wd == "auto":
            wd = None if self.compute_dtype == "float32" else self.compute_dtype
        target = getattr(torch, wd) if wd is not None else None
        dev = self.device
        tp = 1 if self.mesh is None else self.mesh.tp

        def cast(t):
            if target is not None and t.dtype == torch.float32:
                t = t.to(target)
            return t.to(dev) if tp == 1 else t  # shard_params moves the slices

        # params sharded already (a Transcriber rebuilt by
        # dataclasses.replace) keep their slices: cut once, never again
        sharded = isinstance(self.params, sharding_lib.ShardedParams)
        if sharded and (tp == 1 or self.params.layout != sharding_lib.layout_of(self.mesh)):
            raise ValueError(f"params sharded for (tp, model rank) {self.params.layout} "
                             "do not fit this Transcriber's mesh")
        layout = self.params.layout if sharded else None
        self.params = model_lib.map_params(cast, self.params)
        # tensor-parallel serving: after the storage-dtype cast, each rank
        # keeps its slice of the params (Megatron specs, parallel/sharding)
        if sharded:
            self.params = sharding_lib.ShardedParams(self.params, layout)
        elif tp > 1:
            if tp > min(self.cfg.n_audio_head, self.cfg.n_text_head):
                raise ValueError(f"tp={tp} exceeds the model's heads")
            self.params = sharding_lib.shard_params(self.params, self.mesh, self.cfg)
            if self.cross_kv_bits == 4 and self.cfg.n_text_head % tp:
                # kernel #5 needs the heads split evenly
                logger.info(
                    "model-parallel mesh: %d heads do not shard over tp=%d — "
                    "falling back to the plain int8 cross-KV path",
                    self.cfg.n_text_head, tp,
                )
                self.cross_kv_bits = 8
        if self.max_chunk_batch is None:
            self.max_chunk_batch = self.card_slab_cap() or SLAB_ROWS
        # per-call detected language, thread-local: a server may share one
        # Transcriber across job threads
        self._lang_tls = threading.local()
        # openai's default SuppressTokens, refined by suppress_tokens with
        # DecodingOptions semantics (-1 mixes the default set back in)
        if self.suppress_tokens is None or list(self.suppress_tokens) == [-1]:
            mask = decode_lib.build_suppress_mask(self.tokenizer, self.special)
        else:
            ids = [int(t) for t in self.suppress_tokens]
            if -1 in ids:
                mask = decode_lib.build_suppress_mask(self.tokenizer, self.special)
                ids = [t for t in ids if t >= 0]
            else:
                mask = np.zeros(self.special.n_vocab, bool)
                for t in decode_lib.always_suppressed_specials(self.special):
                    if 0 <= t < self.special.n_vocab:
                        mask[t] = True
            for t in ids:
                if 0 <= t < self.special.n_vocab:
                    mask[t] = True
        self._suppress_mask = torch.from_numpy(mask).to(dev)
        self._space_blank_id = decode_lib.space_blank_token_id(
            self.tokenizer, self.special
        )
        self._prefix_tokens = self._encode_prefix()
        self._initial_prompt_tokens = self._encode_initial_prompt()

    def _encode_prefix(self) -> list[int]:
        """DecodingOptions.prefix as token ids, capped at openai's
        max_prefix_len = n_text_ctx // 2 - max_new_tokens (a non-positive cap
        keeps everything: openai's ``[-0:]``), and so that the prefill and the
        decode fit n_text_ctx."""
        if not self.prefix:
            return []
        toks = [
            int(t) for t in self.tokenizer.encode(" " + self.prefix.strip())
            if int(t) < self.special.eot
        ]
        max_prefix_len = self.cfg.n_text_ctx // 2 - self.max_new_tokens
        if max_prefix_len > 0:
            toks = toks[-max_prefix_len:]
        sot_len = len(self.special.sot_sequence(language=0))
        hard = self.cfg.n_text_ctx - self.max_new_tokens - sot_len - 1
        if hard <= 0:
            raise ValueError(
                f"max_new_tokens={self.max_new_tokens} leaves no room for a "
                f"prefix within n_text_ctx={self.cfg.n_text_ctx}"
            )
        return toks[-hard:]

    def _encode_initial_prompt(self) -> list[int]:
        """initial_prompt as token ids: openai prepends a space and keeps the
        last n_text_ctx // 2 - 1; capped further so that prompt, sot
        sequence, prefix and max_new_tokens fit n_text_ctx."""
        if not self.initial_prompt:
            return []
        toks = self.tokenizer.encode(" " + self.initial_prompt.strip())
        sot_len = len(self.special.sot_sequence(language=0)) + len(self._prefix_tokens)
        cap = min(
            self.cfg.n_text_ctx // 2 - 1,
            self.cfg.n_text_ctx - self.max_new_tokens - sot_len - 1,
        )
        if cap <= 0:
            raise ValueError(
                f"max_new_tokens={self.max_new_tokens} leaves no room for an "
                f"initial_prompt within n_text_ctx={self.cfg.n_text_ctx}"
            )
        return [int(t) for t in toks if int(t) < self.special.eot][-cap:]

    # -- factories -------------------------------------------------------------

    @staticmethod
    def _init_device(device, mesh) -> torch.device:
        """Where a factory makes the params: the mesh's device, else
        ``device`` resolved."""
        return mesh.device if mesh is not None and device is None else resolve_device(device)

    @classmethod
    def random_init(
        cls, name: str = "tiny", seed: int = 0, device=None, **kw
    ) -> "Transcriber":
        """Random-weight instance (tests and benches).  The fallback ladder
        is off by default: random-weight output always fails the gate."""
        kw.setdefault("enable_fallback", False)
        dev = cls._init_device(device, kw.get("mesh"))
        cfg = get_config(name)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = model_lib.init_params(cfg, gen)
        return cls(params=params, cfg=cfg, device=dev, **kw)

    @classmethod
    def from_npz(
        cls, path: str, tokenizer=None, tokenizer_path: str | None = None,
        device=None, **kw,
    ) -> "Transcriber":
        """Load a checkpoint converted by the JAX package's convert tool.
        Tokenizer: explicit object > tokenizer_path / APTPU_TOKENIZER_PATH >
        the vocab embedded in the .npz > ByteTokenizer with a warning."""
        from ..models.whisper import convert
        from ..models.whisper.tokenizer import load_tokenizer_file

        dev = cls._init_device(device, kw.get("mesh"))
        params, cfg = convert.load_params(path, dev)
        if tokenizer is None:
            tok_path = tokenizer_path or os.environ.get("APTPU_TOKENIZER_PATH")
            if tok_path:
                tokenizer = load_tokenizer_file(tok_path)
            else:
                tokenizer = convert.load_tokenizer(path)
                if tokenizer is None:
                    logger.warning(
                        "%s has no embedded tokenizer and none was given — "
                        "falling back to the byte tokenizer (real weights will "
                        "decode to garbage text)", path,
                    )
                    tokenizer = ByteTokenizer()
        return cls(params=params, cfg=cfg, tokenizer=tokenizer, device=dev, **kw)

    # -- helpers ---------------------------------------------------------------

    def weight_bytes(self) -> int:
        """Bytes of this process's parameters, as cast (a rank's shard)."""
        sizes = []
        model_lib.map_params(lambda t: sizes.append(t.numel() * t.element_size()), self.params)
        return sum(sizes)

    def card_slab_cap(self, decodes: int = 1, reserved_bytes: int = 0) -> int | None:
        """``card_slab_cap`` for this Transcriber on its card (each rank's,
        on a mesh), with ``decodes`` decodes running at once and
        ``reserved_bytes`` held by whatever else shares the card: from the
        card's total memory (never its momentary free memory, which would
        make a window's rows depend on what else runs), the weights as cast,
        ``max(decode.MAX_SESSIONS, decodes)`` kept sessions (each with a
        float32 copy of the unembedding and its rows' kept bytes), each
        decode's passing bytes and ``detect_bytes``, and a window's rows: its
        beams under beam search.  None on the CPU."""
        if self.device.type != "cuda":
            return None
        kept, passing = row_bytes(
            self.cfg, self.compute_dtype, self.quantize_cross_kv, self.cross_kv_bits,
            self.quantize_self_kv,
        )
        beams = self.beam_size if self.beam_size > 0 and self.temperature == 0 else 1
        sessions = max(decode_lib.MAX_SESSIONS, decodes)
        fixed = (self.weight_bytes() + reserved_bytes + decodes * detect_bytes(self.cfg)
                 + sessions * self.cfg.n_vocab * self.cfg.n_text_state * 4)
        total = torch.cuda.get_device_properties(self.device).total_memory
        return card_slab_cap(total, fixed, beams * (sessions * kept + decodes * passing), self._dp)

    @property
    def _slab_cap(self) -> int:
        """Slab cap: a base temperature > 0 expands every decode best_of-fold."""
        if self.temperature > 0 and self.best_of > 1:
            return max(1, self.max_chunk_batch // self.best_of)
        return self.max_chunk_batch

    @property
    def _retry_cap(self) -> int:
        """Sub-batch cap for retries: T>0 rungs expand rows best_of-fold."""
        return max(1, self.max_chunk_batch // max(1, self.best_of))

    def _sot_seq(self, lang: int | None) -> tuple[int, ...]:
        """The prefill sequence: sot tokens + the prefix tokens (openai's
        layout: sampling begins past the prefix, so it never reaches the
        output; prompt rows put <|startofprev|> + prompt before it)."""
        return tuple(
            self.special.sot_sequence(
                language=lang, task=self.task,
                timestamps=not self.without_timestamps,
            )
        ) + tuple(self._prefix_tokens)

    @property
    def _active_language(self) -> int | None:
        return getattr(self._lang_tls, "value", None)

    @_active_language.setter
    def _active_language(self, v: int | None) -> None:
        self._lang_tls.value = v

    def _frontend_encode(self, chunks_i16: torch.Tensor) -> torch.Tensor:
        """int16 (B, 480000) on the device -> encoder states (B, 1500, d).
        The log-mel is the fused CUDA kernel on the card, and so is encoder
        self-attention where the kernel serves (bfloat16), or everywhere on
        the card with use_pallas_encoder_attn; each layer that launches it
        counts ``encode.attn_kernel`` (``model.self_attention``)."""
        with trace.span("transcribe.encode"):
            audio = chunks_i16.float() / 32768.0
            mel = log_mel(audio, n_mels=self.cfg.n_mels)
            return model_lib.encode(
                self.params, self.cfg, mel, compute_dtype=getattr(torch, self.compute_dtype),
                fused_attn=True if self.use_pallas_encoder_attn else None, mesh=self.mesh,
            )

    # -- the data axis: a slab's rows split over the data ranks ----------------

    @property
    def _dp(self) -> int:
        return 1 if self.mesh is None else self.mesh.dp

    def _slab_plan(self, n: int, cap: int | None = None) -> list[tuple[int, int, int]]:
        """``slab_plan`` of n windows at ``cap`` (default the slab cap),
        rounded to the data axis."""
        return slab_plan(n, self._slab_cap if cap is None else cap, self._dp)

    def _round(self, n: int) -> int:
        """A slab size rounded up to a multiple of the data axis."""
        return mesh_lib.round_up_batch(n, self.mesh)

    def _local(self, x):
        """This data rank's rows of a whole slab's host array."""
        return x if self.mesh is None else x[self.mesh.local_rows(len(x))]

    def _all_rows(self, x: torch.Tensor) -> torch.Tensor:
        """A whole slab's tensor from each data rank's rows."""
        return mesh_lib.all_gather(x, self.mesh)

    def _gather_result(self, result):
        """A decode of this rank's rows -> the whole slab's DecodeResult."""
        if self._dp == 1:
            return result
        return decode_lib.DecodeResult(*(self._all_rows(t) for t in result))

    def _job_states(self, whole: torch.Tensor) -> torch.Tensor:
        """This data rank's rows of ``whole`` padded to a multiple of the
        data axis: the layout of a word-pass job (``_word_pass``)."""
        if self._dp == 1:
            return whole
        n = whole.shape[0]
        idx = np.zeros(self._round(n), np.int64)
        idx[:n] = np.arange(n)
        return whole[torch.from_numpy(self._local(idx)).to(whole.device)]

    def _take_rows(self, states: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
        """This rank's rows of the slab ``whole[idx]``, where ``states`` are
        this rank's rows of ``whole`` (retries re-batch rows across ranks)."""
        whole = self._all_rows(states)
        return whole[torch.from_numpy(np.asarray(self._local(idx))).to(whole.device)]

    def _chunk_slab_pairs(
        self, audios: list[np.ndarray], pairs: list[tuple[int, int]], bucket: int,
    ) -> torch.Tensor:
        """This data rank's rows of an int16 (bucket, CHUNK_SAMPLES) slab, on
        the device; each pair is (audio index, chunk index), so the rows may
        come from several recordings (cross-request batching)."""
        with trace.span("transcribe.slab_cut"):
            arr = np.zeros((bucket, CHUNK_SAMPLES), np.int16)
            for j, (fi, ci) in enumerate(pairs):
                piece = audios[fi][ci * CHUNK_SAMPLES : (ci + 1) * CHUNK_SAMPLES]
                arr[j, : len(piece)] = _f32_to_i16(piece)
            return torch.from_numpy(np.ascontiguousarray(self._local(arr))).to(self.device)

    def _chunk_slab(self, audio: np.ndarray, chunk_ids: list[int], bucket: int) -> torch.Tensor:
        """This data rank's rows of the int16 slab of one recording's chunks."""
        return self._chunk_slab_pairs([audio], [(0, ci) for ci in chunk_ids], bucket)

    def warmup(self, n_chunks: int | None = None) -> float:
        """Transcribe n_chunks windows of a low tone (default
        ``WARMUP_WINDOWS``) so the kernels are built and loaded, and the
        decode sessions of its slabs captured, before the first request.
        Returns the wall seconds spent."""
        if n_chunks is None:
            n_chunks = WARMUP_WINDOWS
        t0 = time.monotonic()
        t = np.arange(n_chunks * CHUNK_SAMPLES, dtype=np.float32) / 16_000
        audio = (0.1 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
        self.transcribe(audio, remove_silence=False)
        took = time.monotonic() - t0
        logger.info("warmup: %d-chunk slab decoded in %.1f s", n_chunks, took)
        return took

    # -- decode and quality gates -----------------------------------------------

    def _decode_kw(self) -> dict:
        """Options every decode of this Transcriber shares."""
        return dict(
            max_new_tokens=self.max_new_tokens,
            use_timestamps=not self.without_timestamps,
            max_initial_ts_index=self._max_initial_ts_index,
            suppress_mask=self._suppress_mask,
            space_blank_id=self._space_blank_id,
            dtype_name=self.compute_dtype,
            quantize_cross_kv=self.quantize_cross_kv,
            kv_bits=self.cross_kv_bits,
            quantize_self_kv=self.quantize_self_kv,
            mesh=self.mesh,
        )

    def _beam_decode(self, audio_states, sot_seq, rows=None, lens=None):
        """One beam_decode call (plain, initial_prompt and conditioned
        decodes share it); rows/lens are the whole slab's."""
        if rows is not None:
            rows, lens = self._local(rows), self._local(lens)
        return self._gather_result(decode_lib.beam_decode(
            self.params, self.cfg, audio_states, sot_sequence=sot_seq,
            beam_size=self.beam_size, patience=self.patience,
            length_penalty=self.length_penalty, prompt_tokens=rows, prompt_lens=lens,
            **self._decode_kw(),
        ))

    def _prompted_decode(self, audio_states, sot_seq, rows, lens, temperature, seed):
        """Prompt rows (build_prompt_rows, the whole slab's) decoded by beam
        search at T=0 with beam_size > 0, else by prompted greedy/sampling
        decode."""
        if self.beam_size > 0 and temperature == 0:
            return self._beam_decode(audio_states, sot_seq, rows, lens)
        return self._gather_result(decode_lib.prompted_greedy_decode(
            self.params, self.cfg, audio_states, self._local(rows), self._local(lens),
            sot_len=len(sot_seq), temperature=temperature, rng_seed=seed,
            best_of=self.best_of, **self._decode_kw(),
        ))

    def _carry_hists(self, hists: list[list[int]]) -> list[list[int]]:
        """carry_initial_prompt under conditioning: prepend the initial
        prompt to each row's rolling context, trimming the context tail to
        what fits in condition_ctx_tokens (openai clips all_tokens the same
        way against n_text_ctx // 2 - 1)."""
        ipt = self._initial_prompt_tokens
        if not (self.carry_initial_prompt and ipt):
            return hists
        budget = max(0, self.condition_ctx_tokens - len(ipt))
        return [ipt + (h[-budget:] if budget else []) for h in hists]

    def _run_decode(
        self, audio_states, temperature: float | None = None, seed: int = 0,
        first_row_prompt: bool = False,
    ):
        """One slab's decode of this rank's rows ``audio_states``; returns
        the whole slab's result.  first_row_prompt: row 0 holds the
        recording's first window, which the initial_prompt prompts; with
        carry_initial_prompt every row is prompted.  Unprompted rows decode
        exactly as plain greedy decode.  temperature=None means the base
        temperature."""
        if temperature is None:
            temperature = self.temperature
        lang = self._active_language if self._active_language is not None else self.language
        sot_seq = self._sot_seq(lang)
        ipt = self._initial_prompt_tokens
        trace.count("decode.rows", audio_states.shape[0] * self._dp)
        with trace.span("transcribe.decode"):
            if ipt and (first_row_prompt or self.carry_initial_prompt):
                b = audio_states.shape[0] * self._dp
                per_row = [ipt] * b if self.carry_initial_prompt else [ipt] + [[]] * (b - 1)
                rows, lens = decode_lib.build_prompt_rows(per_row, sot_seq, self.special,
                                                          len(ipt))
                return self._prompted_decode(audio_states, sot_seq, rows, lens, temperature,
                                             seed)
            if self.beam_size > 0 and temperature == 0:
                return self._beam_decode(audio_states, sot_seq)
            return self._gather_result(decode_lib.greedy_decode(
                self.params, self.cfg, audio_states, sot_sequence=sot_seq,
                temperature=temperature, rng_seed=seed, best_of=self.best_of,
                **self._decode_kw(),
            ))

    def _failed_rows(self, result, tokens: np.ndarray, n_real: int) -> np.ndarray:
        """Quality gate per chunk: low avg logprob or repetitive output."""
        # openai divides by len(tokens)+1 with no floor
        lengths = result.lengths.cpu().numpy()[:n_real]
        avg_lp = result.sum_logprob.cpu().numpy()[:n_real] / (lengths + 1)
        if self.logprob_threshold is None:
            failed = np.zeros(n_real, bool)
        else:
            failed = avg_lp < self.logprob_threshold
        if self.compression_ratio_threshold is not None:
            for i in range(n_real):
                failed[i] |= (
                    self._row_compression_ratio(tokens[i])
                    > self.compression_ratio_threshold
                )
        if self.no_speech_threshold is not None:
            # a window flagged as no-speech never retries (openai's
            # decode_with_fallback exemption)
            nsp = result.no_speech_prob.cpu().numpy()[:n_real]
            failed &= ~(nsp > self.no_speech_threshold)
        return failed

    def _silent_rows(self, nsp: np.ndarray, avg_lp: np.ndarray) -> np.ndarray:
        """openai's skip rule: silence iff no_speech_prob is high, unless the
        decode is confident (avg_logprob above logprob_threshold)."""
        silent = nsp > self.no_speech_threshold
        if self.logprob_threshold is not None:
            silent &= ~(avg_lp > self.logprob_threshold)
        return silent

    def _row_compression_ratio(self, tokens_row) -> float:
        """openai's zlib compression_ratio over one window's decoded text."""
        text_toks = [int(t) for t in tokens_row if int(t) < self.special.eot]
        if not text_toks:
            return 0.0
        raw = self.tokenizer.decode(text_toks).encode("utf-8")
        return round(len(raw) / max(len(zlib.compress(raw)), 1), 4) if raw else 0.0

    def _collect_slab(
        self, result, audio_states, n_real: int, first_slab: bool = False
    ) -> tuple[np.ndarray, dict]:
        """One slab's decode to host, through the retry ladder and the
        no-speech gate.  Returns (tokens, per-window meta)."""
        trace.count("transcribe.windows", n_real)
        with trace.span("transcribe.collect"):
            tokens = result.tokens.cpu().numpy()[:n_real].astype(np.int32)
            lengths0 = result.lengths.cpu().numpy()[:n_real]
            meta = {
                "avg_logprob": result.sum_logprob.cpu().numpy()[:n_real].astype(np.float64)
                / (lengths0 + 1),
                "no_speech_prob": result.no_speech_prob.cpu().numpy()[:n_real]
                .astype(np.float64),
                "temperature": np.full(n_real, self.temperature, np.float64),
            }
            if self.enable_fallback:
                # the initial prompt stays through the first window's retries
                # (openai's decode_with_fallback); the retry rows are in
                # ascending order, so that window is row 0 of the first batch
                def redecode(sub_states, part, temp, lo):
                    return self._run_decode(
                        sub_states, temp, seed=int(temp * 10),
                        first_row_prompt=bool(first_slab and lo == 0 and part[0] == 0),
                    )

                self._quality_retry(
                    result, tokens, n_real, audio_states, meta, redecode, "quality fallback"
                )
            # no-speech gate on the ACCEPTING decode's stats
            if self.no_speech_threshold is not None:
                silent = self._silent_rows(meta["no_speech_prob"], meta["avg_logprob"])
                tokens[silent] = self.special.eot
            meta["compression_ratio"] = np.asarray(
                [self._row_compression_ratio(r) for r in tokens], np.float64
            )
            return tokens, meta

    def _quality_retry(self, result, tokens, n_real, states, meta, redecode, label) -> None:
        """Compacted temperature-ladder retries (openai's
        decode_with_fallback), the one loop of the plain and the conditioned
        paths: only the failed rows re-decode, in the slabs of
        ``slab_plan`` at the retry cap, through
        ``redecode(sub_states, part, temp, lo)``; ``tokens``
        and ``meta`` update in place.  Beam rows retry by sampling, as
        openai's ladder does."""
        failed = self._failed_rows(result, tokens, n_real)
        for temp in self._ladder:
            if not failed.any():
                break
            idx = np.flatnonzero(failed)
            logger.info(
                "%s: %d/%d chunks re-decoding at T=%.1f", label, len(idx), n_real, temp,
            )
            failed[:] = False
            for lo, real, bucket in self._slab_plan(len(idx), self._retry_cap):
                part = idx[lo : lo + real]
                pad_idx = np.zeros(bucket, np.int64)
                pad_idx[: len(part)] = part
                sub_states = self._take_rows(states, pad_idx)
                retry = redecode(sub_states, part, temp, lo)
                retry_tokens = retry.tokens.cpu().numpy()[: len(part)].astype(np.int32)
                tokens[part] = retry_tokens
                r_len = retry.lengths.cpu().numpy()[: len(part)]
                meta["avg_logprob"][part] = (
                    retry.sum_logprob.cpu().numpy()[: len(part)] / (r_len + 1)
                )
                meta["no_speech_prob"][part] = retry.no_speech_prob.cpu().numpy()[: len(part)]
                meta["temperature"][part] = temp
                refailed = self._failed_rows(retry, retry_tokens, len(part))
                failed[part[refailed]] = True

    # -- seek-based window advance (boundary-straddle repair) ------------------

    def _apply_seek_repair(self, tokens: np.ndarray, n_chunks: int, audio):
        """Re-cut and re-decode boundary-straddling windows in one extra
        slab: each window whose decode trails unclosed text after its last
        closed timestamp pair gets a patch window starting there, whose
        segments replace window i's discarded tail and window i+1's
        overlapped head.  Mutates ``tokens``; returns (tokens, patches),
        patches None or {"tokens", "offsets", "durations", "meta"[,
        "states"]}: with word_timestamps the kept patches' encoder states
        ride along for the alignment pass."""
        if not self.seek_repair or self.without_timestamps or n_chunks < 1:
            return tokens, None
        content_s = len(audio) / 16_000.0
        bounds: list[tuple[int, float]] = []
        for i in range(n_chunks):
            consumed, rewound = decode_lib.seek_consumed(tokens[i], self.special)
            if not (rewound and 1.0 <= consumed <= 29.0):
                continue
            if i == n_chunks - 1 and i * 30.0 + consumed >= content_s - 0.2:
                continue  # final window: nothing left past the rewind point
            bounds.append((i, consumed))
        if not bounds:
            return tokens, None
        logger.info(
            "seek repair: %d/%d windows straddle a 30 s boundary", len(bounds), n_chunks,
        )
        patch_rows: list[np.ndarray] = []
        patch_metas: list[dict] = []
        patch_states: list[torch.Tensor] = []
        for lo, real, bucket in self._slab_plan(len(bounds)):
            batch = bounds[lo : lo + real]
            arr = np.zeros((bucket, CHUNK_SAMPLES), np.int16)
            for j, (i, c) in enumerate(batch):
                s0 = i * CHUNK_SAMPLES + int(round(c * 16_000))
                piece = audio[s0 : s0 + CHUNK_SAMPLES]
                arr[j, : len(piece)] = _f32_to_i16(piece)
            states = self._frontend_encode(
                torch.from_numpy(np.ascontiguousarray(self._local(arr))).to(self.device)
            )
            ptoks, pmeta = self._collect_slab(self._run_decode(states), states, len(batch))
            patch_rows.append(ptoks)
            patch_metas.append(pmeta)
            if self.word_timestamps:
                patch_states.append(self._all_rows(states)[: len(batch)])
        patch_tokens = np.concatenate(patch_rows, axis=0)
        patch_meta = {k: np.concatenate([m[k] for m in patch_metas]) for k in patch_metas[0]}

        kept_rows, kept_offsets, kept_durations, kept_idx = [], [], [], []
        for j, (i, c) in enumerate(bounds):
            offset = i * 30.0 + c
            # window i+1's start, patch-local; the final window has none
            boundary_local = 30.0 - c if i + 1 < n_chunks else 30.0
            row = patch_tokens[j]
            trimmed, last_end_local = decode_lib.keep_closed_segments_before(
                row, self.special, boundary_local
            )
            if last_end_local is None:
                if any(int(t) < self.special.eot for t in row):
                    # one long straddler: take the patch as-is
                    trimmed = np.asarray(row).copy()
                    last_end_local = min(30.0, max(content_s - offset, 0.02))
                else:
                    # patch gated to silence: drop window i's trailing text
                    tokens[i] = decode_lib.truncate_row_after_seek(tokens[i], self.special)
                    continue
            tokens[i] = decode_lib.truncate_row_after_seek(tokens[i], self.special)
            taken_end_global = offset + last_end_local
            next_start = (i + 1) * 30.0
            if i + 1 < n_chunks and taken_end_global > next_start + 0.1:
                tokens[i + 1] = decode_lib.drop_segments_before(
                    tokens[i + 1], self.special, taken_end_global - next_start
                )
            kept_rows.append(trimmed)
            kept_offsets.append(offset)
            kept_durations.append(min(30.0, max(content_s - offset, 0.02)))
            kept_idx.append(j)
        if not kept_rows:
            return tokens, None
        kept = np.asarray(kept_idx)
        patches = {
            "tokens": np.stack(kept_rows),
            "offsets": np.asarray(kept_offsets, np.float64),
            "durations": np.asarray(kept_durations, np.float64),
            "meta": {k: v[kept] for k, v in patch_meta.items()},
        }
        if self.word_timestamps:
            all_states = torch.cat(patch_states)
            patches["states"] = self._job_states(
                all_states[torch.from_numpy(kept).to(all_states.device)])
        return tokens, patches

    # -- language detection ------------------------------------------------------

    @staticmethod
    def _voting_k(n_chunks: int) -> int:
        """Leading chunks that vote on the language: the largest power of
        two <= min(n_chunks, 8)."""
        kk = max(1, min(n_chunks, 8))
        return 1 << (kk.bit_length() - 1)

    @staticmethod
    def _vote_language(audio: np.ndarray, ids: list[int], probs: np.ndarray) -> int:
        """Average the language distributions of the speech-bearing voter
        chunks and return the winning index."""
        rms = np.array(
            [
                float(np.sqrt(np.mean(np.square(
                    audio[ci * CHUNK_SAMPLES : (ci + 1) * CHUNK_SAMPLES],
                    dtype=np.float64,
                )) + 1e-12))
                for ci in ids
            ]
        )
        # -54 dBFS absolute floor AND within 20 dB of the loudest chunk
        voters = np.flatnonzero((rms >= 2e-3) & (rms >= 0.1 * rms.max()))
        if voters.size == 0:
            voters = np.array([int(rms.argmax())])
        return int(np.asarray(probs)[voters].mean(axis=0).argmax())

    def _detect_language_voting(self, audio: np.ndarray, audio_states, chunk_ids: list[int]) -> int:
        """Detect the language by voting over the first speech-bearing
        chunks rather than trusting chunk 0 alone.  ``audio_states``: this
        rank's rows of the slab; the k voter rows are gathered to every
        data rank."""
        with trace.span("transcribe.language"):
            k = self._voting_k(len(chunk_ids))
            # each data rank's first min(k, rows) rows, gathered: the slab's
            # first k rows lead the result whether they sit on one rank or
            # span several
            voters = self._all_rows(audio_states[: min(k, audio_states.shape[0])])[:k]
            _, probs = decode_lib.detect_language(self.params, self.cfg, voters, mesh=self.mesh)
            return self._vote_language(audio, chunk_ids[:k], probs.cpu().numpy())

    def _language_code(self) -> str | None:
        lang = self._active_language if self._active_language is not None else self.language
        if lang is None or not self.cfg.is_multilingual:
            return None
        langs = WHISPER_LANGUAGES_V3 if self.special.num_languages >= 100 else WHISPER_LANGUAGES
        return langs[lang] if 0 <= lang < len(langs) else None

    def detect_language(
        self, audio: "np.ndarray | str | os.PathLike", sample_rate: int = 16_000,
    ) -> dict:
        """openai's ``model.detect_language`` on the first 30 s: returns
        {"language": iso_code, "probabilities": {code: p, ...}} sorted by
        probability."""
        if not self.cfg.is_multilingual:
            raise ValueError(
                "detect_language requires a multilingual model "
                "(this config has no language tokens)"
            )
        # a path decodes only its first window
        audio, sample_rate = ingest.load_if_path(audio, sample_rate, max_s=30.0)
        audio = np.asarray(audio, np.float32)
        if sample_rate != 16_000:
            audio = frontend.resample_host(audio, sample_rate, device=self.device)
        states = self._frontend_encode(self._chunk_slab(audio, [0], self._round(1)))
        _, probs = decode_lib.detect_language(self.params, self.cfg, states, mesh=self.mesh)
        probs = self._all_rows(probs).cpu().numpy()[0]
        langs = WHISPER_LANGUAGES_V3 if self.special.num_languages >= 100 else WHISPER_LANGUAGES
        pairs = sorted(zip(langs[: len(probs)], probs.tolist()), key=lambda kv: -kv[1])
        return {"language": pairs[0][0], "probabilities": dict(pairs)}

    # -- conditioned (window-group) decoding --------------------------------------

    def _transcribe_conditioned(
        self, audio: np.ndarray, n_chunks: int, plan, progress=None, on_segment=None,
        time_map=None,
    ) -> tuple[np.ndarray, dict]:
        """Window-group conditioned decode (condition_on_previous_text).

        Round r decodes window r of EVERY group of condition_group_size
        consecutive windows in one batch, each prompted with <|startofprev|>
        + its group's text so far (openai's prompt).  It composes with beam
        search and with the retry ladder, whose rungs keep the prompt up to
        T=0.5 and drop it above (openai's prompt_reset_on_temperature).
        Returns (tokens (n_chunks, max_new_tokens), the encoder states in
        the slabs of ``plan`` (the grid's) when word_timestamps needs them
        (this data rank's rows of each, ``_job_states``), per-window meta)."""
        g_size = max(1, self.condition_group_size)
        n_groups = math.ceil(n_chunks / g_size)
        token_rows = np.full((n_chunks, self.max_new_tokens), self.special.eot, np.int32)
        chunk_meta = {
            "avg_logprob": np.zeros(n_chunks, np.float64),
            "no_speech_prob": np.zeros(n_chunks, np.float64),
            "compression_ratio": np.zeros(n_chunks, np.float64),
            "temperature": np.full(n_chunks, self.temperature, np.float64),
        }
        histories: list[list[int]] = [[] for _ in range(n_groups)]
        # the initial prompt seeds the first group's rolling context (openai
        # keeps it in all_tokens), except under carry_initial_prompt, where
        # _carry_hists prepends it to every prompt instead
        if not self.carry_initial_prompt:
            histories[0] = list(self._initial_prompt_tokens)
        max_ctx = self.condition_ctx_tokens
        if self.carry_initial_prompt:
            max_ctx = max(max_ctx, len(self._initial_prompt_tokens))
        # word_timestamps: rounds visit windows out of order, so each round's
        # states are kept and put back into window order at the end
        kept_states: list[tuple[list[int], torch.Tensor]] = []

        for r in range(g_size):
            chunk_ids = [g * g_size + r for g in range(n_groups) if g * g_size + r < n_chunks]
            if not chunk_ids:
                break
            for lo, real, bucket in self._slab_plan(len(chunk_ids)):
                ids = chunk_ids[lo : lo + real]
                trace.count("transcribe.slabs")
                states = self._frontend_encode(self._chunk_slab(audio, ids, bucket))
                if (
                    r == 0 and lo == 0 and self.auto_language and self.language is None
                    and self.cfg.is_multilingual
                ):
                    self._active_language = self._detect_language_voting(audio, states, ids)
                lang = self._active_language if self._active_language is not None else self.language
                sot_seq = self._sot_seq(lang)
                hists = [histories[ci // g_size] for ci in ids]

                def run_prompted(sub_states, sub_hists, temp, seed):
                    n_pad = sub_states.shape[0] * self._dp - len(sub_hists)
                    trace.count("decode.rows", sub_states.shape[0] * self._dp)
                    with trace.span("transcribe.decode"):
                        rows, lens = decode_lib.build_prompt_rows(
                            self._carry_hists(sub_hists) + [[]] * n_pad, sot_seq,
                            self.special, max_ctx,
                        )
                        return self._prompted_decode(sub_states, sot_seq, rows, lens, temp,
                                                     seed)

                base_hists = hists if self.temperature <= 0.5 else [[] for _ in hists]
                result = run_prompted(states, base_hists, self.temperature, 0)
                n_real = len(ids)
                trace.count("transcribe.windows", n_real)
                with trace.span("transcribe.collect"):
                    tokens = result.tokens.cpu().numpy()[:n_real].astype(np.int32)
                    lengths = result.lengths.cpu().numpy()[:n_real]
                    meta = {
                        "avg_logprob": result.sum_logprob.cpu().numpy()[:n_real]
                        / (lengths + 1),
                        "no_speech_prob": result.no_speech_prob.cpu().numpy()[:n_real]
                        .astype(np.float64),
                        "temperature": np.full(n_real, self.temperature, np.float64),
                    }
                    if self.enable_fallback:
                        def redecode(sub_states, part, temp, lo2):
                            sub_hists = [hists[i] if temp <= 0.5 else [] for i in part]
                            return run_prompted(sub_states, sub_hists, temp, int(temp * 10))

                        self._quality_retry(
                            result, tokens, n_real, states, meta, redecode,
                            "conditioned fallback",
                        )
                    if self.no_speech_threshold is not None:
                        silent = self._silent_rows(meta["no_speech_prob"],
                                                   meta["avg_logprob"])
                        tokens[silent] = self.special.eot
                for j, ci in enumerate(ids):
                    token_rows[ci] = tokens[j]
                    for key in ("avg_logprob", "no_speech_prob", "temperature"):
                        chunk_meta[key][ci] = meta[key][j]
                    chunk_meta["compression_ratio"][ci] = self._row_compression_ratio(tokens[j])
                    histories[ci // g_size].extend(
                        int(t) for t in tokens[j] if int(t) < self.special.eot
                    )
                if on_segment is not None:
                    self._emit_live_segments(
                        on_segment, tokens, np.asarray(ids, np.float64),
                        len(audio) / 16_000.0, time_map,
                    )
                if self.word_timestamps:
                    kept_states.append((ids, self._all_rows(states)[: len(ids)]))
            if progress:
                progress(0.1 + 0.8 * (r + 1) / g_size)
        states_per_slab: list[torch.Tensor] = []
        if kept_states:
            order = np.argsort(np.concatenate([np.asarray(ids) for ids, _ in kept_states]))
            all_states = torch.cat([st for _, st in kept_states])
            all_states = all_states[torch.from_numpy(order).to(all_states.device)]
            states_per_slab = [self._job_states(all_states[lo : lo + real])
                               for lo, real, _ in plan]
        return token_rows, states_per_slab, chunk_meta

    # -- main entry --------------------------------------------------------------

    def _emit_live_segments(self, on_segment, token_rows, window_idx, content_s, time_map) -> None:
        """Stream the given windows' segments to on_segment, in original-
        timeline stamps, as each slab's decode lands."""
        offs = np.asarray(window_idx, np.float64) * 30.0
        durs = np.clip(content_s - offs, 0.0, 30.0)
        for seg in decode_lib.tokens_to_segments(
            token_rows, self.special, offs, self.tokenizer.decode, chunk_durations_s=durs,
        ):
            on_segment({
                **seg,
                "start": round(time_map.to_original(seg["start"]), 3),
                "end": round(time_map.to_original(seg["end"]), 3),
            })

    def transcribe(
        self,
        audio: "np.ndarray | str | os.PathLike",
        *,
        sample_rate: int = 16_000,
        remove_silence: bool = True,
        clip_timestamps: list[tuple[float, float]] | None = None,
        time_map: TimeMap | None = None,
        progress: Callable[[float], None] | None = None,
        on_segment: Callable[[dict], None] | None = None,
    ) -> dict:
        """Full transcription of arbitrary-length mono audio at
        ``sample_rate`` (resampled to 16 kHz on the device) or a path.
        Returns {"text", "segments", "duration", "rtf_x", "trace"[,
        "language"]}, timestamps in the ORIGINAL timeline even when silence
        was removed or clips were selected.  "trace" is the call's
        ``runtime.trace`` summary: seconds of each stage span and the
        counters (windows, decode rows, decode steps)."""
        with trace.request() as record:
            with trace.span("transcribe"):
                out = self._transcribe(audio, sample_rate, remove_silence, clip_timestamps,
                                       time_map, progress, on_segment)
        out["trace"] = record.summary()
        return out

    def _transcribe(self, audio, sample_rate, remove_silence, clip_timestamps, time_map,
                    progress, on_segment) -> dict:
        t0 = time.perf_counter()
        with trace.span("transcribe.ingest"):
            audio, sample_rate = ingest.load_if_path(audio, sample_rate)
            audio = np.asarray(audio)
            self._active_language = None  # re-detected per call
            duration_s = len(audio) / sample_rate
            if sample_rate != 16_000:
                audio = frontend.resample_host(audio, sample_rate, device=self.device)

        if clip_timestamps and time_map is not None:
            raise ValueError(
                "clip_timestamps cannot be combined with an explicit time_map"
            )
        with trace.span("transcribe.trim"):
            if time_map is None:
                clip_map = None
                if clip_timestamps:
                    clips = []
                    for s, e in clip_timestamps:
                        s2 = min(max(0.0, float(s)), duration_s)
                        e2 = min(max(0.0, float(e)), duration_s)
                        if e2 > s2:
                            clips.append((s2, e2))
                    if not clips:
                        raise ValueError(
                            f"clip_timestamps {clip_timestamps!r} selects no audio "
                            f"within the {duration_s:.1f}s recording"
                        )
                    clip_map = TimeMap(clips)
                    audio = np.concatenate(
                        [audio[int(s * 16_000): int(e * 16_000)] for s, e in clips]
                    )
                if remove_silence and len(audio) > 2 * 16_000:
                    audio, intervals = frontend.trim_silence_host(audio)
                    if clip_map is not None:
                        intervals = timestamps_lib.compose_intervals(clip_map, intervals)
                    time_map = TimeMap(intervals)
                elif clip_map is not None:
                    time_map = clip_map
                else:
                    time_map = TimeMap.identity(duration_s)

        n_chunks = max(1, math.ceil(len(audio) / CHUNK_SAMPLES))
        plan = self._slab_plan(n_chunks)
        if self.condition_on_previous_text:
            tokens, cond_states, chunk_meta = self._transcribe_conditioned(
                audio, n_chunks, plan, progress, on_segment=on_segment, time_map=time_map,
            )
            with trace.span("transcribe.seek_repair"):
                tokens, patches = self._apply_seek_repair(tokens, n_chunks, audio)
            with trace.span("transcribe.segments"):
                return self._finalize(
                    tokens, n_chunks, duration_s, time_map, t0, progress,
                    states_per_slab=cond_states, plan=plan, audio=audio, patches=patches,
                    chunk_meta=chunk_meta,
                )
        content_s = len(audio) / 16_000.0
        token_rows: list[np.ndarray] = []
        meta_rows: list[dict] = []
        states_per_slab: list[torch.Tensor] = []  # kept only for word alignment
        for si, (lo, real, slab) in enumerate(plan):
            trace.count("transcribe.slabs")
            audio_states = self._frontend_encode(
                self._chunk_slab(audio, list(range(lo, lo + real)), slab)
            )
            if (
                si == 0
                and self.auto_language
                and self.language is None
                and self.cfg.is_multilingual
            ):
                self._active_language = self._detect_language_voting(
                    audio, audio_states, list(range(real))
                )
            toks, meta = self._collect_slab(
                self._run_decode(audio_states, first_row_prompt=si == 0), audio_states, real,
                first_slab=si == 0,
            )
            if self.word_timestamps:
                states_per_slab.append(audio_states)
            del audio_states
            token_rows.append(toks)
            meta_rows.append(meta)
            if on_segment is not None:
                self._emit_live_segments(
                    on_segment, toks, lo + np.arange(real, dtype=np.float64),
                    content_s, time_map,
                )
            if progress:
                progress(0.1 + 0.8 * (si + 1) / len(plan))

        tokens = np.concatenate(token_rows, axis=0)
        chunk_meta = {k: np.concatenate([m[k] for m in meta_rows]) for k in meta_rows[0]}
        with trace.span("transcribe.seek_repair"):
            tokens, patches = self._apply_seek_repair(tokens, n_chunks, audio)
        with trace.span("transcribe.segments"):
            return self._finalize(
                tokens, n_chunks, duration_s, time_map, t0, progress,
                states_per_slab=states_per_slab, plan=plan, audio=audio, patches=patches,
                chunk_meta=chunk_meta,
            )

    def _word_pass(self, states_per_slab, plan, tokens, offsets, durations, patches,
                   time_map) -> list[dict]:
        """Words of every grid window (its slab's states) and seek-repair
        patch, on the original timeline, sorted by time.  The teacher-forced
        rows carry the decode's sot sequence, and each window's map is
        cropped to its content frames (openai's find_alignment).

        Each job's states are this data rank's rows of the job's rows
        padded to the data axis (a slab's own layout): the rank aligns the
        real ones among them, which may be none on the last slab, and the
        (job, row, words) lists of every data rank are all-gathered, so
        every rank returns the same words in the one process's order."""
        from ..models.whisper import align

        lang = self._active_language if self._active_language is not None else self.language
        word_kw = dict(
            with_probabilities=True, language=self._language_code(),
            prepend_punctuations=self.prepend_punctuations,
            append_punctuations=self.append_punctuations, sot_sequence=self._sot_seq(lang),
            mesh=self.mesh,
        )
        # (states, token rows, offsets, durations) of each slab, then the patches
        jobs = []
        for states, (lo, real, _) in zip(states_per_slab, plan):
            rows = slice(lo, lo + real)
            jobs.append((states, tokens[rows], offsets[rows], durations[rows]))
        if patches is not None and "states" in patches:
            jobs.append(tuple(patches[k] for k in ("states", "tokens", "offsets", "durations")))
        mine = []
        for ji, (states, rows, offs, durs) in enumerate(jobs):
            lo = (0 if self.mesh is None else self.mesh.data_rank) * states.shape[0]
            k = max(0, min(states.shape[0], len(rows) - lo))
            if k == 0:
                continue  # this rank's rows are all padding
            mine.extend((ji, lo + j, w) for j, w in enumerate(align.word_timestamps(
                self.params, self.cfg, states[:k], rows[lo : lo + k], self.special,
                self.tokenizer.decode, offs[lo : lo + k],
                content_frames=np.ceil(durs[lo : lo + k] / align.AUDIO_FRAME_S), **word_kw,
            )))
        every = [t for part in mesh_lib.all_gather_object(mine, self.mesh) for t in part]
        per_chunk = [w for _, _, w in sorted(every, key=lambda t: t[:2])]
        words = [
            {**w, "start": round(time_map.to_original(w["start"]), 3),
             "end": round(time_map.to_original(w["end"]), 3)}
            for chunk_words in per_chunk for w in chunk_words
        ]
        words.sort(key=lambda w: (w["start"], w["end"]))
        return words

    def _finalize(
        self, tokens, n_chunks, duration_s, time_map, t0, progress,
        *, audio, states_per_slab=(), plan=(), patches=None, chunk_meta=None,
    ) -> dict:
        """Shared tail: tokens -> segments -> (words) -> result dict."""
        offsets = np.arange(n_chunks, dtype=np.float64) * 30.0
        # actual audio seconds per chunk bound unclosed trailing segments
        content_s = len(audio) / 16_000.0
        durations = np.clip(content_s - offsets, 0.0, 30.0)
        all_rows, all_offsets, all_durations = tokens, offsets, durations
        all_meta = chunk_meta
        if patches is not None:
            all_rows = np.concatenate([tokens[:n_chunks], patches["tokens"]])
            all_offsets = np.concatenate([offsets, patches["offsets"]])
            all_durations = np.concatenate([durations, patches["durations"]])
            if chunk_meta is not None:
                all_meta = {
                    k: np.concatenate([chunk_meta[k][:n_chunks], patches["meta"][k]])
                    for k in chunk_meta
                }
        row_meta = None
        if all_meta is not None:
            row_meta = [
                {
                    "temperature": float(all_meta["temperature"][i]),
                    "avg_logprob": float(all_meta["avg_logprob"][i]),
                    "compression_ratio": float(all_meta["compression_ratio"][i]),
                    "no_speech_prob": float(all_meta["no_speech_prob"][i]),
                }
                for i in range(len(all_rows))
            ]
        segments = decode_lib.tokens_to_segments(
            all_rows, self.special, all_offsets, self.tokenizer.decode,
            chunk_durations_s=all_durations, row_meta=row_meta,
        )
        segments.sort(key=lambda s: (s["start"], s["end"]))
        for seg in segments:
            seg["start"] = round(time_map.to_original(seg["start"]), 3)
            seg["end"] = round(time_map.to_original(seg["end"]), 3)
        words = None
        if self.word_timestamps:
            words = self._word_pass(states_per_slab, plan, tokens, offsets, durations,
                                    patches, time_map)
            if self.hallucination_silence_threshold is not None:
                segments, words = filter_hallucinations(
                    segments, words, self.hallucination_silence_threshold, duration_s,
                )
            # openai's segment["words"] (the subtitle writers' word modes read
            # it): each word joins the first segment holding its midpoint
            wi = 0
            for seg in segments:
                seg_words: list[dict] = []
                while wi < len(words):
                    mid = (words[wi]["start"] + words[wi]["end"]) / 2
                    if mid < seg["start"] - 0.05:
                        wi += 1  # before this segment: in the flat list only
                    elif mid <= seg["end"] + 0.05:
                        seg_words.append(words[wi])
                        wi += 1
                    else:
                        break
                seg["words"] = seg_words
        # openai's running segment id, on the final list
        for i, seg in enumerate(segments):
            seg["id"] = i
        elapsed = time.perf_counter() - t0
        if progress:
            progress(1.0)
        out = {
            "text": " ".join(s["text"] for s in segments),
            "segments": segments,
            "duration": duration_s,
            "rtf_x": duration_s / max(elapsed, 1e-9),
        }
        lang_code = self._language_code()
        if lang_code is not None:
            out["language"] = lang_code
        if words is not None:
            out["words"] = words
        return out

    # -- cross-request batched transcription ------------------------------------

    def _detect_languages_batch(
        self, audios: list[np.ndarray], n_chunks_per: list[int]
    ) -> tuple[list[int], dict[tuple[int, int], tuple[torch.Tensor, int]]]:
        """Per-file language detection for a batch of recordings in shared
        encode + detect slabs: the voter chunks and the voting rule of
        _detect_language_voting, one detect call per slab.

        Returns (languages, state_bank): state_bank maps (file, chunk) ->
        (this rank's rows of a slab's states, the chunk's row in the slab)
        for every voter chunk, so the decode can reuse those encoder rows
        (for 1-2 window clips the voter rows are the decode rows)."""
        with trace.span("transcribe.language"):
            rows: list[tuple[int, int]] = []
            spans: list[tuple[int, int]] = []  # (first row, k) per file
            for fi, n in enumerate(n_chunks_per):
                # the single-file path votes over its first decode slab
                k = self._voting_k(self._slab_plan(n)[0][1])
                spans.append((len(rows), k))
                rows += [(fi, ci) for ci in range(k)]
            prob_parts: list[np.ndarray] = []
            state_bank: dict[tuple[int, int], tuple[torch.Tensor, int]] = {}
            for lo, real, bucket in self._slab_plan(len(rows)):
                part = rows[lo : lo + real]
                padded = part + [part[-1]] * (bucket - len(part))
                states = self._frontend_encode(self._chunk_slab_pairs(audios, padded, bucket))
                _, probs = decode_lib.detect_language(self.params, self.cfg, states, mesh=self.mesh)
                prob_parts.append(self._all_rows(probs).cpu().numpy()[: len(part)])
                for j, pair in enumerate(part):
                    state_bank[pair] = (states, j)
            all_probs = np.concatenate(prob_parts, axis=0)
            return [
                self._vote_language(audios[fi], list(range(k)), all_probs[lo : lo + k])
                for fi, (lo, k) in enumerate(spans)
            ], state_bank

    @property
    def supports_shared_slabs(self) -> bool:
        """True when transcribe_batch packs several files into shared decode
        slabs.  False when an option needs per-file decode state inside the
        slab (rolling conditioning context, or a first-window-only
        initial_prompt): transcribe_batch then transcribes file by file
        (servers use this to skip coalescing such requests)."""
        return not (
            self.condition_on_previous_text
            or (bool(self._initial_prompt_tokens) and not self.carry_initial_prompt)
        )

    def _gather_state_rows(
        self,
        bank: dict[tuple[int, int], tuple[torch.Tensor, int]],
        pairs: list[tuple[int, int]],
        bucket: int,
    ) -> torch.Tensor:
        """This rank's rows of a (bucket, ...) encoder-states slab assembled
        from banked rows (the encoder is row-independent, so they equal a
        fresh encode), padded with the first row."""
        with trace.span("transcribe.slab_cut"):
            uniq: list[torch.Tensor] = []
            offsets: dict[int, int] = {}
            rows: list[int] = []
            for pair in pairs:
                src, r = bank[pair]
                if id(src) not in offsets:
                    offsets[id(src)] = sum(int(s.shape[0]) * self._dp for s in uniq)
                    uniq.append(src)
                rows.append(offsets[id(src)] + r)
            rows += [rows[0]] * (bucket - len(rows))
            whole = torch.cat([self._all_rows(s) for s in uniq], dim=0)
            return whole[torch.from_numpy(np.asarray(self._local(rows))).to(whole.device)]

    def transcribe_batch(
        self,
        audios: "list[np.ndarray | str | os.PathLike]",
        *,
        sample_rate: int = 16_000,
        remove_silence: bool = True,
        on_segment: Callable[[int, dict], None] | None = None,
    ) -> list[dict]:
        """Transcribe several independent recordings in shared decode slabs.

        Cross-request batching for many short files: the 30 s windows of
        every file pack into the slabs the single-file path uses, so N short
        uploads cost about one slab decode instead of N under-filled ones.
        Each file keeps its own silence-trim TimeMap, voted language, seek
        repair and finalize, and a window's decode depends only on its own
        audio, so each result is what transcribe() returns for that file
        (rtf_x is the file's share of the batch's wall time).  Files whose
        languages differ decode in per-language sub-batches.  on_segment is
        called as on_segment(file_index, segment) as each slab's decode
        lands.  Options that need per-file decode state inside a slab
        (supports_shared_slabs) fall back to one transcribe() per file.
        Each result's "trace" is the summary of the whole batch, or of its
        own transcribe() where the batch falls back to those.
        """
        with trace.request() as record:
            with trace.span("transcribe"):
                results = self._transcribe_batch(audios, sample_rate, remove_silence,
                                                 on_segment)
        for r in results:
            r.setdefault("trace", record.summary())
        return results

    def _transcribe_batch(self, audios, sample_rate, remove_silence, on_segment) -> list[dict]:
        t0 = time.perf_counter()
        if not audios:
            return []
        if not self.supports_shared_slabs:
            return [
                self.transcribe(
                    a, sample_rate=sample_rate, remove_silence=remove_silence,
                    on_segment=(
                        (lambda seg, fi=fi: on_segment(fi, seg))
                        if on_segment is not None else None
                    ),
                )
                for fi, a in enumerate(audios)
            ]

        # per-file preprocessing: the transcribe() head
        trimmed: list[np.ndarray] = []
        time_maps: list[TimeMap] = []
        durations_s: list[float] = []
        n_chunks_per: list[int] = []
        for audio in audios:
            with trace.span("transcribe.ingest"):
                audio, sr = ingest.load_if_path(audio, sample_rate)
                audio = np.asarray(audio, np.float32)
                duration_s = len(audio) / sr
                if sr != 16_000:
                    audio = frontend.resample_host(audio, sr, device=self.device)
            with trace.span("transcribe.trim"):
                if remove_silence and len(audio) > 2 * 16_000:
                    audio, intervals = frontend.trim_silence_host(audio)
                    time_map = TimeMap(intervals)
                else:
                    time_map = TimeMap.identity(duration_s)
            trimmed.append(audio)
            time_maps.append(time_map)
            durations_s.append(duration_s)
            n_chunks_per.append(max(1, math.ceil(len(audio) / CHUNK_SAMPLES)))

        state_bank: dict[tuple[int, int], tuple[torch.Tensor, int]] = {}
        langs: list[int | None] = [None] * len(trimmed)
        if self.auto_language and self.language is None and self.cfg.is_multilingual:
            langs, state_bank = self._detect_languages_batch(trimmed, n_chunks_per)

        # windows grouped by language (None: pinned or not multilingual;
        # _run_decode then takes self.language)
        pairs_by_lang: dict[int | None, list[tuple[int, int]]] = {}
        for fi, n in enumerate(n_chunks_per):
            pairs_by_lang.setdefault(langs[fi], []).extend((fi, ci) for ci in range(n))

        rows_by_file: list[list[np.ndarray | None]] = [[None] * n for n in n_chunks_per]
        meta_keys = ("avg_logprob", "no_speech_prob", "temperature", "compression_ratio")
        meta_by_file = [{k: np.zeros(n, np.float64) for k in meta_keys} for n in n_chunks_per]
        # word alignment needs each file's states in window order: the shared
        # slabs (every data rank's rows) are kept with their pairs and
        # gathered per file at the end
        kept_slab_states: list[tuple[torch.Tensor, list[tuple[int, int]]]] = []
        for lang, pairs in pairs_by_lang.items():
            self._active_language = lang
            for lo, real, slab in self._slab_plan(len(pairs)):
                batch_pairs = pairs[lo : lo + real]
                trace.count("transcribe.slabs")
                if state_bank and all(p in state_bank for p in batch_pairs):
                    # every row was encoded by the detection pass
                    audio_states = self._gather_state_rows(state_bank, batch_pairs, slab)
                else:
                    audio_states = self._frontend_encode(
                        self._chunk_slab_pairs(trimmed, batch_pairs, slab)
                    )
                toks, meta = self._collect_slab(
                    self._run_decode(audio_states), audio_states, len(batch_pairs),
                )
                if self.word_timestamps:
                    kept_slab_states.append((self._all_rows(audio_states), batch_pairs))
                del audio_states
                for j, (fi, ci) in enumerate(batch_pairs):
                    rows_by_file[fi][ci] = toks[j]
                    for k in meta_keys:
                        meta_by_file[fi][k][ci] = meta[k][j]
                if on_segment is not None:
                    by_file: dict[int, list[int]] = {}
                    for j, (fi, _) in enumerate(batch_pairs):
                        by_file.setdefault(fi, []).append(j)
                    for fi, js in by_file.items():
                        self._emit_live_segments(
                            lambda seg, fi=fi: on_segment(fi, seg), toks[js],
                            np.asarray([batch_pairs[j][1] for j in js], np.float64),
                            len(trimmed[fi]) / 16_000.0, time_maps[fi],
                        )

        # per-file tail: seek repair and finalize, as for a single file
        results: list[dict] = []
        for fi, rows in enumerate(rows_by_file):
            self._active_language = langs[fi]
            tokens = np.full(
                (len(rows), max(len(r) for r in rows)), self.special.eot, np.int32
            )
            for ci, r in enumerate(rows):
                tokens[ci, : len(r)] = r
            states_per_slab: list[torch.Tensor] = []
            if self.word_timestamps:
                # this file's rows of the kept slabs; its windows are in
                # order within a language group, so the parts sort by their
                # first window
                parts = []
                for states, batch_pairs in kept_slab_states:
                    idx = [j for j, (f, _) in enumerate(batch_pairs) if f == fi]
                    if idx:
                        sel = torch.tensor(idx, device=states.device)
                        parts.append((batch_pairs[idx[0]][1], states[sel]))
                parts.sort(key=lambda p: p[0])
                states_per_slab = [self._job_states(torch.cat([st for _, st in parts]))]
            with trace.span("transcribe.seek_repair"):
                tokens, patches = self._apply_seek_repair(tokens, n_chunks_per[fi],
                                                          trimmed[fi])
            with trace.span("transcribe.segments"):
                results.append(self._finalize(
                    tokens, n_chunks_per[fi], durations_s[fi], time_maps[fi], t0, None,
                    states_per_slab=states_per_slab,
                    plan=[(0, n_chunks_per[fi], n_chunks_per[fi])],
                    audio=trimmed[fi], patches=patches, chunk_meta=meta_by_file[fi],
                ))
        return results
