"""Self-contained Whisper text tokenizer (byte-level BPE).

The reference gets tokenisation for free from openai-whisper; here it is
first-party so serving has no torch/tiktoken dependency.  Two loaders:

  * ``BPETokenizer.from_vocab_files(vocab.json, merges.txt)`` — HuggingFace
    GPT-2-style files shipped with every Whisper HF checkpoint.
  * ``BPETokenizer.from_tiktoken(path)`` — openai-whisper's
    ``multilingual.tiktoken`` / ``gpt2.tiktoken`` rank files
    (base64(token_bytes) <space> rank per line).

``ByteTokenizer`` is the zero-asset fallback used by tests and random-weight
benches (ids 0..255 are raw bytes).

A copy of the JAX package's ``models/whisper/tokenizer.py``: the port
imports nothing from that package.
"""
from __future__ import annotations

import base64
import functools
import json
import re
from typing import Iterable

# Whisper language registry, in lang-token order (token id = lang_begin + index).
WHISPER_LANGUAGES = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms "
    "cs ro da hu ta no th ur hr bg lt la mi ml cy sk te fa lv bn sr az sl kn "
    "et mk br eu is hy ne mn bs kk sq sw gl mr pa si km sn yo so af oc ka be "
    "tg sd gu am yi lo uz fo ht ps tk nn mt sa lb my bo tl mg as tt haw ln ha "
    "ba jw su"
).split()
WHISPER_LANGUAGES_V3 = WHISPER_LANGUAGES + ["yue"]

# ISO code -> English name (whisper's published language registry; the
# OpenAI transcription API's verbose_json reports the full name form).
LANGUAGE_NAMES = {
    "en": "english", "zh": "chinese", "de": "german", "es": "spanish",
    "ru": "russian", "ko": "korean", "fr": "french", "ja": "japanese",
    "pt": "portuguese", "tr": "turkish", "pl": "polish", "ca": "catalan",
    "nl": "dutch", "ar": "arabic", "sv": "swedish", "it": "italian",
    "id": "indonesian", "hi": "hindi", "fi": "finnish", "vi": "vietnamese",
    "he": "hebrew", "uk": "ukrainian", "el": "greek", "ms": "malay",
    "cs": "czech", "ro": "romanian", "da": "danish", "hu": "hungarian",
    "ta": "tamil", "no": "norwegian", "th": "thai", "ur": "urdu",
    "hr": "croatian", "bg": "bulgarian", "lt": "lithuanian", "la": "latin",
    "mi": "maori", "ml": "malayalam", "cy": "welsh", "sk": "slovak",
    "te": "telugu", "fa": "persian", "lv": "latvian", "bn": "bengali",
    "sr": "serbian", "az": "azerbaijani", "sl": "slovenian", "kn": "kannada",
    "et": "estonian", "mk": "macedonian", "br": "breton", "eu": "basque",
    "is": "icelandic", "hy": "armenian", "ne": "nepali", "mn": "mongolian",
    "bs": "bosnian", "kk": "kazakh", "sq": "albanian", "sw": "swahili",
    "gl": "galician", "mr": "marathi", "pa": "punjabi", "si": "sinhala",
    "km": "khmer", "sn": "shona", "yo": "yoruba", "so": "somali",
    "af": "afrikaans", "oc": "occitan", "ka": "georgian", "be": "belarusian",
    "tg": "tajik", "sd": "sindhi", "gu": "gujarati", "am": "amharic",
    "yi": "yiddish", "lo": "lao", "uz": "uzbek", "fo": "faroese",
    "ht": "haitian creole", "ps": "pashto", "tk": "turkmen",
    "nn": "nynorsk", "mt": "maltese", "sa": "sanskrit",
    "lb": "luxembourgish", "my": "myanmar", "bo": "tibetan",
    "tl": "tagalog", "mg": "malagasy", "as": "assamese", "tt": "tatar",
    "haw": "hawaiian", "ln": "lingala", "ha": "hausa", "ba": "bashkir",
    "jw": "javanese", "su": "sundanese", "yue": "cantonese",
}


def language_index(code: str, num_languages: int | None = 99) -> int:
    """Language token index for ``code``.

    num_languages=None means "model not loaded yet" (CLI flags / APTPU_*
    env parse before the checkpoint): the v3 table resolves every valid
    whisper code — the first 99 indices are identical in both registries,
    v3 merely appends "yue" at 99 — and Transcriber validates the index
    against the loaded model's actual language count, so 'yue' against a
    v2 checkpoint fails loudly at construction instead of silently
    becoming the translate token.  An explicit count keeps strict
    per-model validation (the /v1 endpoints pass the served model's).
    """
    langs = (
        WHISPER_LANGUAGES_V3
        if num_languages is None or num_languages >= 100
        else WHISPER_LANGUAGES
    )
    if code not in langs:
        raise ValueError(
            f"unsupported language {code!r} for this model "
            f"({len(langs)}-language registry)"
        )
    return langs.index(code)


@functools.lru_cache(maxsize=1)
def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode table."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


# GPT-2's pre-tokenization pattern — the one Whisper's tiktoken vocabs were
# trained with.  \p{L}/\p{N} need the `regex` module; the `re` fallback
# approximates them ([^\W\d_] ~ \p{L}, \d ~ \p{N}) for environments without
# it (close for all common text; exotic numerals may split differently).
_GPT2_PAT = r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
try:
    import regex as _regex

    _SPLIT_PATTERN = _regex.compile(_GPT2_PAT)
except ImportError:  # pragma: no cover - regex ships with transformers
    # the punctuation alternative must include "_" explicitly: "_" is a
    # \w word char (so [^\s\w] excludes it) AND excluded from the letter
    # class — with no alternative matching it, findall silently DELETED
    # underscores from the encoded text (snake_case prompts corrupted)
    _SPLIT_PATTERN = re.compile(
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?(?:[^\s\w]|_)+|\s+(?!\S)|\s+""",
        re.UNICODE,
    )


class BPETokenizer:
    """Byte-level BPE encoder/decoder (GPT-2 family, as Whisper uses).

    Two merge-priority modes:
      * HF mode (from_vocab_files): priority = index in merges.txt.
      * tiktoken mode (from_tiktoken): priority = the RANK OF THE MERGED
        TOKEN itself — exactly tiktoken's byte_pair_merge semantics, no
        merge-rule reconstruction involved.
    """

    def __init__(
        self,
        vocab: dict[str, int],
        merges: list[tuple[str, str]],
        result_rank_merge: bool = False,
    ):
        self.vocab = vocab
        self.inv_vocab = {v: k for k, v in vocab.items()}
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        self.result_rank_merge = result_rank_merge
        self.byte_enc = _bytes_to_unicode()
        self.byte_dec = {c: b for b, c in self.byte_enc.items()}
        self._cache: dict[str, list[str]] = {}

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_vocab_files(cls, vocab_path: str, merges_path: str) -> "BPETokenizer":
        with open(vocab_path, encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(merges_path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, _, b = line.partition(" ")
                merges.append((a, b))
        return cls(vocab, merges)

    @classmethod
    def from_tiktoken(cls, path: str) -> "BPETokenizer":
        """Build from an openai tiktoken rank file on disk."""
        with open(path, "rb") as f:
            return cls.from_tiktoken_bytes(f.read())

    @classmethod
    def from_tiktoken_bytes(cls, data: bytes) -> "BPETokenizer":
        """Build from tiktoken rank-file CONTENT (base64(token) <sp> rank
        per line).

        Ranks double as merge priorities: a token's merge is the split of its
        bytes into the two highest-priority sub-tokens, recovered greedily.
        This is also the canonical form checkpoints embed their vocab as
        (convert.save_params / load_tokenizer), so serving needs no separate
        tokenizer asset — matching the reference's one-call
        whisper.load_model which bundles weights + vocab
        (reference: app/services/audio_processor.py:863).
        """
        ranks: dict[bytes, int] = {}
        for line in data.splitlines():
            line = line.strip()
            if not line:
                continue
            tok_b64, rank = line.split()
            ranks[base64.b64decode(tok_b64)] = int(rank)
        byte_enc = _bytes_to_unicode()

        def to_unicode(bs: bytes) -> str:
            return "".join(byte_enc[b] for b in bs)

        vocab = {to_unicode(bs): r for bs, r in ranks.items()}
        # tiktoken mode: merge priority IS the merged token's rank — no
        # merge-rule reconstruction (which is heuristic and can drift from
        # the true training order) needed at all
        return cls(vocab, [], result_rank_merge=True)

    # -- serialisation ------------------------------------------------------

    def to_tiktoken_bytes(self) -> bytes:
        """Serialise the vocab as tiktoken rank-file content.

        Canonical interchange form for embedding the vocab inside converted
        .npz checkpoints.  HF added-special strings some vocab.json files
        carry are skipped — both forms: entries with characters outside
        the GPT-2 byte table, AND ASCII ``<|...|>`` markers (vocab.json's
        "<|endoftext|>" decodes cleanly through the byte table, but
        embedding it would alias a text entry onto the EOT special id) —
        special ids are derived from the model config
        (decode.SpecialTokens), never from the vocab.

        Note for HF-sourced vocabs: the round trip re-loads in tiktoken
        result-rank merge mode (priority = merged token's id).  For every
        Whisper vocab the ids ARE the training ranks, so this is exact; it
        is validated against the real tiktoken library in
        tests/test_parity_tokenizer.py.
        """
        decoded: list[tuple[bytes, int]] = []
        for tok, rank in sorted(self.vocab.items(), key=lambda kv: kv[1]):
            try:
                bs = bytes(self.byte_dec[c] for c in tok)
            except KeyError:
                continue  # added-special string, not a byte-level token
            decoded.append((bs, rank))
        # whisper appends its specials AFTER the text vocab, so only
        # marker-shaped entries ranked above every non-marker entry are
        # specials — a legitimate text token that happens to look like
        # '<|x|>' (custom fine-tuned vocabs) sits below and is kept
        is_marker = [
            bs.startswith(b"<|") and bs.endswith(b"|>") for bs, _ in decoded
        ]
        text_max = max(
            (r for (bs, r), m in zip(decoded, is_marker) if not m),
            default=-1,
        )
        lines = [
            base64.b64encode(bs) + b" " + str(rank).encode()
            for (bs, rank), m in zip(decoded, is_marker)
            if not (m and rank > text_max)
        ]
        return b"\n".join(lines) + b"\n"

    # -- core BPE -----------------------------------------------------------

    def _pair_rank(self, a: str, b: str) -> float:
        if self.result_rank_merge:
            return self.vocab.get(a + b, float("inf"))
        return self.ranks.get((a, b), float("inf"))

    def _bpe(self, token: str) -> list[str]:
        if token in self._cache:
            return self._cache[token]
        word = list(token)
        while len(word) > 1:
            # merge the LEFTMOST occurrence of the best-ranked pair, one at
            # a time — tiktoken's byte_pair_merge order (an all-occurrences
            # pass can diverge when a merge changes a neighbouring pair)
            best_i, best_rank = -1, float("inf")
            for i in range(len(word) - 1):
                r = self._pair_rank(word[i], word[i + 1])
                if r < best_rank:
                    best_i, best_rank = i, r
            if best_i < 0:
                break
            word[best_i : best_i + 2] = [word[best_i] + word[best_i + 1]]
        # bounded: a long-lived server tokenises arbitrary user text
        # (initial_prompt, conditioning histories) — an uncapped dict
        # grows monotonically for the process lifetime
        if len(self._cache) >= 65536:
            self._cache.clear()
        self._cache[token] = word
        return word

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for chunk in _SPLIT_PATTERN.findall(text):
            mapped = "".join(self.byte_enc[b] for b in chunk.encode("utf-8"))
            for piece in self._bpe(mapped):
                if piece in self.vocab:
                    ids.append(self.vocab[piece])
                else:  # unknown merge result: fall back to single chars
                    ids.extend(self.vocab[c] for c in piece if c in self.vocab)
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        chars = "".join(self.inv_vocab.get(int(i), "") for i in ids)
        data = bytes(self.byte_dec[c] for c in chars if c in self.byte_dec)
        return data.decode("utf-8", errors="replace")


def load_tokenizer_file(path: str) -> BPETokenizer:
    """Load a tokenizer asset by path, auto-detecting the format.

    ``*.json`` is treated as a HF ``vocab.json`` (with ``merges.txt`` beside
    it); anything else as an openai tiktoken rank file.  This is what the
    ``APTPU_TOKENIZER_PATH`` env override and the CLI ``--tokenizer`` flags
    resolve through.
    """
    import os

    if path.endswith(".json"):
        import json as _json

        with open(path, encoding="utf-8") as f:
            data = _json.load(f)
        if isinstance(data, dict) and "model" in data:
            # HF tokenizer.json (the file checkpoint repos ship most
            # prominently): vocab + merges live under data["model"] —
            # previously this crashed deep in the constructor with an
            # unhashable-type TypeError
            model = data["model"]
            vocab = model.get("vocab")
            merges_raw = model.get("merges")
            if not isinstance(vocab, dict) or merges_raw is None:
                raise ValueError(
                    f"{path} is a tokenizer.json without model.vocab/"
                    "model.merges; pass vocab.json + merges.txt instead"
                )
            merges = [
                tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
                for m in merges_raw
            ]
            return BPETokenizer(vocab, merges)
        if not isinstance(data, dict) or not all(
            isinstance(v, int) for v in data.values()
        ):
            raise ValueError(
                f"{path} is not a vocab.json (token -> id map) or a "
                "tokenizer.json; unsupported JSON tokenizer format"
            )
        merges_path = os.path.join(os.path.dirname(path), "merges.txt")
        if not os.path.exists(merges_path):
            raise FileNotFoundError(
                f"{path} looks like a HF vocab.json but no merges.txt "
                f"found beside it ({merges_path})"
            )
        return BPETokenizer.from_vocab_files(path, merges_path)
    return BPETokenizer.from_tiktoken(path)


class ByteTokenizer:
    """Zero-asset tokenizer: ids 0..255 are raw bytes (tests/benches only)."""

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Iterable[int]) -> str:
        return bytes(i for i in (int(x) for x in ids) if 0 <= i < 256).decode(
            "utf-8", errors="replace"
        )
