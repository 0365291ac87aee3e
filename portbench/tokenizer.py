"""The tokenizer the configurations run with, an input the benchmark
hands to the program and to the reference alike.

No Whisper vocabulary ships in the repository (its BPE ranks are a
download).  This one keeps the vocabulary's published size and layout:
ids 0..255 encode and decode as UTF-8 bytes, as the program's byte
tokenizer does, and every other text id below EOT decodes to a word with
a leading space, as most GPT-2 tokens do.  So every segment a decode
closes carries text, as it does with a real vocabulary, and the
program's text, compression-ratio and segment work is done on it.
"""
from __future__ import annotations

FIRST_WORD_ID = 256


def word(i: int) -> str:
    """A pronounceable word for text id i >= 256, distinct for each id."""
    cons, vow = "bcdfghjklmnprstvz", "aeiou"
    out, n = [], i - FIRST_WORD_ID
    while True:
        out.append(cons[n % len(cons)] + vow[(n // len(cons)) % len(vow)])
        n //= len(cons) * len(vow)
        if n == 0:
            return " " + "".join(out)


class WordTokenizer:
    def __init__(self, eot: int):
        self.eot = eot

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids) -> str:
        raw, parts = bytearray(), []
        for i in (int(x) for x in ids):
            if 0 <= i < FIRST_WORD_ID:
                raw.append(i)
                continue
            if raw:
                parts.append(raw.decode("utf-8", errors="replace"))
                raw = bytearray()
            if FIRST_WORD_ID <= i < self.eot:
                parts.append(word(i))
        if raw:
            parts.append(raw.decode("utf-8", errors="replace"))
        return "".join(parts)
