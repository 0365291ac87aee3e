"""The tokenizer the DeepSeek-V2 cell runs with, an input the benchmark
hands to the program and to the reference alike.

DeepSeek-V2's byte-level BPE is not in the repository.  This stand-in
keeps the published vocabulary's layout: ids 0..255 are UTF-8 bytes, a
word (a run of letters with the space before it) is one id in
256..99,999 (CRC-32 of its bytes), and 100,000 and up are the special
tokens (BOS 100,000, EOS 100,001).  A word is one token, as most English
words are in the real vocabulary, so a transcript's token count follows
its word count; ids decode to distinct pseudo-words
(``portbench.tokenizer.word``).
"""
from __future__ import annotations

import re
import zlib

from .tokenizer import word

FIRST_SPECIAL = 100000
_WORD = re.compile(r" ?[A-Za-z]+")


class SynthTokenizer:
    """``first_special``: the lowest special id (BOS), which words stay below."""

    def __init__(self, first_special: int = FIRST_SPECIAL):
        self.first_special = first_special

    def encode(self, text: str) -> list[int]:
        out, pos = [], 0
        for m in _WORD.finditer(text):
            out += text[pos:m.start()].encode("utf-8")
            out.append(256 + zlib.crc32(m.group().encode()) % (self.first_special - 256))
            pos = m.end()
        return out + list(text[pos:].encode("utf-8"))

    def decode(self, ids) -> str:
        raw, parts = bytearray(), []
        for i in (int(x) for x in ids):
            if 0 <= i < 256:
                raw.append(i)
                continue
            if raw:
                parts.append(raw.decode("utf-8", errors="replace"))
                raw = bytearray()
            if i < self.first_special:
                parts.append(word(i))
        if raw:
            parts.append(raw.decode("utf-8", errors="replace"))
        return "".join(parts)
