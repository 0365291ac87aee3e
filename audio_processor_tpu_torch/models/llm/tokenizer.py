"""A byte-level stand-in for DeepSeek-V2's tokenizer.

The published tokenizer (a byte-level BPE of 100,000 merges plus special
tokens) is not in the repository, so the port encodes UTF-8 bytes as ids
0..255 and decodes those ids back, dropping every other id.  The model's
BOS and EOS ids come from its config (100000 and 100001 for DeepSeek-V2),
not from here.  Text round-trips, at about four times the token count of
the real vocabulary; generated ids outside the byte range decode to
nothing.
"""
from __future__ import annotations


class ByteTokenizer:
    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids) -> str:
        return bytes(i for i in (int(x) for x in ids) if 0 <= i < 256).decode(
            "utf-8", errors="replace")
