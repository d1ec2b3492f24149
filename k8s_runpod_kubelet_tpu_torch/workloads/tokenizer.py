"""Byte tokenizer for the serving front (a copy of the JAX package's
``workloads/tokenizer.py:ByteTokenizer``, cut to what ``/generate``
uses): UTF-8 bytes as token ids, dependency-free, for random-weight
models whose vocab holds >= 257 ids."""

from __future__ import annotations


class ByteTokenizer:
    """UTF-8 bytes as token ids (0..255); id 256 = EOS."""

    vocab_size = 257

    @property
    def eos_id(self) -> int:
        return 256

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, tokens: list[int]) -> str:
        return bytes(t for t in tokens if 0 <= t < 256).decode(
            "utf-8", errors="replace")
