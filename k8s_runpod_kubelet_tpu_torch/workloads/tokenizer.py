"""Tokenizers for the serving front (a copy of the JAX package's
``workloads/tokenizer.py``): text in, text out. The engine speaks token
ids; these adapt the HTTP surface.

- ``ByteTokenizer``: dependency-free UTF-8 bytes as token ids, for any
  model whose vocab holds >= 257 ids (random-weight models, tests).
- ``HfTokenizer``: a Hugging Face tokenizer directory
  (``transformers.AutoTokenizer``, imported in the constructor only), to
  pair with ``--hf-checkpoint``.

``get_tokenizer("bytes")`` or ``get_tokenizer("/path/to/hf_dir")``.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["ByteTokenizer", "HfTokenizer", "get_tokenizer"]


def _chat_fallback_text(messages: list[dict]) -> str:
    """The minimal chat template: "role: content" lines and an assistant
    cue, wherever no model-native template exists."""
    return "".join(f"{m['role']}: {m['content']}\n" for m in messages) \
        + "assistant:"


class ByteTokenizer:
    """UTF-8 bytes as token ids (0..255); id 256 = EOS."""

    vocab_size = 257
    # token-level stop matching is already text-exact: every string has
    # exactly one tokenization, so no decoded-text stop is needed
    byte_exact = True

    @property
    def eos_id(self) -> int:
        return 256

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def encode_plain(self, text: str) -> list[int]:
        """No special tokens: for stop-sequence matching."""
        return self.encode(text)

    def decode(self, tokens: list[int]) -> str:
        return bytes(t for t in tokens if 0 <= t < 256).decode(
            "utf-8", errors="replace")

    def apply_chat(self, messages: list[dict]) -> list[int]:
        return self.encode(_chat_fallback_text(messages))


class HfTokenizer:
    # BPE: one string, many tokenizations; a stop string can straddle a
    # token boundary, so text-exact stops need the decoded-text path
    byte_exact = False

    def __init__(self, path: str):
        # imported here, not at module import: where flax is installed,
        # transformers can pull in jax
        from transformers import AutoTokenizer
        # a local directory only: never a download
        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)

    @property
    def eos_id(self) -> int:
        eos = self._tok.eos_token_id
        return eos if eos is not None else -1

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text)

    def encode_plain(self, text: str) -> list[int]:
        """No BOS/EOS: a stop sequence with a BOS prepended could never
        match a generated tail."""
        return self._tok.encode(text, add_special_tokens=False)

    def decode(self, tokens: list[int]) -> str:
        return self._tok.decode(tokens, skip_special_tokens=True)

    def apply_chat(self, messages: list[dict]) -> list[int]:
        """The model's own chat template when the tokenizer ships one,
        else the role-prefix fallback."""
        if getattr(self._tok, "chat_template", None):
            return self._tok.apply_chat_template(messages,
                                                 add_generation_prompt=True)
        return self._tok.encode(_chat_fallback_text(messages))


def get_tokenizer(spec: Optional[str]):
    """None/"" -> None (token-ids-only API); "bytes" -> ByteTokenizer;
    anything else -> a Hugging Face tokenizer directory."""
    if not spec:
        return None
    if spec == "bytes":
        return ByteTokenizer()
    return HfTokenizer(spec)
