"""Committed-prefix incremental detokenization.

Counterpart of ``zero_transformer_tpu/serving/detok.py`` (a host module,
copied): ``decode_tokens`` decodes without clean-up passes, so a streamed
decode joins to exactly the one-shot decode, and ``StreamDecoder`` re-decodes
only the uncommitted tail each step (O(n) in all) and holds output back
while the tail is an incomplete multi-byte character. The one-shot CLI, the
REPL stream and the SSE server all detokenize through it.
"""
from __future__ import annotations

from typing import List, Optional


def decode_tokens(tokenizer, toks) -> str:
    """Detokenize without ``clean_up_tokenization_spaces`` (the clean-up
    rewrites across token boundaries, so a chunked decode would diverge
    from the whole-sequence one); falls back for tokenizers without the
    keyword."""
    try:
        return tokenizer.decode(toks, clean_up_tokenization_spaces=False)
    except TypeError:
        return tokenizer.decode(toks)


class StreamDecoder:
    """Feed token ids, get decoded text increments."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer
        self._pending: List[int] = []

    def decode(self, toks) -> str:
        return decode_tokens(self.tokenizer, toks)

    def push(self, token: int) -> Optional[str]:
        """Add one token; returns the next committed text piece, or None
        while the tail is an incomplete multi-byte character."""
        self._pending.append(token)
        text = self.decode(self._pending)
        if text.endswith("�"):
            return None
        self._pending = []
        return text

    def flush(self) -> Optional[str]:
        """Emit whatever is held back (an incomplete tail at the stream's
        end decodes with its replacement character)."""
        if not self._pending:
            return None
        text = self.decode(self._pending)
        self._pending = []
        return text
