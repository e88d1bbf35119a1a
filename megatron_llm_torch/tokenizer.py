"""Tokenizers of the PyTorch port.

Only the JAX package's ``NullTokenizer`` (whitespace-separated integer
ids, ``megatron_llm_tpu/tokenizer/tokenizer.py``) is ported: the
vocabulary-file tokenizers wait until a vocabulary is in the repo.
"""

from __future__ import annotations


class NullTokenizer:
    """Whitespace-int tokenizer; ``vocab_size`` ids plus an eod id."""

    def __init__(self, vocab_size: int):
        self._n = int(vocab_size)

    @property
    def vocab_size(self) -> int:
        return self._n + 1  # + eod

    def tokenize(self, text):
        return [int(t) for t in text.split()]

    def detokenize(self, ids):
        return " ".join(str(i) for i in ids)

    @property
    def eod(self) -> int:
        return self._n

    @property
    def pad(self) -> int:
        return self._n


def build_tokenizer(tokenizer_type: str, vocab_size: int):
    if tokenizer_type != "NullTokenizer":
        raise NotImplementedError(
            f"tokenizer {tokenizer_type!r} is not ported yet (only "
            f"NullTokenizer needs no vocabulary file)")
    if not vocab_size:
        raise ValueError("NullTokenizer needs --vocab_size")
    return NullTokenizer(vocab_size)
