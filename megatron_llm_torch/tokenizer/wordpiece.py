"""Self-contained WordPiece tokenizer (no ``transformers`` dependency; a
copy of ``megatron_llm_tpu/tokenizer/wordpiece.py``).

The reference embeds the original Google BERT tokenization stack
(``megatron/tokenizer/bert_tokenization.py``: BasicTokenizer +
WordpieceTokenizer).  This module provides the same behavior as a
fallback backend for ``_BertWordPieceTokenizer`` when the
``transformers`` fast tokenizers are unavailable — the framework stays
fully standalone.  The algorithm (whitespace/punctuation basic split
with lowercase + accent stripping + CJK spacing, then greedy
longest-match-first sub-word segmentation with ``##`` continuations) is
the published BERT tokenization; parity with ``BertTokenizerFast`` is
asserted in ``tests/test_tokenizer_standalone.py`` (and the port's copy
against the JAX package's in ``tests/test_torch_tokenizer.py``).
"""

from __future__ import annotations

import unicodedata
from typing import Dict, List


def load_vocab(vocab_file: str) -> Dict[str, int]:
    vocab: Dict[str, int] = {}
    with open(vocab_file, encoding="utf-8") as f:
        for i, line in enumerate(f):
            tok = line.rstrip("\n")
            if tok:
                vocab[tok] = i
    return vocab


def _is_whitespace(ch: str) -> bool:
    return ch in (" ", "\t", "\n", "\r") or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII non-alphanumeric ranges count as punctuation (matches BERT:
    # treats characters like '$' and '@' as splittable even though
    # unicode classes them as symbols)
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


class BasicTokenizer:
    """Whitespace/punctuation splitting with cleanup (BERT basic step)."""

    def __init__(self, lower_case: bool = True):
        self.lower_case = lower_case

    def tokenize(self, text: str) -> List[str]:
        # cleanup: drop control chars / NUL / replacement, normalize ws
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        text = "".join(out)
        # CJK characters tokenize one-per-character
        text = "".join(
            f" {ch} " if _is_cjk(ord(ch)) else ch for ch in text)

        tokens: List[str] = []
        for word in text.split():
            if self.lower_case:
                word = word.lower()
                # strip accents (NFD then drop combining marks)
                word = "".join(
                    c for c in unicodedata.normalize("NFD", word)
                    if unicodedata.category(c) != "Mn")
            # split on punctuation, keeping each punct char as a token
            cur: List[str] = []
            for ch in word:
                if _is_punctuation(ch):
                    if cur:
                        tokens.append("".join(cur))
                        cur = []
                    tokens.append(ch)
                else:
                    cur.append(ch)
            if cur:
                tokens.append("".join(cur))
        return tokens


class WordpieceTokenizer:
    """Greedy longest-match-first sub-word segmentation."""

    def __init__(self, vocab: Dict[str, int], unk_token: str = "[UNK]",
                 max_chars_per_word: int = 200):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_chars_per_word = max_chars_per_word

    def tokenize(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces


class StandaloneWordPiece:
    """Drop-in for the parts of ``BertTokenizerFast`` the framework uses:
    encode without special tokens, decode, vocab, special-token ids, and
    ``add_special_tokens`` growing the vocab."""

    def __init__(self, vocab_file: str, do_lower_case: bool = True):
        self._vocab = load_vocab(vocab_file)
        self._inv = {i: t for t, i in self._vocab.items()}
        self._basic = BasicTokenizer(do_lower_case)
        self._wp = WordpieceTokenizer(self._vocab)
        self.cls_token_id = self._vocab.get("[CLS]")
        self.sep_token_id = self._vocab.get("[SEP]")
        self.pad_token_id = self._vocab.get("[PAD]")
        self.mask_token_id = self._vocab.get("[MASK]")
        self.unk_token_id = self._vocab.get("[UNK]")
        self.bos_token_id = None
        self.eos_token_id = None
        self.additional_special_tokens_ids: List[int] = []
        # special tokens are matched atomically in encode (HF behavior:
        # never split even with add_special_tokens=False)
        self._specials = {t for t in ("[CLS]", "[SEP]", "[PAD]", "[MASK]",
                                      "[UNK]") if t in self._vocab}

    # -- vocab ----------------------------------------------------------
    def __len__(self):
        return len(self._vocab)

    def get_vocab(self):
        return dict(self._vocab)

    def _add_token(self, tok: str) -> int:
        if tok in self._vocab:
            self._specials.add(tok)
            return self._vocab[tok]
        # max existing id + 1, NOT len(vocab): blank/duplicate vocab
        # lines make the two differ and len() would collide
        idx = max(self._inv, default=-1) + 1
        self._vocab[tok] = idx
        self._inv[idx] = tok
        self._specials.add(tok)
        return idx

    def add_special_tokens(self, mapping: dict):
        for key, val in mapping.items():
            if key == "additional_special_tokens":
                self.additional_special_tokens_ids = [
                    self._add_token(t) for t in val]
            else:
                setattr(self, f"{key}_id", self._add_token(val))

    # -- encode / decode ------------------------------------------------
    def encode(self, text: str, add_special_tokens: bool = False):
        import re

        ids: List[int] = []
        unk = self.unk_token_id
        # split out special tokens first so they encode atomically
        if self._specials:
            pat = "(" + "|".join(
                re.escape(t) for t in sorted(self._specials, key=len,
                                             reverse=True)) + ")"
            chunks = re.split(pat, text)
        else:
            chunks = [text]
        for chunk in chunks:
            if chunk in self._specials:
                ids.append(self._vocab[chunk])
                continue
            for word in self._basic.tokenize(chunk):
                for piece in self._wp.tokenize(word):
                    ids.append(self._vocab.get(piece, unk))
        if add_special_tokens:
            ids = [self.cls_token_id] + ids + [self.sep_token_id]
        return ids

    def decode(self, ids) -> str:
        toks = [self._inv.get(int(i), "[UNK]") for i in ids]
        out: List[str] = []
        for t in toks:
            if t.startswith("##") and out:
                out[-1] = out[-1] + t[2:]
            else:
                out.append(t)
        return " ".join(out)
