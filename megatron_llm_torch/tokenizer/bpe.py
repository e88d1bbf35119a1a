r"""Self-contained GPT-2 byte-level BPE (no ``transformers`` dependency; a
copy of ``megatron_llm_tpu/tokenizer/bpe.py``).

The reference embeds the original OpenAI GPT-2 encoder
(``megatron/tokenizer/gpt2_tokenization.py``); this module is the
fallback backend for ``_GPT2BPETokenizer`` when the ``transformers``
fast tokenizers are unavailable.  The byte-to-unicode table, split
pattern, and merge procedure are the published GPT-2 BPE algorithm;
parity with ``GPT2TokenizerFast`` and with the JAX package's copy is
asserted in ``tests/test_torch_tokenizer.py``.
"""

from __future__ import annotations

import functools
import itertools
import json
import os
from typing import Dict, List, Tuple

try:
    import regex as _re  # the GPT-2 pattern needs \p{L}/\p{N}
except ImportError:  # pragma: no cover - regex ships in the image
    _re = None

_PAT = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"
        r" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode map (GPT-2's trick to make
    arbitrary bytes regex-safe)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class StandaloneGPT2BPE:
    """Drop-in for the parts of ``GPT2TokenizerFast`` the framework uses:
    encode, decode, vocab, ``convert_tokens_to_ids``."""

    def __init__(self, vocab_file: str, merges_file: str):
        if _re is None:
            raise ImportError(
                "standalone GPT-2 BPE needs the 'regex' module")
        with open(vocab_file, encoding="utf-8") as f:
            self._vocab: Dict[str, int] = json.load(f)
        self._inv = {i: t for t, i in self._vocab.items()}
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(l.split()) for l in lines
                  if l and not l.startswith("#version") and len(l.split()) == 2]
        self._ranks = {m: i for i, m in enumerate(merges)}
        self._b2u = bytes_to_unicode()
        self._u2b = {u: b for b, u in self._b2u.items()}
        self._pat = _re.compile(_PAT)
        self._cache: Dict[str, List[str]] = {}
        # added special tokens are matched atomically in encode
        self._specials = {"<|endoftext|>"} & set(self._vocab)
        self.additional_special_tokens_ids: List[int] = []

    def __len__(self):
        return len(self._vocab)

    def get_vocab(self):
        return dict(self._vocab)

    def convert_tokens_to_ids(self, token: str) -> int:
        return self._vocab[token]

    def add_special_tokens(self, mapping: dict) -> int:
        """HF-compatible subset: named keys and the
        'additional_special_tokens' list; new tokens get fresh ids and
        are matched atomically by encode."""
        added = 0

        def add(tok: str) -> int:
            nonlocal added
            if tok not in self._vocab:
                idx = max(self._inv, default=-1) + 1
                self._vocab[tok] = idx
                self._inv[idx] = tok
                added += 1
            self._specials.add(tok)
            return self._vocab[tok]

        for key, val in mapping.items():
            if key == "additional_special_tokens":
                self.additional_special_tokens_ids = [add(t) for t in val]
            else:
                setattr(self, f"{key}_id", add(val))
        return added

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word: Tuple[str, ...] = tuple(token)
        pairs = _get_pairs(word)
        while pairs:
            best = min(pairs, key=lambda p: self._ranks.get(p, 1 << 30))
            if best not in self._ranks:
                break
            a, b = best
            new: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(a, i)
                except ValueError:
                    new.extend(word[i:])
                    break
                new.extend(word[i:j])
                if j < len(word) - 1 and word[j + 1] == b:
                    new.append(a + b)
                    i = j + 2
                else:
                    new.append(word[j])
                    i = j + 1
            word = tuple(new)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = list(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        import re as _stdre

        ids: List[int] = []
        if self._specials:
            pat = "(" + "|".join(
                _stdre.escape(t) for t in sorted(self._specials, key=len,
                                                 reverse=True)) + ")"
            chunks = _stdre.split(pat, text)
        else:
            chunks = [text]
        for chunk in chunks:
            if chunk in self._specials:
                ids.append(self._vocab[chunk])
                continue
            for tok in self._pat.findall(chunk):
                mapped = "".join(self._b2u[b] for b in tok.encode("utf-8"))
                ids.extend(self._vocab[p] for p in self._bpe(mapped))
        return ids

    def decode(self, ids) -> str:
        text = "".join(self._inv.get(int(i), "") for i in ids)
        data = bytes(self._u2b[u] for u in text if u in self._u2b)
        return data.decode("utf-8", errors="replace")


def write_byte_bpe_vocab(out_dir: str, vocab_size: int) -> Tuple[str, str]:
    """GPT-2 byte-level BPE files of exactly ``vocab_size`` ids, written
    into ``out_dir``: the 256 byte symbols, then the first ``vocab_size -
    257`` pairs of them (in the byte table's order) as merges, and
    ``<|endoftext|>`` last.  Every id decodes, so a model with random
    weights may emit any of them.  Returns the paths of vocab.json and
    merges.txt."""
    base = list(bytes_to_unicode().values())
    merges = list(itertools.islice(((a, b) for a in base for b in base),
                                   vocab_size - len(base) - 1))
    tokens = base + [a + b for a, b in merges] + ["<|endoftext|>"]
    vf = os.path.join(out_dir, "vocab.json")
    mf = os.path.join(out_dir, "merges.txt")
    with open(vf, "w", encoding="utf-8") as f:
        json.dump({t: i for i, t in enumerate(tokens)}, f)
    with open(mf, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n"
                + "\n".join(f"{a} {b}" for a, b in merges) + "\n")
    return vf, mf
