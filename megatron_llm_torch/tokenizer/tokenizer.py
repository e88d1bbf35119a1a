"""Tokenizer zoo + vocab padding (a copy of
``megatron_llm_tpu/tokenizer/tokenizer.py`` with its imports changed).

Reference: ``megatron/tokenizer/tokenizer.py`` — ``build_tokenizer`` (:12-63)
with vocab padding to ``make_vocab_size_divisible_by x tp_size``;
``_BertWordPieceTokenizer`` (:123), ``_GPT2BPETokenizer`` (:254),
``_FalconTokenizer`` (:288), ``_SentencePieceTokenizer`` (:326, llama/
mistral with special-token handling and ``--no_new_tokens``).

Tokenization is pure host-side: the implementations wrap the
``transformers``/``tokenizers`` fast backends when they import, and
otherwise fall back to the self-contained WordPiece / byte-BPE
implementations in ``tokenizer/wordpiece.py`` and ``tokenizer/bpe.py``.
``sentencepiece`` is optional — the SentencePiece path degrades to a
clear error (or the HF fast tokenizer for the same model when given a
directory).  The port's one other change: where a ``transformers`` fast
tokenizer does not read the vocabulary file (its 5.x constructors take
the vocabulary itself), the standalone backend is used as if
``transformers`` were missing.  A parser without
``--tensor_model_parallel_size`` (the server's) pads as for one device.
"""

from __future__ import annotations

import json
from abc import ABC, abstractmethod
from typing import List, Optional


def build_tokenizer(args):
    """args needs: tokenizer_type, vocab_file/merges_file/tokenizer_path
    (per type), make_vocab_size_divisible_by, tensor_model_parallel_size,
    optional vocab_extra_ids / new_tokens."""
    t = args.tokenizer_type
    if t == "GPT2BPETokenizer":
        tokenizer = _GPT2BPETokenizer(args.vocab_file, args.merge_file)
    elif t in ("BertWordPieceLowerCase", "BertWordPieceCase"):
        tokenizer = _BertWordPieceTokenizer(
            args.vocab_file, lower_case=(t == "BertWordPieceLowerCase"),
            vocab_extra_ids=getattr(args, "vocab_extra_ids", 0),
        )
    elif t == "SentencePieceTokenizer":
        # reference flag is --tokenizer_model (the .model file); accept
        # --vocab_file as a fallback spelling
        tokenizer = _SentencePieceTokenizer(
            getattr(args, "tokenizer_model", None) or args.vocab_file,
            vocab_extra_ids=getattr(args, "vocab_extra_ids", 0),
            new_tokens=getattr(args, "new_tokens", True),
        )
    elif t == "FalconTokenizer":
        tokenizer = _FalconTokenizer(getattr(args, "tokenizer_path", None))
    elif t == "HFAutoTokenizer":
        tokenizer = _HFAutoTokenizer(args.tokenizer_path)
    elif t == "NullTokenizer":
        tokenizer = _NullTokenizer(args.vocab_size)
    else:
        raise NotImplementedError(f"tokenizer type {t!r}")

    extra_list = getattr(args, "vocab_extra_ids_list", None)
    if extra_list:
        # reference --vocab_extra_ids_list: literal tokens appended as
        # additional special tokens (HF-backed tokenizers only)
        tokens = [s for s in extra_list.split(",") if s]
        hf = getattr(tokenizer, "_tok", None) or getattr(
            tokenizer, "_sp", None)
        if hf is not None and hasattr(hf, "add_special_tokens"):
            hf.add_special_tokens({"additional_special_tokens": tokens})
            tokenizer._inv_vocab_cache = None
        else:
            raise NotImplementedError(
                f"--vocab_extra_ids_list is not supported for "
                f"tokenizer type {t!r}")

    args.padded_vocab_size = _vocab_size_with_padding(tokenizer.vocab_size, args)
    return tokenizer


def _vocab_size_with_padding(orig_vocab_size: int, args) -> int:
    """Pad to make_vocab_size_divisible_by x tp (reference: tokenizer.py:46-63)."""
    after = orig_vocab_size
    multiple = (args.make_vocab_size_divisible_by
                * getattr(args, "tensor_model_parallel_size", 1))
    while after % multiple != 0:
        after += 1
    if getattr(args, "rank", 0) == 0 and after != orig_vocab_size:
        print(f" > padded vocab (size: {orig_vocab_size}) with "
              f"{after - orig_vocab_size} dummy tokens "
              f"(new size: {after})", flush=True)
    # re-fire the fused-CE policy now that the tokenizer-derived vocab
    # is known (validate_args ran before the tokenizer was built); the
    # guard keeps parsers without the policy's flags (the server's) out
    if getattr(args, "fused_ce_user_explicit", None) is not None:
        from megatron_llm_torch.arguments import apply_fused_ce_policy
        apply_fused_ce_policy(args, vocab=after)
    return after


class AbstractTokenizer(ABC):
    @property
    @abstractmethod
    def vocab_size(self) -> int: ...

    @abstractmethod
    def tokenize(self, text: str) -> List[int]: ...

    def detokenize(self, token_ids: List[int]) -> str:
        raise NotImplementedError

    @property
    def cls(self) -> int:
        raise NotImplementedError

    @property
    def sep(self) -> int:
        raise NotImplementedError

    @property
    def pad(self) -> int:
        raise NotImplementedError

    @property
    def eod(self) -> int:
        raise NotImplementedError

    @property
    def mask(self) -> int:
        raise NotImplementedError

    @property
    def vocab(self):
        raise NotImplementedError

    @property
    def inv_vocab(self):
        """id -> token dict, cached (used by whole-word masking)."""
        cached = getattr(self, "_inv_vocab_cache", None)
        if cached is None:
            cached = {i: t for t, i in self.vocab.items()}
            self._inv_vocab_cache = cached
        return cached

    @property
    def bos_token_id(self) -> int:
        return self.cls

    @property
    def eos_token_id(self) -> int:
        return self.eod

    @property
    def additional_special_tokens_ids(self) -> List[int]:
        return []


class _GPT2BPETokenizer(AbstractTokenizer):
    """GPT-2 byte-level BPE from local vocab.json + merges.txt."""

    def __init__(self, vocab_file: str, merge_file: str):
        try:
            from transformers import GPT2TokenizerFast

            self._tok = GPT2TokenizerFast(vocab_file=vocab_file,
                                          merges_file=merge_file)
            with open(vocab_file, encoding="utf-8") as f:
                if len(self._tok) < len(json.load(f)):
                    # a transformers whose constructor takes no file
                    # (5.x: vocab=, merges=) loads its special tokens
                    # alone: use the standalone BPE
                    raise ImportError("transformers ignored vocab_file")
        except ImportError:
            # standalone byte-level BPE (tokenizer/bpe.py) — same
            # algorithm, no transformers dependency
            from megatron_llm_torch.tokenizer.bpe import StandaloneGPT2BPE

            self._tok = StandaloneGPT2BPE(vocab_file, merge_file)
        self._eod = self._tok.convert_tokens_to_ids("<|endoftext|>")

    @property
    def vocab_size(self):
        return len(self._tok)

    @property
    def vocab(self):
        return self._tok.get_vocab()

    def tokenize(self, text):
        return self._tok.encode(text)

    def detokenize(self, ids):
        return self._tok.decode(ids)

    @property
    def eod(self):
        return self._eod

    @property
    def pad(self):
        return self._eod


class _BertWordPieceTokenizer(AbstractTokenizer):
    def __init__(self, vocab_file: str, lower_case: bool = True,
                 vocab_extra_ids: int = 0):
        try:
            from transformers import BertTokenizerFast

            from megatron_llm_torch.tokenizer.wordpiece import load_vocab

            self._tok = BertTokenizerFast(vocab_file=vocab_file,
                                          do_lower_case=lower_case)
            if len(self._tok) < len(load_vocab(vocab_file)):
                # as in _GPT2BPETokenizer: the file was not read
                raise ImportError("transformers ignored vocab_file")
        except ImportError:
            # standalone WordPiece (tokenizer/wordpiece.py) — same
            # algorithm, no transformers dependency
            from megatron_llm_torch.tokenizer.wordpiece import (
                StandaloneWordPiece,
            )

            self._tok = StandaloneWordPiece(vocab_file,
                                            do_lower_case=lower_case)
        # dedicated [BOS]/[EOS] tokens, matching the reference's
        # _BertWordPieceTokenizer (tokenizer.py:156-200: add_token('[BOS]'),
        # add_token('[EOS]')) — bos/eos must NOT collide with CLS/SEP/eod,
        # or T5 decoder-start tokens alias segment separators
        self._tok.add_special_tokens(
            {"bos_token": "[BOS]", "eos_token": "[EOS]"})
        if vocab_extra_ids > 0:
            # T5-style span sentinels (reference: tokenizer.py:123+ adds
            # <extra_id_N> when --vocab_extra_ids is set)
            self._tok.add_special_tokens({
                "additional_special_tokens": [
                    f"<extra_id_{i}>" for i in range(vocab_extra_ids)
                ]
            })

    @property
    def additional_special_tokens_ids(self):
        return self._tok.additional_special_tokens_ids

    @property
    def vocab_size(self):
        return len(self._tok)

    @property
    def vocab(self):
        return self._tok.get_vocab()

    def tokenize(self, text):
        return self._tok.encode(text, add_special_tokens=False)

    def detokenize(self, ids):
        return self._tok.decode(ids)

    @property
    def cls(self):
        return self._tok.cls_token_id

    @property
    def sep(self):
        return self._tok.sep_token_id

    @property
    def pad(self):
        return self._tok.pad_token_id

    @property
    def mask(self):
        return self._tok.mask_token_id

    @property
    def eod(self):
        return self._tok.sep_token_id

    @property
    def bos_token_id(self):
        return self._tok.bos_token_id

    @property
    def eos_token_id(self):
        return self._tok.eos_token_id


class _SentencePieceTokenizer(AbstractTokenizer):
    """Llama/Mistral .model tokenizer (reference: tokenizer.py:326+ with
    special tokens and --no_new_tokens)."""

    def __init__(self, model_file: str, vocab_extra_ids: int = 0,
                 new_tokens: bool = True):
        try:
            import sentencepiece as spm
            self._sp = spm.SentencePieceProcessor(model_file=model_file)
            self._backend = "spm"
        except ImportError:
            # fall back to HF fast tokenizer when given a directory with
            # tokenizer.json (covers llama/mistral checkpoints)
            from transformers import AutoTokenizer

            self._sp = AutoTokenizer.from_pretrained(model_file)
            self._backend = "hf"
        self._new_tokens = new_tokens
        self._extra = vocab_extra_ids

    @property
    def vocab_size(self):
        n = (self._sp.get_piece_size() if self._backend == "spm"
             else len(self._sp))
        return n + (self._extra if self._new_tokens else 0)

    def tokenize(self, text):
        if self._backend == "spm":
            return [self._sp.bos_id()] + self._sp.encode(text)
        return self._sp.encode(text)

    def detokenize(self, ids):
        return self._sp.decode(ids)

    @property
    def bos(self):
        return (self._sp.bos_id() if self._backend == "spm"
                else self._sp.bos_token_id)

    @property
    def eod(self):
        return (self._sp.eos_id() if self._backend == "spm"
                else self._sp.eos_token_id)

    @property
    def pad(self):
        if self._backend == "spm":
            pid = self._sp.pad_id()
            return pid if pid >= 0 else self.eod
        return self._sp.pad_token_id or self.eod


class _FalconTokenizer(AbstractTokenizer):
    def __init__(self, tokenizer_path: Optional[str] = None):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(
            tokenizer_path or "tiiuae/falcon-40b"
        )

    @property
    def vocab_size(self):
        return len(self._tok)

    @property
    def vocab(self):
        return self._tok.get_vocab()

    def tokenize(self, text):
        return self._tok.encode(text)

    def detokenize(self, ids):
        return self._tok.decode(ids)

    @property
    def eod(self):
        return self._tok.eos_token_id

    @property
    def pad(self):
        return self._tok.pad_token_id or self.eod


class _HFAutoTokenizer(AbstractTokenizer):
    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path)

    @property
    def vocab_size(self):
        return len(self._tok)

    def tokenize(self, text):
        return self._tok.encode(text)

    def detokenize(self, ids):
        return self._tok.decode(ids)

    @property
    def eod(self):
        return self._tok.eos_token_id

    @property
    def pad(self):
        return self._tok.pad_token_id or self.eod


class _NullTokenizer(AbstractTokenizer):
    """Whitespace-int tokenizer for tests and synthetic data."""

    def __init__(self, vocab_size: int):
        self._n = int(vocab_size)

    @property
    def vocab_size(self):
        return self._n + 1  # + eod

    def tokenize(self, text):
        return [int(t) for t in text.split()]

    def detokenize(self, ids):
        return " ".join(str(i) for i in ids)

    @property
    def eod(self):
        return self._n

    @property
    def pad(self):
        return self._n
