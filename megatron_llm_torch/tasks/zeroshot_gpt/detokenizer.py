"""Corpus-specific detokenizers undoing tokenized distribution formatting
(reference: tasks/zeroshot_gpt/detokenizer.py — ptb/wikitext/lambada)."""

from __future__ import annotations

import re

_PTB_RULES = [
    (" '", "'"), (" \n", "\n"), ("\n ", "\n"), (" n't", "n't"),
    (" N ", "1 "), ("$ 1", "$1"), ("# 1", "#1"),
]

# (pattern, replacement) applied in order; wikitext-103 uses @-@ style
# number separators and spaces around every punctuation mark
_WIKITEXT_LITERAL = [
    ("s '", "s'"),
    (" @-@ ", "-"), (" @,@ ", ","), (" @.@ ", "."),
    (" : ", ": "), (" ; ", "; "), (" . ", ". "), (" ! ", "! "),
    (" ? ", "? "), (" , ", ", "),
    ("= = = =", "===="), ("= = =", "==="), ("= =", "=="),
    (" " + chr(176) + " ", chr(176)),
    (" \n", "\n"), ("\n ", "\n"), (" N ", " 1 "), (" 's", "'s"),
]
_WIKITEXT_REGEX = [
    (r"/' [0-9]/", r"/'[0-9]/"),
    (r"\(\s*([^\)]*?)\s*\)", r"(\1)"),
    (r"\[\s*([^\]]*?)\s*\]", r"[\1]"),
    (r"{\s*([^}]*?)\s*}", r"{\1}"),
    (r"\"\s*([^\"]*?)\s*\"", r'"\1"'),
    (r"'\s*([^']*?)\s*'", r"'\1'"),
]


def ptb_detokenizer(text: str) -> str:
    for old, new in _PTB_RULES:
        text = text.replace(old, new)
    return text


def wikitext_detokenizer(text: str) -> str:
    text = text.replace("s '", "s'")
    text = re.sub(_WIKITEXT_REGEX[0][0], _WIKITEXT_REGEX[0][1], text)
    for old, new in _WIKITEXT_LITERAL[1:10]:
        text = text.replace(old, new)
    for pat, rep in _WIKITEXT_REGEX[1:]:
        text = re.sub(pat, rep, text)
    for old, new in _WIKITEXT_LITERAL[10:]:
        text = text.replace(old, new)
    return text


def lambada_detokenizer(text: str) -> str:
    return text


_DETOKENIZERS = {
    "ptb": ptb_detokenizer,
    "wiki": wikitext_detokenizer,
    "lambada": lambada_detokenizer,
}


def get_detokenizer(path: str):
    for marker, fn in _DETOKENIZERS.items():
        if marker in path:
            return fn
    return lambda s: s
