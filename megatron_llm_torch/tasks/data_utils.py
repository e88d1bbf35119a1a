"""Shared helpers for downstream-task datasets.

Reference: ``tasks/data_utils.py`` — text cleaning, [CLS] a [SEP] b [SEP]
token-type building and padding, sample dict construction.
"""

from __future__ import annotations

import re
from typing import List, Optional

import numpy as np


def clean_text(text: str) -> str:
    """Collapse whitespace, strip control characters."""
    text = "".join(ch if ord(ch) >= 32 or ch in "\t\n" else " "
                   for ch in text)
    return re.sub(r"\s+", " ", text).strip()


def truncate_pair(ids_a: List[int], ids_b: Optional[List[int]],
                  max_tokens: int) -> None:
    """Trim the longer sequence from the back until the pair fits."""
    if ids_b is None:
        del ids_a[max_tokens:]
        return
    while len(ids_a) + len(ids_b) > max_tokens:
        if len(ids_a) > len(ids_b):
            ids_a.pop()
        else:
            ids_b.pop()


def build_tokens_types_paddings_from_text(text_a: str, text_b: Optional[str],
                                          tokenizer, max_seq_length: int):
    ids_a = tokenizer.tokenize(text_a)
    ids_b = tokenizer.tokenize(text_b) if text_b else None
    return build_tokens_types_paddings_from_ids(ids_a, ids_b, max_seq_length,
                                                tokenizer.cls, tokenizer.sep,
                                                tokenizer.pad)


def build_tokens_types_paddings_from_ids(ids_a, ids_b, max_seq_length,
                                         cls_id, sep_id, pad_id):
    """[CLS] a [SEP] (b [SEP]) with 0/1 types, padded to max_seq_length."""
    ids_a, ids_b = list(ids_a), (list(ids_b) if ids_b is not None else None)
    special = 3 if ids_b is not None else 2
    truncate_pair(ids_a, ids_b, max_seq_length - special)

    ids = [cls_id] + ids_a + [sep_id]
    types = [0] * len(ids)
    if ids_b is not None:
        ids += ids_b + [sep_id]
        types += [1] * (len(ids_b) + 1)
    paddings = [1] * len(ids)
    n_pad = max_seq_length - len(ids)
    ids += [pad_id] * n_pad
    types += [pad_id] * n_pad
    paddings += [0] * n_pad
    return ids, types, paddings


def build_sample(ids, types, paddings, label, unique_id):
    return {
        "text": np.asarray(ids, np.int64),
        "types": np.asarray(types, np.int64),
        "padding_mask": np.asarray(paddings, np.int64),
        "label": np.int64(label),
        "uid": np.int64(unique_id),
    }
