"""Dialog metrics: normalized token-level F1 (reference: tasks/msdp/metrics.py,
itself the standard ParlAI formulation)."""

from __future__ import annotations

import re
from collections import Counter
from typing import List, Optional, Tuple

import numpy as np

_ARTICLES = re.compile(r"\b(a|an|the)\b")
_PUNCT = re.compile(r"[!\"#$%&()*+,\-./:;<=>?@\[\]\\^`{|}~_']")


def normalize_answer(text: str) -> str:
    """Lowercase; strip punctuation, articles, extra whitespace."""
    text = text.lower()
    text = _PUNCT.sub(" ", text)
    text = _ARTICLES.sub(" ", text)
    return " ".join(text.split())


def token_f1(guess: str, answer: str
             ) -> Tuple[Optional[float], Optional[float], Optional[float]]:
    """(precision, recall, f1) over normalized token multisets; empty
    answers are skipped (None), empty guesses score 0."""
    if answer == "":
        return None, None, None
    if guess == "":
        return 0.0, 0.0, 0.0
    g = normalize_answer(guess).split()
    a = normalize_answer(answer).split()
    overlap = sum((Counter(g) & Counter(a)).values())
    if overlap == 0:
        return 0.0, 0.0, 0.0
    p = overlap / len(g)
    r = overlap / len(a)
    return p, r, 2 * p * r / (p + r)


class F1Metric:
    """Aggregate F1 over (guess, answer) pairs (reference API)."""

    compute_each_pair = staticmethod(token_f1)

    @staticmethod
    def compute_all_pairs(guesses: List[str], answers: List[str]):
        assert len(guesses) == len(answers), "guess/answer length mismatch"
        ps, rs, fs = [], [], []
        for g, a in zip(guesses, answers):
            p, r, f = token_f1(g, a)
            if p is None:
                continue
            ps.append(p)
            rs.append(r)
            fs.append(f)
        return float(np.mean(ps)), float(np.mean(rs)), float(np.mean(fs))
