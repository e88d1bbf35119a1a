"""Prompt-lookup drafter for in-engine speculative decoding.

Pure host-side token proposal — no jax, no device work.  The engine's
scheduler loop calls :func:`lookup_draft` per decoding slot to build the
``draft_tokens [S, K]`` / ``draft_len [S]`` arrays that ride the jitted
[S, K+1] verify step as traced inputs (engine.py ``_verify_impl``).

Drafting scheme (prompt-lookup / n-gram continuation): find the most
recent earlier occurrence of the current *bigram* in the slot's own
history (prompt + generated tokens) and propose the tokens that followed
it.  Great on repetitive workloads (summarization, code edit, RAG
quoting); on adversarial text the proposal rate drops to zero and the
verify step degenerates to a masked plain decode.  Semantics match the
deleted batch-1 ``text_generation/speculative.py`` ``_lookup_draft``
except for its fixed-shape fallback: where the jitted version had to
emit *something* for a missing match (the prompt prefix, rejected a step
later), the host version returns no draft at all — strictly cheaper.

Verification in the engine is exact-greedy, so a bad draft costs only
the (nearly free — same weight bytes cross HBM) extra verify columns,
never correctness.
"""

from __future__ import annotations

from typing import List, Sequence


def lookup_draft(tokens: Sequence[int], k: int) -> List[int]:
    """Propose up to ``k`` continuation tokens for ``tokens`` (the slot's
    full committed history: prompt + generated, last element = the token
    whose successor the next decode step samples).

    Returns the continuation of the most recent earlier occurrence of
    the final bigram ``(tokens[-2], tokens[-1])``; matches anywhere in
    the history count, including position 0.  Empty list when ``k <= 0``,
    the history is too short to form a bigram plus one continuation
    token, or the bigram never occurred before.  Never proposes tokens
    beyond the known history (the proposal is drawn from it), and never
    more than ``k`` — callers enforce the *budget* clamp (remaining
    ``max_new_tokens``) by passing a reduced ``k``.
    """
    n = len(tokens)
    if k <= 0 or n < 3:
        return []
    b0, b1 = tokens[-2], tokens[-1]
    # most recent j with tokens[j:j+2] == (b0, b1) and at least one known
    # continuation token before the current position (j + 2 < n); the
    # current bigram itself (j == n - 2) is excluded by the same bound
    for j in range(n - 3, -1, -1):
        if tokens[j] == b0 and tokens[j + 1] == b1:
            return [int(t) for t in tokens[j + 2:j + 2 + k]]
    return []


def draft_budget(k: int, max_new_tokens: int, generated: int) -> int:
    """Largest draft length a slot may propose this step without ever
    overshooting its token budget: a verify step commits up to
    ``draft_len + 1`` tokens (accepted drafts + the bonus token), so the
    draft must leave room for the bonus inside the remaining
    ``max_new_tokens - generated`` allowance.  This bound is also what
    makes the +K scheduler page reservation sufficient: written KV
    positions never pass ``prompt + max_new_tokens + k``."""
    return max(0, min(k, max_new_tokens - generated - 1))
