"""The port's prompt-lookup drafter (``serving/drafter.py``) against the
JAX package's on seeded histories: the same proposals for every history
and draft length, and the same budget clamp."""

import numpy as np
import pytest

from megatron_llm_tpu.serving import drafter as jax_drafter
from megatron_llm_torch.serving import drafter


@pytest.mark.parametrize("seed", range(4))
def test_lookup_draft_equals_jax(seed):
    rng = np.random.RandomState(seed)
    for _ in range(200):
        n = int(rng.randint(0, 40))
        # a small vocabulary, so bigrams repeat
        hist = rng.randint(0, 1 + seed * 3 + 4, size=n).tolist()
        for k in (0, 1, 3, 4, 8):
            got = drafter.lookup_draft(hist, k)
            assert got == jax_drafter.lookup_draft(hist, k)
            assert len(got) <= k


def test_draft_budget_equals_jax():
    for k in (0, 1, 4, 7):
        for max_new in (1, 2, 5, 64):
            for generated in range(0, max_new + 1):
                assert drafter.draft_budget(k, max_new, generated) == \
                    jax_drafter.draft_budget(k, max_new, generated)


def test_lookup_draft_takes_the_most_recent_match():
    hist = [1, 2, 9, 1, 2, 7, 8, 1, 2]
    assert drafter.lookup_draft(hist, 2) == [7, 8]
    assert drafter.lookup_draft([1, 2], 4) == []
