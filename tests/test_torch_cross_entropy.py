"""The port's cross entropy against the JAX package's: per-token loss and
logit grads of ``vocab_parallel_cross_entropy`` (with and without label
smoothing) and ``dense_cross_entropy``, same numpy inputs, fp32,
atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.ops import cross_entropy as jce
from megatron_llm_torch.ops import cross_entropy as tce

torch.set_num_threads(1)
ATOL = 1e-6


def _inputs(shape, vocab, seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal(shape + (vocab,)) * 3).astype(np.float32)
    labels = rng.integers(0, vocab, shape).astype(np.int32)
    weights = rng.standard_normal(shape).astype(np.float32)
    return logits, labels, weights


def _check(jfn, tfn, logits, labels, weights):
    """Loss, and the grad of sum(weights * loss) w.r.t. the logits."""
    jl = jnp.asarray(logits)
    want, vjp = jax.vjp(lambda x: jfn(x, jnp.asarray(labels)), jl)
    (want_g,) = vjp(jnp.asarray(weights))
    tl = torch.from_numpy(logits).requires_grad_(True)
    got = tfn(tl, torch.from_numpy(labels))
    (got_g,) = torch.autograd.grad(got, tl, torch.from_numpy(weights))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("shape,vocab", [((2, 7), 64), ((5,), 257)])
def test_vocab_parallel_cross_entropy_matches_jax(shape, vocab, smoothing):
    logits, labels, weights = _inputs(shape, vocab, vocab)
    _check(lambda x, y: jce.vocab_parallel_cross_entropy(x, y, smoothing),
           lambda x, y: tce.vocab_parallel_cross_entropy(x, y, smoothing),
           logits, labels, weights)


def test_dense_cross_entropy_matches_jax():
    logits, labels, weights = _inputs((6,), 3, 1)
    _check(jce.dense_cross_entropy, tce.dense_cross_entropy, logits, labels,
           weights)


def test_bf16_logits_are_computed_in_fp32():
    logits, labels, _ = _inputs((3, 4), 50, 2)
    tl = torch.from_numpy(logits).to(torch.bfloat16)
    got = tce.vocab_parallel_cross_entropy(tl, torch.from_numpy(labels))
    assert got.dtype == torch.float32
    want = tce.vocab_parallel_cross_entropy(tl.float(),
                                            torch.from_numpy(labels))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
