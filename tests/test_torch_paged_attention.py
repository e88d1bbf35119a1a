"""Ragged paged attention: the port's plain version (what its wrapper
runs on a CPU tensor) against the JAX package's Pallas kernel in
interpret mode and its dense-gather reference, on the grid of
tests/test_paged_attention_kernel.py — (g, nh) in {(1,1), (2,4), (4,4)},
sliding window None/12/5, prefill block_q None/8 — with ragged context
lengths and garbage-filled unowned pages.  fp32, atol 1e-5."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.ops.pallas import paged_attention as jpa
from megatron_llm_torch.ops.kernels import paged_attention as tpa

torch.set_num_threads(1)
ATOL = 1e-5

S, M, BS, D = 4, 4, 8, 16
LENS = np.asarray([0, 5, 17, 31], np.int32)
CTX = np.asarray([0, 3, 8, 17], np.int32)
C = 16
MP = 6


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = jpa._INTERPRET
    jpa._INTERPRET = True
    yield
    jpa._INTERPRET = old


def _pools(rng, S_, M_, g, live_tokens):
    """Shared pools with each slot's live pages at shuffled physical
    indices; every other page (and the garbage block 0) is large noise."""
    P = 1 + S_ * M_
    k = (rng.standard_normal((P, BS, g, D)) * 100.0).astype(np.float32)
    v = (rng.standard_normal((P, BS, g, D)) * 100.0).astype(np.float32)
    bt = (1 + rng.permutation(S_ * M_)).reshape(S_, M_).astype(np.int32)
    for s in range(S_):
        for j in range(-(-int(live_tokens[s]) // BS)):
            k[bt[s, j]] = rng.standard_normal((BS, g, D))
            v[bt[s, j]] = rng.standard_normal((BS, g, D))
    return k, v, bt


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("window", [None, 12, 5])
@pytest.mark.parametrize("g,nh", [(1, 1), (2, 4), (4, 4)])
def test_decode_plain_matches_jax(g, nh, window):
    rng = np.random.default_rng(7 * g + nh + (window or 0))
    q = rng.standard_normal((S, nh, D)).astype(np.float32)
    kp, vp, bt = _pools(rng, S, M, g, LENS + 1)
    scale = 1.0 / math.sqrt(D)
    got = tpa.paged_attention_decode(*_t(q, kp, vp, bt, LENS),
                                     sliding_window=window).numpy()
    kernel = np.asarray(jpa.paged_attention_decode(
        *_j(q, kp, vp, bt, LENS), sliding_window=window))
    ref = np.asarray(jpa._reference_paged_attention(
        *_j(q, kp, vp, bt, LENS), None, None, scale, window))
    np.testing.assert_allclose(got, kernel, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("block_q", [None, 8])
@pytest.mark.parametrize("window", [None, 12, 5])
@pytest.mark.parametrize("g,nh", [(1, 1), (2, 4), (4, 4)])
def test_prefill_plain_matches_jax(g, nh, window, block_q):
    rng = np.random.default_rng(11 * g + nh + (window or 0) + (block_q or 0))
    q = rng.standard_normal((len(CTX), C, nh, D)).astype(np.float32)
    kp, vp, bt = _pools(rng, len(CTX), MP, g, CTX + C)
    scale = 1.0 / math.sqrt(D)
    got = tpa.paged_attention_prefill(*_t(q, kp, vp, bt, CTX),
                                      sliding_window=window,
                                      block_q=block_q).numpy()
    kernel = np.asarray(jpa.paged_attention_prefill(
        *_j(q, kp, vp, bt, CTX), sliding_window=window, block_q=block_q))
    ref = np.asarray(jpa._reference_paged_prefill(
        *_j(q, kp, vp, bt, CTX), None, None, scale, window))
    np.testing.assert_allclose(got, kernel, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_decode_is_the_one_row_prefill():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((S, 4, D)).astype(np.float32)
    kp, vp, bt = _pools(rng, S, M, 2, LENS + 1)
    dec = tpa.paged_attention_decode(*_t(q, kp, vp, bt, LENS))
    pre = tpa.paged_attention_prefill(*_t(q[:, None], kp, vp, bt, LENS))
    np.testing.assert_allclose(pre[:, 0].numpy(), dec.numpy(), atol=1e-6,
                               rtol=0)
