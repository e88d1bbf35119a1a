"""The port's flash attention (plain forward with its LSE, plain backward,
and the autograd function around them) against the JAX package's
``flash_attention`` and its VJP, the Pallas kernels run in interpret
mode as tests/test_pallas_kernels.py runs them.  Window None/32,
MHA/GQA/MQA, a length that divides the backward block (the fused
backward, G) and one that does not (the two-pass backward, H), with the
small blocks the JAX tests pass.  fp32; atol 1e-5 forward, 2e-5 grads."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import megatron_llm_tpu.ops.pallas.flash_attention as F
from megatron_llm_torch.ops.kernels import flash_attention as tfa

torch.set_num_threads(1)
FWD_ATOL, GRAD_ATOL = 1e-5, 2e-5
SCALE = 0.125
BLOCK = 64


@pytest.fixture(autouse=True)
def _interpret():
    F._INTERPRET = True
    yield
    F._INTERPRET = False


def _inputs(s, nh, ng, d=32, b=1, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, s, nh, d)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((b, s, ng, d)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((b, s, ng, d)) * 0.3).astype(np.float32)
    do = rng.standard_normal((b, s, nh, d)).astype(np.float32)
    return q, k, v, do


def _jax_flash(window):
    return lambda q, k, v: F.flash_attention(
        q, k, v, causal=True, sliding_window=window, softmax_scale=SCALE,
        block_q=BLOCK, block_k=BLOCK)


CASES = [  # (s, nh, ng, window): s=128 takes G, s=96 takes H
    (128, 4, 4, None), (128, 4, 2, 32), (128, 4, 1, None),
    (96, 4, 4, 32), (96, 4, 2, None), (96, 4, 1, 32),
]


@pytest.mark.parametrize("s,nh,ng,window", CASES)
def test_plain_forward_and_lse_match_jax(s, nh, ng, window):
    q, k, v, _ = _inputs(s, nh, ng)
    want = np.asarray(_jax_flash(window)(*map(jnp.asarray, (q, k, v))))
    _, lse = F._fwd_call(*(jnp.swapaxes(jnp.asarray(t), 1, 2)
                           for t in (q, k, v)),
                         scale=SCALE, causal=True, window=window,
                         block_q=BLOCK, block_k=BLOCK)
    o, tlse = tfa._reference_attention(*map(torch.from_numpy, (q, k, v)),
                                       True, window, SCALE)
    np.testing.assert_allclose(o.numpy(), want, atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(lse)[..., 0],
                               atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("s,nh,ng,window", CASES)
def test_plain_backward_and_autograd_match_jax_vjp(s, nh, ng, window):
    q, k, v, do = _inputs(s, nh, ng, seed=1)
    _, vjp = jax.vjp(_jax_flash(window), *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tfa._reference_attention(tq, tk, tv, True, window, SCALE)
    plain = tfa._reference_attention_bwd(tq, tk, tv, o, lse, tdo, True,
                                         window, SCALE)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = tfa.flash_attention(*leaves, causal=True, sliding_window=window,
                              softmax_scale=SCALE)
    auto = torch.autograd.grad(out, leaves, tdo)
    for name, p, a, w in zip(("dq", "dk", "dv"), plain, auto, want):
        np.testing.assert_allclose(p.numpy(), w, atol=GRAD_ATOL, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(a.numpy(), w, atol=GRAD_ATOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("s", [128, 96, 192])
def test_dispatch_picks_g_or_h_as_the_jax_package_does(s, monkeypatch):
    fused_calls = []
    orig = F._bwd_fused_call

    def spy(*a, **kw):
        fused_calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(F, "_bwd_fused_call", spy)
    q, k, v, do = _inputs(s, 2, 2, d=32)
    _, vjp = jax.vjp(_jax_flash(None), *map(jnp.asarray, (q, k, v)))
    vjp(jnp.asarray(do))
    assert bool(fused_calls) == tfa.uses_fused_backward(s, s)


def test_rows_no_key_reaches_give_zero_output_and_grad():
    """sq > sk with a window: the last query rows see no key; o = 0,
    lse = NEG_INF and no NaN in the backward, as in the Pallas kernel."""
    q, _, _, do = _inputs(48, 2, 2)
    _, k, v, _ = _inputs(20, 2, 2, seed=4)
    want = np.asarray(jnp.swapaxes(F._fwd_call(
        *(jnp.swapaxes(jnp.asarray(t), 1, 2) for t in (q, k, v)),
        scale=SCALE, causal=True, window=4, block_q=16, block_k=16)[0],
        1, 2))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tfa._reference_attention(tq, tk, tv, True, 4, SCALE)
    np.testing.assert_allclose(o.numpy(), want, atol=FWD_ATOL, rtol=0)
    assert (o[0, 23:] == 0).all() and (lse[0, :, 23:] == tfa.NEG_INF).all()
    grads = tfa._reference_attention_bwd(tq, tk, tv, o, lse, tdo, True, 4,
                                         SCALE)
    assert all(torch.isfinite(g).all() for g in grads)
