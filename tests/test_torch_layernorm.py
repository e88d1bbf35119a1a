"""The port's LayerNorm: ``layer_norm``, the plain forward and backward
and the autograd function around kernels D and E (the CPU takes their
plain versions) against the JAX package's ``layer_norm`` and
``fused_layer_norm`` with its VJP, the Pallas kernels in interpret mode.
Shapes of tests/test_pallas_kernels.py plus a width that is no multiple
of 256 and rows with a large mean.  Tolerances: forward 1e-5, grads (dx,
dgamma, dbeta) 2e-4 in fp32 (the JAX test's); 2e-2 with bf16 I/O.  And
``apply_norm``'s dispatch rule: the kernel only for ``fp32_compute`` with
a bias."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import megatron_llm_tpu.ops.pallas.layernorm as LN
from megatron_llm_tpu.ops import layernorm as jln
from megatron_llm_torch.ops import layernorm as tln
from megatron_llm_torch.ops.kernels import layernorm as tk

torch.set_num_threads(1)
SHAPES = [(256, 128), (100, 256), (37, 568), (8, 4544)]


@pytest.fixture(autouse=True)
def _interpret():
    LN._INTERPRET = True
    yield
    LN._INTERPRET = False


def _inputs(n, h, seed, mean=0.0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, h) + mean).astype(np.float32)
    s = (1.0 + 0.1 * rng.randn(h)).astype(np.float32)
    b = (0.1 * rng.randn(h)).astype(np.float32)
    g = rng.randn(n, h).astype(np.float32)
    return x, s, b, g


def _jax_fwd_bwd(x, s, b, g):
    y, vjp = jax.vjp(lambda *a: LN.fused_layer_norm(*a, 1e-5), x, s, b)
    return y, vjp(g)


@pytest.mark.parametrize("n,h", SHAPES)
def test_forward_and_backward_match_the_jax_kernel_fp32(n, h):
    x, s, b, g = _inputs(n, h, 3)
    want_y, want_g = _jax_fwd_bwd(*map(jnp.asarray, (x, s, b, g)))
    tx, ts, tb, tg = map(torch.from_numpy, (x, s, b, g))
    y, mu, rstd = tk.layer_norm_fwd(tx, ts, tb, 1e-5)
    assert mu.shape == rstd.shape == (n, 1) and mu.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(mu.numpy(), x.mean(-1, keepdims=True),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        rstd.numpy(), 1.0 / np.sqrt(x.var(-1, keepdims=True) + 1e-5),
        rtol=1e-5, atol=0)
    got = tk.layer_norm_bwd(tx, ts, tg, mu, rstd)
    for a, r in zip(got, want_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=2e-4,
                                   rtol=0)
    # the autograd function, on a 3-d input
    lx = tx.reshape(1, n, h).clone().requires_grad_(True)
    ls, lb = (t.clone().requires_grad_(True) for t in (ts, tb))
    out = tk.fused_layer_norm(lx, ls, lb, 1e-5)
    assert out.grad_fn is not None and out.shape == (1, n, h)
    np.testing.assert_allclose(out[0].detach().numpy(), np.asarray(want_y),
                               atol=1e-5, rtol=0)
    grads = torch.autograd.grad(out, (lx, ls, lb), tg.reshape(1, n, h))
    for a, r in zip(grads, want_g):
        np.testing.assert_allclose(a.reshape(r.shape).numpy(), np.asarray(r),
                                   atol=2e-4, rtol=0)


def test_rows_with_a_large_mean_keep_the_fp32_tolerance():
    """mean((x - mu)^2), not E[x^2] - mu^2: rows around 30 still agree
    with the JAX kernel at 1e-5, where the other form does not."""
    x, s, b, _ = _inputs(64, 256, 9, mean=30.0)
    xf = torch.from_numpy(x)
    naive = (xf - xf.mean(-1, keepdim=True)) * torch.rsqrt(
        (xf * xf).mean(-1, keepdim=True) - xf.mean(-1, keepdim=True) ** 2
        + 1e-5) * torch.from_numpy(s) + torch.from_numpy(b)
    want = np.asarray(LN.fused_layer_norm(*map(jnp.asarray, (x, s, b)), 1e-5))
    y, _, _ = tk.layer_norm_fwd(*map(torch.from_numpy, (x, s, b)), 1e-5)
    np.testing.assert_allclose(y.numpy(), want, atol=1e-5, rtol=0)
    assert np.abs(naive.numpy() - want).max() > 1e-5
    got = tln.layer_norm(*map(torch.from_numpy, (x, s, b)), eps=1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_bf16_io_matches_the_jax_kernel():
    x, s, b, g = _inputs(100, 256, 5)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    gb = jnp.asarray(g).astype(jnp.bfloat16)
    want_y, (want_dx, want_ds, want_db) = _jax_fwd_bwd(
        xb, jnp.asarray(s), jnp.asarray(b), gb)
    lx = torch.from_numpy(np.asarray(xb, np.float32)).to(
        torch.bfloat16).requires_grad_(True)
    tg = torch.from_numpy(np.asarray(gb, np.float32)).to(torch.bfloat16)
    ls = torch.from_numpy(s).requires_grad_(True)
    lb = torch.from_numpy(b).requires_grad_(True)
    y = tk.fused_layer_norm(lx, ls, lb, 1e-5)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.detach().float().numpy(),
                               np.asarray(want_y, np.float32), atol=2e-2,
                               rtol=0)
    dx, ds, db = torch.autograd.grad(y, (lx, ls, lb), tg)
    assert dx.dtype == torch.bfloat16 and ds.dtype == db.dtype == torch.float32
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(want_dx, np.float32), atol=2e-2,
                               rtol=0)
    # dgamma and dbeta sum 100 rows of bf16-rounded values
    for a, r in ((ds, want_ds), (db, want_db)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r, np.float32),
                                   atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("fp32_compute", [True, False])
def test_layer_norm_matches_jax(bias, fp32_compute):
    x, s, b, _ = _inputs(12, 64, 1)
    xb = jnp.asarray(x.reshape(3, 4, 64)).astype(jnp.bfloat16)
    want = jln.layer_norm(xb, jnp.asarray(s), jnp.asarray(b) if bias else None,
                          eps=1e-5, fp32_compute=fp32_compute)
    tx = torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16)
    got = tln.layer_norm(tx, torch.from_numpy(s),
                         torch.from_numpy(b) if bias else None, eps=1e-5,
                         fp32_compute=fp32_compute)
    assert got.dtype == torch.bfloat16
    # computed in bf16, the two frameworks round at other places: a bf16
    # step at magnitude 4 is 0.03, so that case also gets a relative part
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=1e-5 if fp32_compute else 2e-2,
                               rtol=0 if fp32_compute else 2e-2)


@pytest.mark.parametrize("bias,fp32_compute,takes_kernel", [
    (True, True, True), (False, True, False), (True, False, False)])
def test_apply_norm_takes_the_kernel_only_with_fp32_compute_and_a_bias(
        monkeypatch, bias, fp32_compute, takes_kernel):
    calls = []
    real = tln.fused_layer_norm
    monkeypatch.setattr(tln, "fused_layer_norm",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    x, s, b, _ = _inputs(6, 32, 2)
    jp = {"scale": jnp.asarray(s)}
    tp = {"scale": torch.from_numpy(s)}
    if bias:
        jp["bias"], tp["bias"] = jnp.asarray(b), torch.from_numpy(b)
    want = jln.apply_norm(jnp.asarray(x), jp, "layernorm", eps=1e-5,
                          fp32_compute=fp32_compute, use_pallas=True)
    got = tln.apply_norm(torch.from_numpy(x), tp, "layernorm", eps=1e-5,
                         fp32_compute=fp32_compute, use_kernel=True)
    assert bool(calls) == takes_kernel
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    calls.clear()
    tln.apply_norm(torch.from_numpy(x), tp, "layernorm", eps=1e-5,
                   fp32_compute=fp32_compute, use_kernel=False)
    assert not calls


def test_kernel_path_grads_equal_the_plain_norm_under_a_shared_output():
    """Under the parallel residual one norm output feeds two branches and
    its backward receives a strided sum of two gradients."""
    x, s, b, _ = _inputs(10, 32, 4)
    grads = []
    for use_kernel in (True, False):
        lx = torch.from_numpy(x.reshape(2, 5, 32)).requires_grad_(True)
        p = {"scale": torch.from_numpy(s).requires_grad_(True),
             "bias": torch.from_numpy(b).requires_grad_(True)}
        y = tln.apply_norm(lx, p, "layernorm", use_kernel=use_kernel)
        loss = (y.transpose(0, 1) ** 2).sum() + y[..., ::2].sin().sum()
        grads.append(torch.autograd.grad(loss, (lx, p["scale"], p["bias"])))
    for a, r in zip(*grads):
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=1e-5, rtol=0)


def test_cuda_wrappers_refuse_cpu_tensors():
    x, s, b, g = map(torch.from_numpy, _inputs(4, 32, 0))
    with pytest.raises(ValueError):
        tk.layer_norm_fwd_kernel(x, s, b, 1e-5)
    _, mu, rstd = tk.layer_norm_fwd_plain(x, s, b, 1e-5)
    with pytest.raises(ValueError):
        tk.layer_norm_bwd_kernel(x, s, g, mu, rstd)
