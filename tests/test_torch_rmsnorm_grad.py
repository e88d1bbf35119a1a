"""The port's RMSNorm backward: the plain backward and the autograd
function around kernels B and C (the CPU takes their plain versions)
against the JAX package's ``fused_rms_norm`` and its VJP, the Pallas
kernels in interpret mode.  Row counts that are not a multiple of the
Pallas row block, fp32 and bf16 I/O.  Tolerances of
tests/test_pallas_kernels.py: forward 1e-6, dx 1e-5, dscale 2e-4 in
fp32; 2e-2 in bf16.  Also the repair that made the kernel path
differentiable: the autograd grads equal those of the plain
``rms_norm`` to 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import megatron_llm_tpu.ops.pallas.rmsnorm as R
from megatron_llm_torch.ops import layernorm as tln
from megatron_llm_torch.ops.kernels import rmsnorm as trms

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _interpret():
    R._INTERPRET = True
    yield
    R._INTERPRET = False


def _inputs(n, h, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, h)) * 2).astype(np.float32)
    s = rng.standard_normal(h).astype(np.float32)
    g = rng.standard_normal((n, h)).astype(np.float32)
    return x, s, g


@pytest.mark.parametrize("n,h", [(300, 128), (7, 64), (256, 32)])
def test_backward_matches_jax_vjp_fp32(n, h):
    x, s, g = _inputs(n, h, n + h)
    want_y, vjp = jax.vjp(lambda a, b: R.fused_rms_norm(a, b, 1e-5),
                          jnp.asarray(x), jnp.asarray(s))
    want_dx, want_ds = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    tx, ts, tg = map(torch.from_numpy, (x, s, g))
    _, rstd = trms.rms_norm_fwd(tx, ts, 1e-5)
    dx, ds = trms.rms_norm_bwd(tx, ts, tg, rstd)
    np.testing.assert_allclose(dx.numpy(), want_dx, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ds.numpy(), want_ds, atol=2e-4, rtol=0)
    # the autograd function
    lx, ls = tx.clone().requires_grad_(True), ts.clone().requires_grad_(True)
    y = trms.fused_rms_norm(lx, ls, 1e-5)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               atol=1e-6, rtol=0)
    ax, as_ = torch.autograd.grad(y, (lx, ls), tg)
    np.testing.assert_allclose(ax.numpy(), want_dx, atol=1e-5, rtol=0)
    np.testing.assert_allclose(as_.numpy(), want_ds, atol=2e-4, rtol=0)


def test_backward_matches_jax_vjp_bf16_io():
    x, s, g = _inputs(300, 128, 5)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    gb = jnp.asarray(g).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda a, b: R.fused_rms_norm(a, b, 1e-5), xb,
                     jnp.asarray(s))
    want_dx, want_ds = vjp(gb)
    tx = torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16)
    tg = torch.from_numpy(np.asarray(gb, np.float32)).to(torch.bfloat16)
    lx = tx.clone().requires_grad_(True)
    ls = torch.from_numpy(s).requires_grad_(True)
    y = trms.fused_rms_norm(lx, ls, 1e-5)
    assert y.dtype == torch.bfloat16
    dx, ds = torch.autograd.grad(y, (lx, ls), tg)
    assert dx.dtype == torch.bfloat16 and ds.dtype == torch.float32
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(want_dx, np.float32),
                               atol=2e-2, rtol=0)
    # dscale sums 300 rows of bf16-rounded products
    np.testing.assert_allclose(ds.numpy(), np.asarray(want_ds, np.float32),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("shape", [(2, 5, 16), (9, 32)])
def test_kernel_path_is_differentiable_like_the_plain_norm(shape):
    """apply_norm(..., use_kernel=True) carries a grad_fn and its grads
    equal the plain rms_norm's (the kernel wrapper used to return a
    tensor with none)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape).astype(np.float32)
    s = (rng.random(shape[-1]) + 0.5).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    grads = []
    for use_kernel in (True, False):
        lx = torch.from_numpy(x).requires_grad_(True)
        ls = torch.from_numpy(s).requires_grad_(True)
        y = tln.apply_norm(lx, {"scale": ls}, "rmsnorm", eps=1e-5,
                           use_kernel=use_kernel)
        assert y.grad_fn is not None
        grads.append(torch.autograd.grad(y, (lx, ls), torch.from_numpy(g)))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)
