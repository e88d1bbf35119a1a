"""Kernel D's plan and its arithmetic on the CPU.

``plan(n, h, dtype)`` for every width of the LayerNorm families (GPT-2
768, 1024, 1280, 1600; Pythia/NeoX 768, 2048, 4096, 5120; Falcon 4544,
8192) and two tiny ones, at decode and training row counts, in both
dtypes: every 16-byte vector of a row is owned by exactly one (thread,
slot), a thread holds at most 8 vectors, a block has at most 1024
threads.  Then a plain emulation of the kernel in torch fp32 (the same
partition of the row over threads, each thread's sum in its slot order,
the warp's butterfly shuffles, the sum over the row's warps in order)
against the JAX package's ``fused_layer_norm`` (the Pallas kernel in
interpret mode), within 1e-5, rows with a large mean included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import megatron_llm_tpu.ops.pallas.layernorm as LN
from megatron_llm_torch.ops.kernels import layernorm as tk

torch.set_num_threads(1)
WIDTHS = (64, 128, 768, 1024, 1280, 1600, 2048, 4096, 4544, 5120, 8192)
ROWS = (1, 8, 64, 2048)
DTYPES = (torch.bfloat16, torch.float32)


@pytest.fixture(autouse=True)
def _interpret():
    LN._INTERPRET = True
    yield
    LN._INTERPRET = False


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("h", WIDTHS)
def test_every_vector_has_one_owner(h, dtype):
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    nvec = h // vec
    for n in ROWS:
        t, v, rows, grid = tk.plan(n, h, dtype)
        assert t % 32 == 0 and 1 <= v <= tk.MAX_VECS
        assert t * rows <= tk.max_threads(v) and grid >= 1
        owners = [(i % t, i // t) for i in range(nvec)]
        assert len(set(owners)) == nvec
        assert all(slot < v for _, slot in owners)
        # no thread is idle for a whole row
        assert nvec > t * (v - 1)
        if n <= 132:
            assert rows == 1 and grid == n
        else:
            # the grid's blocks walk every row
            assert grid <= -(-n // rows) and grid <= 2 * 132


def test_plans_of_falcon_rows():
    # 568 vectors a row: decode over 288 threads of 2; training over 128
    # threads of 5, four rows a block, two blocks an SM
    assert tk.plan(8, 4544, torch.bfloat16) == (288, 2, 1, 8)
    assert tk.plan(2048, 4544, torch.bfloat16) == (128, 5, 4, 264)
    with pytest.raises(ValueError):
        tk.plan(8, 4546, torch.bfloat16)


def _emulate(x, scale, bias, eps, p):
    """Kernel D's arithmetic in fp32 under plan ``p``: y, mu, rstd."""
    t, v, _, _ = p
    n, h = x.shape
    vec = 16 // x.element_size()
    nvec = h // vec
    xf = torch.zeros(n, t * v * vec)
    xf[:, :h] = x.float()
    parts = xf.reshape(n, v, t, vec)          # [row, slot, thread, elem]
    live = (torch.arange(v)[:, None] * t + torch.arange(t)) < nvec

    def row_sum(per_elem):
        acc = torch.zeros(n, t)
        for j in range(v):
            for i in range(vec):
                acc = acc + per_elem[:, j, :, i]
        w = acc.reshape(n, t // 32, 32)
        lanes = torch.arange(32)
        for o in (16, 8, 4, 2, 1):
            w = w + w[:, :, lanes ^ o]
        tot = torch.zeros(n)
        for k in range(t // 32):
            tot = tot + w[:, k, 0]
        return tot

    inv_h = torch.tensor(1.0 / h, dtype=torch.float32)
    mu = row_sum(parts) * inv_h
    dev = (parts - mu[:, None, None, None]) * live[None, :, :, None]
    rstd = torch.rsqrt(row_sum(dev * dev) * inv_h + eps)
    y = (x.float() - mu[:, None]) * rstd[:, None] * scale.float() \
        + bias.float()
    return y.to(x.dtype), mu[:, None], rstd[:, None]


@pytest.mark.parametrize("n,h,mean", [(8, 4544, 0.0), (37, 768, 0.0),
                                      (64, 1600, 30.0), (5, 8192, 0.0),
                                      (300, 128, 30.0)])
def test_emulated_kernel_matches_the_jax_kernel(n, h, mean):
    rng = np.random.RandomState(n + h)
    x = (rng.randn(n, h) * 2 + mean).astype(np.float32)
    s = (1.0 + 0.1 * rng.randn(h)).astype(np.float32)
    b = (0.1 * rng.randn(h)).astype(np.float32)
    want = np.asarray(LN.fused_layer_norm(jnp.asarray(x), jnp.asarray(s),
                                          jnp.asarray(b), 1e-5))
    tx, ts, tb = map(torch.from_numpy, (x, s, b))
    for rows in (n, 2048):
        p = tk.plan(rows, h, torch.float32)
        y, mu, rstd = _emulate(tx, ts, tb, 1e-5, p)
        np.testing.assert_allclose(y.numpy(), want, atol=1e-5, rtol=0)
        np.testing.assert_allclose(mu.numpy(), x.mean(-1, keepdims=True),
                                   atol=1e-5, rtol=0)
        y0, _, r0 = tk.layer_norm_fwd_plain(tx, ts, tb, 1e-5)
        np.testing.assert_allclose(rstd.numpy(), r0.numpy(), rtol=1e-5,
                                   atol=0)
