"""Kernels B (the RMSNorm forward) and E (the LayerNorm backward): their
plans and their arithmetic on the CPU.

``norm_plan.plan`` for every RMSNorm preset width (Llama-2 7B/13B/70B,
Llama-3, Mistral, Qwen2, Gemma-2B/7B) at decode, prefill and training
rows, and ``norm_plan.bwd_plan`` for every LayerNorm preset width: every
16-byte vector of a row is owned by exactly one (thread, slot), within
the kernels' vectors a thread and launch bounds.  Then plain emulations
of the kernels in torch fp32, against the JAX package's Pallas kernels in
interpret mode, within 1e-5:

* B: the same partition of the row over threads, each thread's sum of
  squares in its slot order, the warp's butterfly shuffles and the sum
  over the row's warps in order, against ``rmsnorm._fwd_call``;
* E: dx from the row's two sums taken in that order, and dgamma and
  dbeta from E's walk (``layernorm._reference_bwd_partials``: a block's
  row slots walk the rows with the grid's stride, each adds its rows
  into its columns in order, the block adds its slots in slot order into
  one partial row, and the column pass adds the partial rows in its
  warps' order), against ``layernorm._bwd_call``, at row counts that are
  no multiple of the rows a block, grids larger than the row groups and
  4544 columns (idle vectors).

Also the call sites' no-grad path: under ``torch.no_grad()`` (and with no
input that requires a gradient) ``apply_norm`` gives the autograd path's
output with no ``grad_fn``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import megatron_llm_tpu.ops.pallas.layernorm as LN
import megatron_llm_tpu.ops.pallas.rmsnorm as R
from megatron_llm_torch.models import falcon, gemma, gpt2, gpt_neox
from megatron_llm_torch.models import llama, mistral, qwen2
from megatron_llm_torch.ops import layernorm as tln
from megatron_llm_torch.ops.kernels import layernorm as tk
from megatron_llm_torch.ops.kernels import norm_plan
from megatron_llm_torch.ops.kernels import rmsnorm as trms

torch.set_num_threads(1)
DTYPES = (torch.bfloat16, torch.float32)
# every RMSNorm preset of the port, and every LayerNorm one
RMS_PRESETS = [(llama.llama_config, s) for s in ("7B", "13B", "70B",
                                                 "llama3-8B")] + [
    (mistral.mistral_config, "7B"), (qwen2.qwen2_config, "0.5B"),
    (qwen2.qwen2_config, "1.5B"), (qwen2.qwen2_config, "7B"),
    (gemma.gemma_config, "2B"), (gemma.gemma_config, "7B")]
LN_PRESETS = [(falcon.falcon_config, "7B"), (falcon.falcon_config, "40B"),
              (gpt2.gpt2_config, "125M"), (gpt2.gpt2_config, "1.3B"),
              (gpt_neox.gpt_neox_config, "6.9b"),
              (gpt_neox.gpt_neox_config, "12b")]
ROWS = (1, 8, 64, 1000, 4096)


@pytest.fixture(autouse=True)
def _interpret():
    R._INTERPRET = LN._INTERPRET = True
    yield
    R._INTERPRET = LN._INTERPRET = False


def _width(preset):
    fn, size = preset
    return fn(size).hidden_size


def _owners_ok(nvec, t, v):
    owners = [(i % t, i // t) for i in range(nvec)]
    return len(set(owners)) == nvec and all(s < v for _, s in owners)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("preset", RMS_PRESETS,
                         ids=lambda p: f"{p[0].__name__}-{p[1]}")
def test_b_plan_covers_every_rmsnorm_preset(preset, dtype):
    h = _width(preset)
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    nvec = h // vec
    for n in ROWS:
        t, v, rows, grid = norm_plan.plan(n, h, dtype)
        assert t % 32 == 0 and 1 <= v <= norm_plan.MAX_VECS
        assert t * rows <= norm_plan.max_threads(v) and grid >= 1
        assert _owners_ok(nvec, t, v)
        # no thread is idle for a whole row
        assert nvec > t * (v - 1)
        if n <= 132:
            assert rows == 1 and grid == n
        else:
            assert grid <= -(-n // rows) and grid <= 2 * 132


def test_b_plans_of_llama_rows():
    # 512 vectors a row: decode over 256 threads of 2; training over 128
    # threads of 4, four rows a block, two blocks an SM
    assert norm_plan.plan(8, 4096, torch.bfloat16) == (256, 2, 1, 8)
    assert norm_plan.plan(64, 4096, torch.bfloat16) == (256, 2, 1, 64)
    assert norm_plan.plan(4096, 4096, torch.bfloat16) == (128, 4, 4, 264)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("preset", LN_PRESETS,
                         ids=lambda p: f"{p[0].__name__}-{p[1]}")
def test_e_plan_covers_every_layernorm_preset(preset, dtype):
    h = _width(preset)
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    nvec = h // vec
    for n in ROWS:
        t, v, rows, grid = norm_plan.bwd_plan(n, h, dtype)
        limit, _ = norm_plan.bwd_shape(v, vec)
        assert t % 32 == 0 and 1 <= v <= norm_plan.MAX_VECS
        assert t * rows <= limit <= 512 and _owners_ok(nvec, t, v)
        assert nvec > t * (v - 1)
        # one block an SM at most, each walking its row groups
        assert 1 <= grid <= min(-(-n // rows), 132)


def test_e_plan_of_falcon_rows():
    # 568 vectors a row over 192 threads of 3 (8 idle), the next row
    # loaded ahead, two rows a 384-thread block, one block an SM
    assert norm_plan.bwd_plan(2048, 4544, torch.bfloat16) == (192, 3, 2,
                                                               132)
    assert norm_plan.bwd_shape(3, 8) == (512, True)
    with pytest.raises(ValueError):
        norm_plan.bwd_plan(8, 4546, torch.bfloat16)


def _row_sum(per_elem, t, v, vec):
    """The kernels' sum over a row of [n, v, t, vec] values: each thread
    in slot order, then the warp's butterfly, then the warps in order."""
    n = per_elem.shape[0]
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


def _parts(a, t, v, vec):
    """[n, h] fp32 values as [n, v, t, vec]: vector j * t + k of a row on
    thread k, slot j (zeros past the row's end)."""
    n, h = a.shape
    pad = torch.zeros(n, t * v * vec)
    pad[:, :h] = a
    return pad.reshape(n, v, t, vec)


def _emulate_b(x, scale, eps, p):
    """Kernel B's arithmetic in fp32 under plan ``p``: y, rstd."""
    t, v, _, _ = p
    h = x.shape[1]
    xs = _parts(x, t, v, 4)
    inv_h = torch.tensor(1.0 / h, dtype=torch.float32)
    rstd = torch.rsqrt(_row_sum(xs * xs, t, v, 4) * inv_h + eps)
    return x * rstd[:, None] * scale, rstd[:, None]


@pytest.mark.parametrize("n,h", [(8, 4096), (37, 896), (64, 2048),
                                 (5, 3072), (300, 128)])
def test_emulated_b_matches_the_jax_kernel(n, h):
    rng = np.random.RandomState(n + h)
    x = (rng.randn(n, h) * 2).astype(np.float32)
    s = (1.0 + 0.1 * rng.randn(h)).astype(np.float32)
    want_y, want_r = (np.asarray(a) for a in R._fwd_call(
        jnp.asarray(x), jnp.asarray(s), 1e-5))
    tx, ts = map(torch.from_numpy, (x, s))
    for rows in (n, 4096):
        p = norm_plan.plan(rows, h, torch.float32)
        y, r = _emulate_b(tx, ts, 1e-5, p)
        np.testing.assert_allclose(y.numpy(), want_y, atol=1e-5, rtol=0)
        np.testing.assert_allclose(r.numpy(), want_r, atol=0, rtol=1e-5)
        # and the wrapper's plain version (the CPU path) within the same
        y0, r0 = trms.rms_norm_fwd(tx, ts, 1e-5)
        np.testing.assert_allclose(y0.numpy(), want_y, atol=1e-5, rtol=0)


def _emulate_e_dx(x, scale, g, mu, rstd, p):
    """Kernel E's dx in fp32 under plan ``p``: the row's two sums taken
    in the kernels' order."""
    t, v, _, _ = p
    h = x.shape[1]
    xhat = (x - mu) * rstd
    ggam = g * scale
    s1 = _row_sum(_parts(ggam, t, v, 4), t, v, 4)
    s2 = _row_sum(_parts(ggam * xhat, t, v, 4), t, v, 4)
    m1, m2 = (s[:, None] / h for s in (s1, s2))
    return rstd * (ggam - m1 - xhat * m2)


def _e_plans(n, h):
    """E's plan for fp32 [n, h] rows, and forced ones: two rows a block
    over a grid that walks the rows several times, and a grid larger
    than the row groups (blocks with no row write zero partial rows)."""
    p = norm_plan.bwd_plan(n, h, torch.float32)
    nvec = h // 4
    t2, v2 = next((t, v) for t, v in ((32 * -(-nvec // (32 * v)), v)
                                      for v in range(1, 9))
                  if 2 * t <= norm_plan.bwd_shape(v, 4)[0])
    return [p, (t2, v2, 2, max(1, n // 7)), (p[0], p[1], 1, n + 5)]


@pytest.mark.parametrize("n,h,mean", [(37, 4544, 0.0), (300, 768, 3.0),
                                      (5, 128, 0.0), (130, 1600, 0.0)])
def test_emulated_e_matches_the_jax_kernel(n, h, mean):
    rng = np.random.RandomState(7 * n + h)
    x = (rng.randn(n, h) * 2 + mean).astype(np.float32)
    s = (1.0 + 0.1 * rng.randn(h)).astype(np.float32)
    g = rng.randn(n, h).astype(np.float32)
    tx, ts, tg = map(torch.from_numpy, (x, s, g))
    _, mu, rstd = tk.layer_norm_fwd_plain(tx, ts, torch.zeros(h), 1e-5)
    want_dx, want_dg, want_db = (np.asarray(a) for a in LN._bwd_call(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(g),
        jnp.asarray(mu.numpy()), jnp.asarray(rstd.numpy()), 1e-5))
    for p in _e_plans(n, h):
        assert p[0] * p[1] * 4 >= h
        dx = _emulate_e_dx(tx, ts, tg, mu, rstd, p)
        np.testing.assert_allclose(dx.numpy(), want_dx, atol=1e-5, rtol=0)
        partial, sums = tk._reference_bwd_partials(tx, ts, tg, mu, rstd, p)
        assert partial.shape == (p[3], 2 * h)
        # the sums of n rows: within 1e-5 of their size
        for got, want in ((sums[:h], want_dg), (sums[h:], want_db)):
            size = max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * size,
                                       rtol=0)
        # every row lands in exactly one partial row
        np.testing.assert_allclose(partial[:, h:].sum(0).numpy(),
                                   g.sum(0), atol=1e-4, rtol=0)


@pytest.mark.parametrize("ctx", [torch.no_grad, torch.inference_mode])
@pytest.mark.parametrize("normalization", ["rmsnorm", "layernorm"])
def test_apply_norm_without_a_gradient(normalization, ctx):
    rng = np.random.RandomState(3)
    h = 64
    x = torch.from_numpy(rng.randn(2, 5, h).astype(np.float32))
    params = {"scale": torch.from_numpy(
        (1.0 + 0.1 * rng.randn(h)).astype(np.float32)).requires_grad_(True)}
    if normalization == "layernorm":
        params["bias"] = torch.from_numpy(
            (0.1 * rng.randn(h)).astype(np.float32)).requires_grad_(True)
    want = tln.apply_norm(x.clone().requires_grad_(True), params,
                          normalization, use_kernel=True)
    assert want.grad_fn is not None
    with ctx():
        got = tln.apply_norm(x, params, normalization, use_kernel=True)
    assert got.grad_fn is None and not got.requires_grad
    assert got.shape == x.shape
    torch.testing.assert_close(got, want.detach(), rtol=0, atol=0)
    # grad mode on, but no input requires a gradient: the same path
    plain = {k: v.detach() for k, v in params.items()}
    again = tln.apply_norm(x, plain, normalization, use_kernel=True)
    assert again.grad_fn is None
    torch.testing.assert_close(again, want.detach(), rtol=0, atol=0)
