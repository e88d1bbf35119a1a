"""The flash kernels' head_dim 256, their dispatch, and the backward's
head split, on the CPU.

* Every preset of every family the port trains has a head_dim the
  kernels take (Gemma-2B/7B and Pythia-1b have 256).
* At d 256 the plain forward (with its LSE) and the plain backward match
  the JAX package's ``flash_attention`` and its VJP, the Pallas kernels in
  interpret mode, MHA and MQA (fp32; atol 1e-5 forward, 2e-5 grads).
* The split rule gives at least two waves of blocks at Falcon-7B's MQA
  shape and no split at Llama's MHA shape; the plain per-split dK/dV,
  added in split order as the kernels add them, give the unsplit plain
  backward (bit for bit with one split, within 2e-5 with more: the fp32
  sums associate differently) and the same bits on every run.
* The kernel variant is chosen by dtype and head_dim alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import megatron_llm_tpu.ops.pallas.flash_attention as F
from megatron_llm_torch import models
from megatron_llm_torch.ops.kernels import flash_attention as tfa

torch.set_num_threads(1)
FWD_ATOL, GRAD_ATOL = 1e-5, 2e-5
SCALE = 0.0625
BLOCK = 64
H100_SMS = 132

# every preset of each family's config table ("tiny", the CPU test size,
# aside)
PRESETS = {
    "llama_config": ("7B", "13B", "70B", "llama3-8B", "llama3-70B"),
    "falcon_config": ("7B", "40B"),
    "gpt2_config": ("125M", "355M", "1.3B"),
    "gpt_neox_config": ("160m", "1b", "6.9b", "12b"),
    "mistral_config": ("7B",),
    "qwen2_config": ("0.5B", "1.5B", "7B"),
    "gemma_config": ("2B", "7B"),
}


@pytest.fixture(autouse=True)
def _interpret():
    F._INTERPRET = True
    yield
    F._INTERPRET = False


def _inputs(s, nh, ng, d=256, b=1, seed=0):
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


@pytest.mark.parametrize("config_fn", sorted(PRESETS))
def test_every_trained_preset_has_a_kernel_head_dim(config_fn):
    for size in PRESETS[config_fn]:
        d = getattr(models, config_fn)(size).head_dim
        assert d in tfa.HEAD_DIMS, (config_fn, size, d)
        for dtype in (torch.bfloat16, torch.float32):
            assert (dtype, d) in tfa.TILES


D256_CASES = [  # (s, nh, ng, window): s=128 takes G, s=96 takes H
    (128, 4, 4, None), (128, 4, 1, 32), (96, 4, 1, None), (96, 2, 2, 32),
]


@pytest.mark.parametrize("s,nh,ng,window", D256_CASES)
def test_plain_forward_and_lse_match_jax_at_d256(s, nh, ng, window):
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


@pytest.mark.parametrize("s,nh,ng,window", D256_CASES)
def test_plain_backward_matches_jax_vjp_at_d256(s, nh, ng, window):
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


def _bwd_block_k(dtype, d):
    return tfa.TILES[(dtype, d)][1][1]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_rule_fills_the_card_at_mqa_and_leaves_mha(dtype):
    # Falcon-7B: 71 query heads on one KV head of 64, sequence 2048
    bk = _bwd_block_k(dtype, 64)
    splits = tfa.head_splits(1, 2048, 1, 71, bk, H100_SMS)
    assert splits * (2048 // bk) >= 2 * H100_SMS
    if dtype == torch.bfloat16:
        assert splits >= 8
    # Llama-2-7B: 32 heads, MHA, sequence 4096
    assert tfa.head_splits(1, 4096, 32, 1, _bwd_block_k(dtype, 128),
                           H100_SMS) == 1
    # Gemma-2B: 8 query heads on one KV head of 256
    s = tfa.head_splits(1, 2048, 1, 8, _bwd_block_k(dtype, 256), H100_SMS)
    assert 1 < s <= 8
    # never more splits than heads, whatever the card
    assert tfa.head_splits(1, 64, 1, 3, 64, 10_000) == 3


@pytest.mark.parametrize("qpg", [1, 3, 8, 71])
def test_split_heads_cover_each_head_once_in_order(qpg):
    for splits in range(1, qpg + 1):
        ranges = tfa._split_head_ranges(qpg, splits)
        assert len(ranges) == splits
        heads = [h for lo, hi in ranges for h in range(lo, hi)]
        assert heads == list(range(qpg))
        assert all(hi > lo for lo, hi in ranges)


@pytest.mark.parametrize("s,nh,ng,window,d", [
    (128, 8, 1, None, 64), (96, 6, 2, 32, 64), (64, 4, 1, None, 256)])
def test_split_partials_sum_to_the_unsplit_backward(s, nh, ng, window, d):
    q, k, v, do = map(torch.from_numpy, _inputs(s, nh, ng, d=d, seed=2))
    o, lse = tfa._reference_attention(q, k, v, True, window, SCALE)
    _, dk, dv = tfa._reference_attention_bwd(q, k, v, o, lse, do, True,
                                             window, SCALE)
    whole = torch.stack((dk, dv))
    one = tfa._sum_splits(tfa._reference_dkv_partials(
        q, k, v, o, lse, do, True, window, SCALE, 1))
    assert torch.equal(one, whole)
    for splits in range(2, nh // ng + 1):
        parts = tfa._reference_dkv_partials(q, k, v, o, lse, do, True,
                                            window, SCALE, splits)
        assert parts.shape == (splits, 2) + tuple(dk.shape)
        got = tfa._sum_splits(parts)
        again = tfa._sum_splits(tfa._reference_dkv_partials(
            q, k, v, o, lse, do, True, window, SCALE, splits))
        assert torch.equal(got, again)
        np.testing.assert_allclose(got.numpy(), whole.numpy(),
                                   atol=GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_dispatch_picks_the_variant_by_dtype_and_head_dim(d):
    bf, f32 = torch.bfloat16, torch.float32
    assert tfa.kernel_variant(bf, d, "fwd") == "fwd_bf16_wgmma"
    assert tfa.kernel_variant(bf, d, "fused") == (
        "bwd_fused_bf16_mma" if d == 256 else "bwd_fused_bf16_wgmma")
    assert tfa.kernel_variant(bf, d, "two_pass") == "bwd_two_pass_bf16_wgmma"
    assert tfa.kernel_variant(f32, d, "fwd") == "fwd_fp32"
    assert tfa.kernel_variant(f32, d, "fused") == "bwd_fused_fp32"
    assert tfa.kernel_variant(f32, d, "two_pass") == "bwd_two_pass_fp32"
    fwd, fused, dq, kv = tfa.TILES[(bf, d)]
    assert fwd[0] == 128                   # two consumer warpgroups
    # G: 64 keys a consumer warpgroup, two of them at d 64 (wgmma); the
    # mma.sync kernel's 32 keys at d 256
    assert fused[1] == {64: 128, 128: 64, 256: 32}[d]


def test_dispatch_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError):
        tfa.kernel_variant(torch.bfloat16, 96, "fwd")
    with pytest.raises(TypeError):
        tfa.kernel_variant(torch.float64, 128, "fwd")
    with pytest.raises(ValueError):
        tfa.kernel_variant(torch.float32, 128, "dq")
    # fp16 runs the bf16 kernels with fp16 elements, on their tiles
    assert tfa.kernel_variant(torch.float16, 128, "fwd") == "fwd_fp16_wgmma"
    assert set(tfa.TILES) == {(dt, d) for dt in (torch.bfloat16,
                                                 torch.float16,
                                                 torch.float32)
                              for d in tfa.HEAD_DIMS}
    assert all(tfa.TILES[(torch.float16, d)] == tfa.TILES[(torch.bfloat16, d)]
               for d in tfa.HEAD_DIMS)
