"""PyTorch port vs the JAX package: RMSNorm (plain and the kernel
module's CPU path), the norm dispatch, RoPE, the MLP activations, the
attention masks and softmax, and the engine's batched sampling filters.
Same numpy inputs into both, fp32, atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import TransformerConfig as JaxConfig
from megatron_llm_tpu.ops import activations as jact
from megatron_llm_tpu.ops import layernorm as jln
from megatron_llm_tpu.ops import rope as jrope
from megatron_llm_tpu.ops import softmax as jsm
from megatron_llm_tpu.ops.pallas import rmsnorm as jrms
from megatron_llm_tpu.text_generation import sampling as jsamp
from megatron_llm_torch.config import TransformerConfig
from megatron_llm_torch.ops import activations as tact
from megatron_llm_torch.ops import layernorm as tln
from megatron_llm_torch.ops import rope as trope
from megatron_llm_torch.ops import softmax as tsm
from megatron_llm_torch.ops.kernels import rmsnorm as trms
from megatron_llm_torch.text_generation import sampling as tsamp

torch.set_num_threads(1)
ATOL = 1e-5


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@pytest.mark.parametrize("shape", [(3, 5, 32), (7, 64)])
def test_rms_norm_matches_jax(shape):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    s = (rng.random(shape[-1]) + 0.5).astype(np.float32)
    want = np.asarray(jln.rms_norm(jnp.asarray(x), jnp.asarray(s), eps=1e-5))
    got = tln.rms_norm(torch.from_numpy(x), torch.from_numpy(s), eps=1e-5)
    np.testing.assert_allclose(_np(got), want, atol=ATOL, rtol=0)
    # the kernel module's CPU path (its plain version) against the JAX
    # kernel entry's CPU path, and the saved rstd against its definition
    want_k = np.asarray(jrms.fused_rms_norm(jnp.asarray(x), jnp.asarray(s),
                                            1e-5))
    got_k = trms.fused_rms_norm(torch.from_numpy(x), torch.from_numpy(s),
                                1e-5)
    np.testing.assert_allclose(_np(got_k), want_k, atol=ATOL, rtol=0)
    x2 = x.reshape(-1, shape[-1])
    _, rstd = trms.rms_norm_fwd(torch.from_numpy(x2), torch.from_numpy(s),
                                1e-5)
    np.testing.assert_allclose(
        _np(rstd), 1.0 / np.sqrt((x2 ** 2).mean(-1, keepdims=True) + 1e-5),
        rtol=1e-5, atol=0)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_apply_norm_matches_jax(use_kernel):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 16)).astype(np.float32)
    s = rng.standard_normal(16).astype(np.float32)
    want = np.asarray(jln.apply_norm(jnp.asarray(x), {"scale": jnp.asarray(s)},
                                     "rmsnorm", eps=1e-6,
                                     use_pallas=use_kernel))
    got = tln.apply_norm(torch.from_numpy(x), {"scale": torch.from_numpy(s)},
                         "rmsnorm", eps=1e-6, use_kernel=use_kernel)
    np.testing.assert_allclose(_np(got), want, atol=ATOL, rtol=0)
    b = rng.standard_normal(16).astype(np.float32)
    for bias in (None, b):
        jp = {"scale": jnp.asarray(s)}
        tp = {"scale": torch.from_numpy(s)}
        if bias is not None:
            jp["bias"], tp["bias"] = jnp.asarray(bias), torch.from_numpy(bias)
        want = np.asarray(jln.apply_norm(jnp.asarray(x), jp, "layernorm",
                                         eps=1e-6, use_pallas=use_kernel))
        got = tln.apply_norm(torch.from_numpy(x), tp, "layernorm", eps=1e-6,
                             use_kernel=use_kernel)
        np.testing.assert_allclose(_np(got), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(theta=500000.0, scaling_factor=2.0),
    dict(llama3_scaling=dict(factor=8.0, low_freq_factor=1.0,
                             high_freq_factor=4.0,
                             original_max_position=16)),
])
def test_rope_matches_jax(kw):
    rng = np.random.default_rng(2)
    d = 16
    cj, sj = jrope.precompute_freqs_cis(d, 40, **kw)
    ct, st = trope.precompute_freqs_cis(d, 40, **kw)
    np.testing.assert_allclose(_np(ct), np.asarray(cj), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(st), np.asarray(sj), atol=ATOL, rtol=0)
    x = rng.standard_normal((2, 6, 3, d)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4, 5], [9, 3, 30, 7, 0, 39]])
    for ids in (None, pos):
        want = np.asarray(jrope.apply_rotary_emb(
            jnp.asarray(x), cj, sj,
            None if ids is None else jnp.asarray(ids)))
        got = trope.apply_rotary_emb(
            torch.from_numpy(x), ct, st,
            None if ids is None else torch.from_numpy(ids))
        np.testing.assert_allclose(_np(got), want, atol=ATOL, rtol=0)


def test_partial_rotary_matches_jax():
    rng = np.random.default_rng(3)
    cj, sj = jrope.precompute_freqs_cis(8, 20)
    ct, st = trope.precompute_freqs_cis(8, 20)
    x = rng.standard_normal((1, 5, 2, 16)).astype(np.float32)
    want = np.asarray(jrope.apply_rotary_emb(jnp.asarray(x), cj, sj))
    got = trope.apply_rotary_emb(torch.from_numpy(x), ct, st)
    np.testing.assert_allclose(_np(got), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("glu,gelu_variant", [
    ("swiglu", "tanh"), ("geglu", "tanh"), ("reglu", "tanh"),
    ("liglu", "tanh"), (None, "tanh"), (None, "exact")])
def test_mlp_activation_matches_jax(glu, gelu_variant):
    rng = np.random.default_rng(4)
    h = (rng.standard_normal((3, 4, 24)) * 2).astype(np.float32)
    jcfg = JaxConfig(glu_activation=glu, gelu_variant=gelu_variant)
    tcfg = TransformerConfig(glu_activation=glu, gelu_variant=gelu_variant)
    want = np.asarray(jact.apply_mlp_activation(jnp.asarray(h), jcfg))
    got = tact.apply_mlp_activation(torch.from_numpy(h), tcfg)
    np.testing.assert_allclose(_np(got), want, atol=ATOL, rtol=0)
    if glu == "swiglu":
        np.testing.assert_allclose(
            _np(tact.swiglu(torch.from_numpy(h))),
            np.asarray(jact.swiglu(jnp.asarray(h))), atol=ATOL, rtol=0)


def test_masks_and_softmax_match_jax():
    rng = np.random.default_rng(5)
    for sq, sk in ((5, 5), (3, 9)):
        np.testing.assert_array_equal(_np(tsm.causal_mask(sq, sk)),
                                      np.asarray(jsm.causal_mask(sq, sk)))
        np.testing.assert_array_equal(
            _np(tsm.sliding_window_mask(sq, sk, 3)),
            np.asarray(jsm.sliding_window_mask(sq, sk, 3)))
    scores = rng.standard_normal((2, 3, 4, 9)).astype(np.float32)
    mask = np.array(jsm.causal_mask(4, 9))
    want = np.asarray(jsm.fused_scale_mask_softmax(
        jnp.asarray(scores), jnp.asarray(mask), scale=0.3))
    got = tsm.fused_scale_mask_softmax(torch.from_numpy(scores),
                                       torch.from_numpy(mask), scale=0.3)
    np.testing.assert_allclose(_np(got), want, atol=ATOL, rtol=0)


def test_batched_sampling_filters_match_jax():
    rng = np.random.default_rng(6)
    logits = (rng.standard_normal((5, 40)) * 3).astype(np.float32)
    top_k = np.array([0, 1, 5, 0, 40], np.int32)
    top_p = np.array([0.0, 0.0, 0.9, 0.5, 0.3], np.float32)
    temp = np.array([1.0, 0.0, 0.7, 1.5, 1.0], np.float32)
    want = np.asarray(jsamp.modify_logits_batched(
        jnp.asarray(logits), jnp.asarray(top_k), jnp.asarray(top_p),
        jnp.asarray(temp)))
    got = tsamp.modify_logits_batched(
        torch.from_numpy(logits), torch.from_numpy(top_k),
        torch.from_numpy(top_p), torch.from_numpy(temp))
    np.testing.assert_allclose(_np(got), want, atol=1e-4, rtol=1e-5)
    # greedy rows are an exact argmax; sampled rows draw only tokens the
    # filter kept, from their own generator
    gens = [torch.Generator().manual_seed(i) for i in range(5)]
    toks = _np(tsamp.sample_batched(
        torch.from_numpy(logits), gens, torch.from_numpy(top_k),
        torch.from_numpy(top_p), torch.from_numpy(temp)))
    assert toks[1] == logits[1].argmax()
    for i in (0, 2, 3, 4):
        assert want[i, toks[i]] > jsamp.NEG_INF / 2
    again = _np(tsamp.sample_batched(
        torch.from_numpy(logits),
        [torch.Generator().manual_seed(i) for i in range(5)],
        torch.from_numpy(top_k), torch.from_numpy(top_p),
        torch.from_numpy(temp)))
    np.testing.assert_array_equal(toks, again)
