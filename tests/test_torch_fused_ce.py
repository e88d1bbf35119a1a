"""The port's fused (vocab-chunked) LM head + cross entropy against the
JAX package's (``ops/cross_entropy.py``): the loss and the grads of h and
of the weight on the same numpy inputs (fp32: forward atol 1e-5, grads
2e-5; bf16 against the materialised logits 3e-2), the chunk guards, the
model's loss with ``fused_lm_cross_entropy`` on against off and against
the JAX model's fused loss, a tied head's gradient through the
embedding, and ``apply_fused_ce_policy`` deciding as the JAX package's
at 32000, 128256 and 256000 with and without an explicit flag."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu import arguments as jax_arguments
from megatron_llm_tpu.models.llama import LlamaModel as JaxLlama
from megatron_llm_tpu.models.llama import llama_config as jax_llama_config
from megatron_llm_tpu.ops import cross_entropy as jce
from megatron_llm_torch import arguments
from megatron_llm_torch.models.gpt import GPTModel
from megatron_llm_torch.models.gpt2 import gpt2_config
from megatron_llm_torch.models.llama import LlamaModel, llama_config
from megatron_llm_torch.ops import cross_entropy as tce
from megatron_llm_torch.tree import tree_leaves_with_path
from megatron_llm_torch.weights import params_from_jax

torch.set_num_threads(1)


def _inputs(n=48, h=64, v=96, seed=0):
    rng = np.random.RandomState(seed)
    return ((rng.randn(n, h) * 0.3).astype(np.float32),
            (rng.randn(v, h) * 0.3).astype(np.float32),
            rng.randint(0, v, (n,)))


@pytest.mark.parametrize("chunk", [96, 32, 13, 8192])
def test_forward_matches_jax(chunk):
    hid, w, labels = _inputs()
    want = jce.fused_linear_cross_entropy(
        jnp.asarray(hid), jnp.asarray(w), jnp.asarray(labels),
        chunk_size=chunk)
    got = tce.fused_linear_cross_entropy(
        torch.from_numpy(hid), torch.from_numpy(w),
        torch.from_numpy(labels), chunk_size=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    unfused = tce.vocab_parallel_cross_entropy(
        torch.from_numpy(hid) @ torch.from_numpy(w).t(),
        torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), unfused.numpy(), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("chunk", [32, 96])
def test_grads_match_jax(chunk):
    hid, w, labels = _inputs()
    mask = (np.random.RandomState(1).rand(labels.shape[0]) > 0.3).astype(
        np.float32)

    def jloss(h_, w_):
        return jnp.sum(jce.fused_linear_cross_entropy(
            h_, w_, jnp.asarray(labels), chunk_size=chunk) * mask)

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(hid), jnp.asarray(w))
    th = torch.from_numpy(hid).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    loss = (tce.fused_linear_cross_entropy(
        th, tw, torch.from_numpy(labels), chunk_size=chunk)
        * torch.from_numpy(mask)).sum()
    got = torch.autograd.grad(loss, (th, tw))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5,
                                   rtol=0)
        assert a.dtype == torch.float32


def test_bf16_and_batched_shape():
    rng = np.random.RandomState(2)
    hid = torch.from_numpy(rng.randn(2, 16, 32) * 0.3).to(torch.bfloat16)
    w = torch.from_numpy(rng.randn(64, 32) * 0.3).to(torch.bfloat16)
    labels = torch.from_numpy(rng.randint(0, 64, (2, 16)))
    out = tce.fused_linear_cross_entropy(hid, w, labels, chunk_size=16)
    assert out.shape == (2, 16) and out.dtype == torch.float32
    ref = tce.vocab_parallel_cross_entropy(
        torch.einsum("bsh,vh->bsv", hid, w).float(), labels)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=3e-2, rtol=0)
    want = jce.fused_linear_cross_entropy(
        jnp.asarray(hid.float().numpy(), jnp.bfloat16),
        jnp.asarray(w.float().numpy(), jnp.bfloat16),
        jnp.asarray(labels.numpy()), chunk_size=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=3e-2,
                               rtol=0)
    # the grads keep the operands' dtypes
    h = hid.clone().requires_grad_(True)
    wg = w.clone().requires_grad_(True)
    gh, gw = torch.autograd.grad(tce.fused_linear_cross_entropy(
        h, wg, labels, chunk_size=16).sum(), (h, wg))
    assert gh.dtype == gw.dtype == torch.bfloat16


def test_pick_chunk_guards():
    for v, c in ((32000, 8192), (96, 200), (128256, 8192), (50304, 8192)):
        assert tce._flce_pick_chunk(v, c) == jce._flce_pick_chunk(v, c)
    assert tce._flce_pick_chunk(32000, 8192) == 8000
    assert tce._flce_pick_chunk(128256, 8192) == 8016
    for bad in (0, -3):
        with pytest.raises(ValueError, match=">= 1"):
            tce._flce_pick_chunk(32000, bad)
    with pytest.raises(ValueError, match="no divisor"):
        tce._flce_pick_chunk(32002, 8192)


KW = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
          ffn_hidden_size=96, padded_vocab_size=128, seq_length=32,
          max_position_embeddings=32)


def _leaf_grads(model, params, toks, labels):
    named = tree_leaves_with_path(params)
    leaves = [p.requires_grad_(True) for _, p in named]
    loss = model(params, toks, labels=labels, train=True)
    grads = torch.autograd.grad(loss.mean(), leaves)
    return loss.detach(), {"/".join(p): g for (p, _), g in zip(named, grads)}


def test_model_loss_fused_against_unfused_and_jax():
    jcfg = jax_llama_config("tiny", **KW)
    jparams = JaxLlama(jcfg).init(jax.random.PRNGKey(0))
    cfg = llama_config("tiny", **KW)
    params = params_from_jax(jax.device_get(jparams), cfg, device="cpu")
    toks = np.random.RandomState(0).randint(0, 128, (4, 32))
    labels = np.roll(toks, -1, axis=-1)
    fused = LlamaModel(cfg.replace(fused_lm_cross_entropy=True,
                                   fused_ce_chunk_size=48), device="cpu")
    plain = LlamaModel(cfg, device="cpu")
    tt, tl = torch.from_numpy(toks), torch.from_numpy(labels)
    loss_f, g_f = _leaf_grads(fused, params, tt, tl)
    loss_u, g_u = _leaf_grads(plain, params, tt, tl)
    np.testing.assert_allclose(loss_f.numpy(), loss_u.numpy(), atol=1e-5,
                               rtol=0)
    for k in g_u:
        np.testing.assert_allclose(g_f[k].numpy(), g_u[k].numpy(),
                                   atol=2e-5, rtol=0, err_msg=k)
    jfused = JaxLlama(dataclasses.replace(
        jcfg, fused_lm_cross_entropy=True, fused_ce_chunk_size=48))
    want = jfused(jparams, jnp.asarray(toks), labels=jnp.asarray(labels),
                  train=False)
    np.testing.assert_allclose(loss_f.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_tied_head_gradient_joins_the_embedding():
    cfg = gpt2_config("tiny", **dict(KW, hidden_dropout=0.0,
                                     attention_dropout=0.0))
    assert cfg.tie_embed_logits
    params = GPTModel(cfg, device="cpu").init(3)
    toks = torch.from_numpy(np.random.RandomState(4).randint(0, 128, (2, 32)))
    labels = torch.roll(toks, -1, dims=-1)
    fused = GPTModel(cfg.replace(fused_lm_cross_entropy=True,
                                 fused_ce_chunk_size=64), device="cpu")
    _, g_f = _leaf_grads(fused, params, toks, labels)
    _, g_u = _leaf_grads(GPTModel(cfg, device="cpu"), params, toks, labels)
    key = "embedding/word/embedding"
    np.testing.assert_allclose(g_f[key].numpy(), g_u[key].numpy(),
                               atol=2e-5, rtol=0)


def _policy_args(vocab, flag):
    argv = ["--padded_vocab_size", str(vocab)] + ([flag] if flag else [])
    jargs = jax_arguments.build_base_parser().parse_args(argv)
    targs = arguments.build_parser().parse_args(argv)
    return jargs, targs


@pytest.mark.parametrize("flag", [None, "--fused_lm_cross_entropy",
                                  "--no_fused_lm_cross_entropy"])
@pytest.mark.parametrize("vocab", [32000, 128256, 256000])
def test_policy_decides_as_the_jax_package(vocab, flag, capsys):
    jargs, targs = _policy_args(vocab, flag)
    jax_arguments.apply_fused_ce_policy(jargs)
    arguments.apply_fused_ce_policy(targs)
    assert targs.fused_lm_cross_entropy is jargs.fused_lm_cross_entropy
    assert targs.fused_ce_user_explicit is jargs.fused_ce_user_explicit
    want = {None: vocab >= 131072, "--fused_lm_cross_entropy": True,
            "--no_fused_lm_cross_entropy": False}[flag]
    assert targs.fused_lm_cross_entropy is want
    out = capsys.readouterr().out
    if flag is None and vocab >= 131072:
        assert out.count("auto-enabling fused_lm_cross_entropy") == 2
    # a later, larger vocabulary (the tokenizer's padding) decides again,
    # unless the user chose
    for a, apply in ((jargs, jax_arguments.apply_fused_ce_policy),
                     (targs, arguments.apply_fused_ce_policy)):
        apply(a, vocab=262144)
    assert targs.fused_lm_cross_entropy is jargs.fused_lm_cross_entropy
    assert targs.fused_lm_cross_entropy is (want if flag else True)


def test_validate_args_and_the_tokenizer_refire_the_policy():
    from megatron_llm_torch.tokenizer import build_tokenizer

    base = ["--num_layers=1", "--hidden_size=64", "--num_attention_heads=4",
            "--seq_length=8", "--vocab_size=32000",
            "--tokenizer_type=NullTokenizer"]
    for flag, want in ((None, True), ("--no_fused_lm_cross_entropy", False)):
        args = arguments.parse_args(base + ([flag] if flag else []))
        assert args.fused_lm_cross_entropy is False
        assert args.fused_ce_user_explicit is (flag is not None)
        # a tokenizer larger than the flags said: its padded vocabulary
        # decides again (131100 ids + eod -> 131200)
        args.vocab_size = 131100
        build_tokenizer(args)
        assert args.padded_vocab_size == 131200
        assert args.fused_lm_cross_entropy is want
