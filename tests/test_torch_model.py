"""The port's model against the JAX package's, from the same
JAX-initialised params carried across by megatron_llm_torch/weights.py:
the no-cache forward, and chunked paged prefill then decode (through the
paged kernels' plain versions), on a tiny Llama,
a GQA config and a Mistral sliding-window config.  fp32, atol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.models.language_model import (
    language_model_forward as jax_forward)
from megatron_llm_tpu.models.llama import LlamaModel as JaxLlama
from megatron_llm_tpu.models.llama import llama_config as jax_llama_config
from megatron_llm_torch.models.language_model import language_model_forward
from megatron_llm_torch.models.llama import LlamaModel, llama_config
from megatron_llm_torch.weights import params_from_jax

torch.set_num_threads(1)
ATOL = 1e-4

CONFIGS = {
    "llama": dict(),
    "gqa": dict(num_attention_heads_kv=2),
    "mistral_window": dict(sliding_window_size=5),
}
BS, M = 4, 6


def _cfg_kwargs(name):
    return dict(num_layers=2, hidden_size=64, num_attention_heads=4,
                ffn_hidden_size=96, padded_vocab_size=64, seq_length=32,
                max_position_embeddings=32, **CONFIGS[name])


def _models(name):
    kw = _cfg_kwargs(name)
    jmodel = JaxLlama(jax_llama_config("tiny", use_flash_attn=False, **kw))
    jparams = jmodel.init(jax.random.PRNGKey(3))
    tcfg = llama_config("tiny", **kw)
    tparams = params_from_jax(jax.device_get(jparams), tcfg,
                              device=torch.device("cpu"))
    return jmodel, jparams, LlamaModel(tcfg, device="cpu"), tparams


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_no_cache_forward_matches_jax(name):
    jmodel, jparams, tmodel, tparams = _models(name)
    tokens = np.random.default_rng(0).integers(0, 64, (2, 12))
    want = np.asarray(jmodel(jparams, jnp.asarray(tokens)))
    got = tmodel(tparams, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _paged_caches_np(cfg, S):
    P = 1 + S * M
    shape = (P, BS, cfg.num_query_groups, cfg.head_dim)
    rng = np.random.default_rng(1)
    # unwritten pages hold noise: a read that escapes the masks shows
    pools = [(rng.standard_normal(shape).astype(np.float32),
              rng.standard_normal(shape).astype(np.float32))
             for _ in range(cfg.num_layers)]
    bt = (1 + np.arange(S * M)).reshape(S, M).astype(np.int32)
    return pools, bt


def _step(fwd, params, cfg, pools, bt, tokens, ctx, valid, to_arr):
    caches = [dict(k_pages=to_arr(k), v_pages=to_arr(v),
                   block_tables=to_arr(bt), context_lens=to_arr(ctx),
                   valid_lens=to_arr(valid)) for k, v in pools]
    n = tokens.shape[1]
    pos = (ctx[:, None] + np.arange(n)[None, :]).astype(np.int64)
    logits, new = fwd(params, to_arr(tokens), to_arr(pos), None, cfg,
                      kv_caches=caches)
    return (np.asarray(logits),
            [(np.array(c["k_pages"]), np.array(c["v_pages"])) for c in new])


@pytest.mark.parametrize("n_chunks", [1, 2])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_paged_prefill_then_decode_matches_jax(name, n_chunks):
    """Two slots prefill ``n_chunks`` 8-token chunks (in the last one the
    second slot has 5 valid tokens, so its tail writes the garbage
    block; a second chunk starts mid-table and crosses pages), then
    decode two steps.  The port's paged branch runs through ops/kernels
    (their plain versions on the CPU)."""
    jmodel, jparams, tmodel, tparams = _models(name)
    tcfg, jcfg = tmodel.cfg, jmodel.cfg
    pools_j, bt = _paged_caches_np(tcfg, 2)
    pools_t = [(k.copy(), v.copy()) for k, v in pools_j]
    rng = np.random.default_rng(2)
    valids = ([np.array([8, 8], np.int32)] * (n_chunks - 1)
              + [np.array([8, 5], np.int32)]
              + [np.array([1, 1], np.int32)] * 2)
    tokens = rng.integers(0, 64, (2, 8))
    ctx = np.array([0, 0], np.int32)
    for step, valid in enumerate(valids):
        lj, pools_j = _step(jax_forward, jparams, jcfg, pools_j, bt, tokens,
                            ctx, valid, jnp.asarray)
        lt, pools_t = _step(language_model_forward, tparams, tcfg, pools_t,
                            bt, tokens, ctx, valid, torch.from_numpy)
        for s in range(2):
            np.testing.assert_allclose(lt[s, :valid[s]], lj[s, :valid[s]],
                                       atol=ATOL, rtol=0,
                                       err_msg=f"step {step} slot {s}")
        ctx = ctx + valid
        if step + 1 < n_chunks:
            tokens = rng.integers(0, 64, (2, 8))
        else:
            # greedy next token from each slot's last valid row
            tokens = lj[np.arange(2), valid - 1].argmax(-1).reshape(2, 1)


def test_weights_check_the_tree_against_the_config():
    _, jparams, tmodel, _ = _models("llama")
    tree = jax.device_get(jparams)
    with pytest.raises(ValueError):
        params_from_jax(tree, llama_config("tiny", **dict(
            _cfg_kwargs("llama"), num_attention_heads_kv=2)))
    bad = dict(tree)
    del bad["lm_head"]
    with pytest.raises(KeyError):
        params_from_jax(bad, tmodel.cfg)
    bf16 = jax.tree_util.tree_map(lambda a: np.asarray(a, jnp.bfloat16), tree)
    out = params_from_jax(bf16, tmodel.cfg, device="cpu")
    assert out["lm_head"]["weight"].dtype == torch.bfloat16
    np.testing.assert_allclose(
        out["lm_head"]["weight"].float().numpy(),
        np.asarray(bf16["lm_head"]["weight"], np.float32))


def test_unported_features_raise():
    with pytest.raises(NotImplementedError):
        LlamaModel(llama_config("tiny", num_experts=4), device="cpu")
    jmodel, jparams, tmodel, tparams = _models("llama")
    toks = torch.zeros(1, 4, dtype=torch.long)
    # only the serving engine's paged KV cache is ported
    with pytest.raises(NotImplementedError):
        tmodel(tparams, toks, kv_caches=[{"k": None, "v": None,
                                          "index": 0}] * 2)
