"""The port's q-chunked exact attention against the JAX package's
(``ops/chunked_attention.py``) on the same numpy inputs: causal and
sliding-window masks, GQA, a sequence that is not a chunk multiple, and
the grads of q, k and v (fp32: forward atol 1e-5, grads 2e-5); bf16
against the port's own fp32 (2e-2).  ``attention`` routes long
flash-eligible inputs with flash off through it (the threshold
monkeypatched small), and the model trains through it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.ops import chunked_attention as jca
from megatron_llm_torch.ops import chunked_attention as tca

torch.set_num_threads(1)


def _qkv(b=2, s=256, nh=4, ng=2, d=32, seed=0):
    rng = np.random.RandomState(seed)
    return tuple((rng.randn(b, s, n, d) * 0.3).astype(np.float32)
                 for n in (nh, ng, ng))


def _jax(q, k, v, **kw):
    return np.asarray(jca.chunked_causal_attention(
        *(jnp.asarray(t) for t in (q, k, v)), **kw))


def _torch(q, k, v, **kw):
    return tca.chunked_causal_attention(
        *(torch.from_numpy(t) for t in (q, k, v)), **kw)


def test_constants_are_the_jax_package_s():
    assert tca.DEFAULT_Q_CHUNK == jca.DEFAULT_Q_CHUNK == 1024
    assert tca.CHUNKED_ATTENTION_MIN_SEQ == jca.CHUNKED_ATTENTION_MIN_SEQ


@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("ng", [4, 2, 1])
def test_matches_jax(window, ng):
    q, k, v = _qkv(ng=ng)
    kw = dict(causal=True, sliding_window=window, softmax_scale=0.125,
              q_chunk_size=64)
    np.testing.assert_allclose(_torch(q, k, v, **kw).numpy(),
                               _jax(q, k, v, **kw), atol=1e-5, rtol=0)


@pytest.mark.parametrize("s", [96, 100])
def test_non_divisible_length_pads_the_last_chunk(s):
    q, k, v = _qkv(s=s)
    kw = dict(causal=True, softmax_scale=0.125, q_chunk_size=64)
    got = _torch(q, k, v, **kw)
    assert got.shape == (2, s, 4, 32)
    np.testing.assert_allclose(got.numpy(), _jax(q, k, v, **kw), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("window", [None, 40])
def test_grads_match_jax(window):
    q, k, v = _qkv(s=160)
    kw = dict(causal=True, sliding_window=window, softmax_scale=0.125,
              q_chunk_size=64)

    def jloss(*a):
        return (jca.chunked_causal_attention(*a, **kw) ** 2).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(t) for t in (q, k, v)))
    ts = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(
        (tca.chunked_causal_attention(*ts, **kw) ** 2).sum(), ts)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5,
                                   rtol=0)


def test_bf16_against_fp32():
    q, k, v = _qkv(s=128)
    kw = dict(causal=True, softmax_scale=0.125, q_chunk_size=32)
    ref = _torch(q, k, v, **kw)
    got = tca.chunked_causal_attention(
        *(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)), **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(), atol=2e-2,
                               rtol=0)


def test_attention_dispatches_long_inputs_to_it(monkeypatch):
    from megatron_llm_torch.config import TransformerConfig
    from megatron_llm_torch.models import transformer as T

    monkeypatch.setattr(tca, "CHUNKED_ATTENTION_MIN_SEQ", 64)
    calls = []
    real = tca.chunked_causal_attention

    def spy(*a, **kw):
        calls.append(a[0].shape[1])
        return real(*a, **kw)

    monkeypatch.setattr(tca, "chunked_causal_attention", spy)
    cfg = TransformerConfig(
        num_layers=1, hidden_size=32, num_attention_heads=4,
        ffn_hidden_size=64, padded_vocab_size=64, seq_length=128,
        max_position_embeddings=128, use_flash_attn=False,
        position_embedding_type="rotary", hidden_dropout=0.0,
        attention_dropout=0.0)
    params = T.init_layer_params(torch.Generator().manual_seed(0), cfg,
                                 torch.float32)
    x = torch.randn(1, 128, 32, generator=torch.Generator().manual_seed(1))
    freqs = T.rotary_freqs(cfg)
    kw = dict(freqs=freqs, attention_mask=None, position_ids=None)
    out = T.attention(x, params["attention"], cfg, **kw)
    assert calls == [128]
    # below the threshold, or with a mask, or with attention dropout in
    # training: core_attention
    T.attention(x[:, :32], params["attention"], cfg, **kw)
    dropping = cfg.replace(attention_dropout=0.1)
    T.attention(x, params["attention"], dropping, train=True,
                dropout_key=5, **kw)
    assert calls == [128]
    # the same numbers as core_attention on the causal mask
    ref = T.attention(x, params["attention"], cfg.replace(
        use_flash_attn=False), **dict(kw, attention_mask=torch.triu(
            torch.ones(128, 128, dtype=torch.bool), 1)[None, None]))
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               atol=1e-5, rtol=0)


def test_model_trains_through_it(monkeypatch):
    from megatron_llm_torch.models.llama import LlamaModel, llama_config

    monkeypatch.setattr(tca, "CHUNKED_ATTENTION_MIN_SEQ", 32)
    kw = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
              num_attention_heads_kv=2, ffn_hidden_size=96,
              padded_vocab_size=64, seq_length=48,
              max_position_embeddings=48)
    flash = LlamaModel(llama_config("tiny", **kw), device="cpu")
    chunked = LlamaModel(llama_config("tiny", use_flash_attn=False, **kw),
                         device="cpu")
    params = flash.init(0)
    toks = torch.from_numpy(np.random.RandomState(2).randint(0, 64, (2, 48)))
    leaves = [p.requires_grad_(True) for p in
              (params["transformer"]["layers"]["attention"]
               ["query_key_value"]["kernel"],)]
    out = []
    for m in (flash, chunked):
        loss = m(params, toks, labels=torch.roll(toks, -1, 1),
                 train=True).mean()
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)[0]))
    np.testing.assert_allclose(out[1][0].numpy(), out[0][0].numpy(),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(out[1][1].numpy(), out[0][1].numpy(),
                               atol=2e-5, rtol=0)
