"""The port's legacy generate path against the JAX package's, on the same
params (the JAX init, carried across by ``weights.params_from_jax``) and
the same numpy-seeded prompts, in fp32 on the CPU:

* ``generate_tokens``: greedy tokens equal and logprobs within 1e-5 over
  linear and rolling caches (a tiny Mistral-shaped model, window 8, with
  prompts longer than the window), the micro-batched prefill and a
  padded ``cache_len``; over int8 linear caches the logits of each step
  within 1e-3, the tokens equal and the logprobs within 1e-3;
* the rolling ring at a prefill longer than the window and at a chunk of
  exactly the window: the JAX ring's logits within 1e-5, and the port's
  ring equal to its linear cache within 1e-5;
* ``beam_search``: the beams equal and their scores within 1e-5;
* ``_prefill_chunks`` equal over a table of (b, n, threshold);
* stop ids, stop pairs, ban pairs and ``top_p_decay`` on greedy rows:
  tokens equal;
* ``generate`` and the reference-signature wrappers: texts, segments and
  logprobs equal; sampled rows draw from a seeded generator (the same
  seed gives the same tokens; the JAX PRNG's draws differ by design).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.models.gpt import GPTModel as JaxGPT
from megatron_llm_tpu.models.llama import LlamaModel as JaxLlama
from megatron_llm_tpu.models.llama import llama_config as jax_llama_config
from megatron_llm_tpu.models.mistral import (
    mistral_config as jax_mistral_config)
from megatron_llm_tpu.text_generation import api as japi
from megatron_llm_tpu.text_generation import generation as jgen
from megatron_llm_torch.models.gpt import GPTModel
from megatron_llm_torch.models.llama import LlamaModel, llama_config
from megatron_llm_torch.models.mistral import mistral_config
from megatron_llm_torch.text_generation import api as tapi
from megatron_llm_torch.text_generation import generation as tgen
from megatron_llm_torch.weights import params_from_jax

torch.set_num_threads(1)
WINDOW = 8
# the JAX cached forward, compiled (its eager ops cost seconds a call)
_jax_forward = jax.jit(jgen._forward_with_cache, static_argnums=(0, 4))
KW = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
          ffn_hidden_size=160, padded_vocab_size=96, seq_length=64,
          max_position_embeddings=64, use_flash_attn=False)


def _pair(family):
    """(JAX model, JAX params, port model, port params) in fp32."""
    if family == "llama":
        jmodel = JaxLlama(jax_llama_config("tiny", **KW))
        tmodel = LlamaModel(llama_config("tiny", **KW), device="cpu")
    else:
        kw = dict(KW, num_attention_heads_kv=2, sliding_window_size=WINDOW)
        jmodel = JaxGPT(jax_mistral_config("tiny", **kw))
        tmodel = GPTModel(mistral_config("tiny", **kw), device="cpu")
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.device_get(jparams), tmodel.cfg,
                              device="cpu")
    return jmodel, jparams, tmodel, tparams


@pytest.fixture(scope="module")
def llama():
    return _pair("llama")


@pytest.fixture(scope="module")
def mistral():
    return _pair("mistral")


def _prompts(seed, b=3, width=13, lens=(13, 10, 11)):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, 96, (b, width)).astype(np.int32)
    return toks, np.asarray(lens, np.int32)


def _both(pair, toks, lens, **kw):
    jmodel, jparams, tmodel, tparams = pair
    min_len = int(lens.min())
    jt, _, jlp = jgen.generate_tokens(
        jmodel, jparams, jnp.asarray(toks), jnp.asarray(lens),
        jax.random.PRNGKey(0), min_prompt_len=min_len, **kw)
    tt, _, tlp = tgen.generate_tokens(
        tmodel, tparams, torch.from_numpy(toks), torch.from_numpy(lens),
        None, min_prompt_len=min_len, **kw)
    return np.asarray(jt), tt.numpy(), np.asarray(jlp), tlp.numpy()


@pytest.mark.parametrize("case", [
    dict(),                                         # linear
    dict(batch_times_seqlen_threshold=20),          # 3 prefill chunks
    dict(cache_len=40),                             # padded cache
])
def test_greedy_tokens_and_logprobs_equal_jax_linear(llama, case):
    toks, lens = _prompts(0)
    jt, tt, jlp, tlp = _both(llama, toks, lens, max_new_tokens=9,
                             greedy=True, return_log_probs=True, **case)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tlp, jlp, rtol=0, atol=1e-5)


def test_greedy_tokens_equal_jax_rolling_past_the_window(mistral):
    """Prompts of 10-13 ids and 9 new tokens through a window of 8: the
    prefill chunk (10 tokens) is longer than the ring."""
    toks, lens = _prompts(1)
    for rolling in (True, False):
        jt, tt, jlp, tlp = _both(mistral, toks, lens, max_new_tokens=9,
                                 greedy=True, return_log_probs=True,
                                 rolling_cache=rolling)
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_allclose(tlp, jlp, rtol=0, atol=1e-5)


def test_int8_linear_cache_logits_and_tokens_equal_jax(llama):
    jmodel, jparams, tmodel, tparams = llama
    toks, lens = _prompts(2)
    # step logits within 1e-3: prefill, then 2 decode steps
    jc = jgen.init_kv_caches(jmodel.cfg, 3, 20, quantized=True)
    tc = tgen.init_kv_caches(tmodel.cfg, 3, 20, quantized=True,
                             device="cpu")
    seq = toks[:, :10]
    for step in range(3):
        start = 0 if step == 0 else 9 + step
        part = seq if step == 0 else seq[:, -1:]
        jl, jc = _jax_forward(jmodel, jparams, jnp.asarray(part), jc, start)
        with torch.no_grad():
            tl, tc = tgen._forward_with_cache(
                tmodel, tparams, torch.from_numpy(part).long(), tc, start)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-3)
        nxt = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
        seq = np.concatenate([seq, nxt[:, None]], axis=1)
    for name in ("k_q", "v_q"):
        np.testing.assert_array_equal(tc[0][name].numpy(),
                                      np.asarray(jc[0][name]))
    jt, tt, jlp, tlp = _both(llama, toks, lens, max_new_tokens=9,
                             greedy=True, return_log_probs=True,
                             int8_kv_cache=True)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tlp, jlp, rtol=0, atol=1e-3)


@pytest.mark.parametrize("chunks", [(10, 1), (8, 8), (3, 8, 1)],
                         ids=["longer_than_window", "exactly_window",
                              "window_after_ring_filled"])
def test_rolling_ring_matches_jax_and_the_linear_cache(mistral, chunks):
    """Chunked forwards through the ring: a first chunk longer than the
    window (only its last W tokens are written), chunks of exactly W (the
    n >= W rule at the boundary), single tokens after."""
    jmodel, jparams, tmodel, tparams = mistral
    total = sum(chunks)
    toks = np.random.default_rng(3).integers(1, 96, (2, total)).astype(
        np.int32)
    jr = jgen.init_kv_caches(jmodel.cfg, 2, total, rolling=True)
    tr = tgen.init_kv_caches(tmodel.cfg, 2, total, rolling=True,
                             device="cpu")
    tl_lin = tgen.init_kv_caches(tmodel.cfg, 2, total, device="cpu")
    assert tr[0]["k"].shape[1] == WINDOW
    start = 0
    for n in chunks:
        part = toks[:, start:start + n]
        jl, jr = _jax_forward(jmodel, jparams, jnp.asarray(part), jr, start)
        with torch.no_grad():
            ring, tr = tgen._forward_with_cache(
                tmodel, tparams, torch.from_numpy(part).long(), tr, start)
            lin, tl_lin = tgen._forward_with_cache(
                tmodel, tparams, torch.from_numpy(part).long(), tl_lin,
                start)
        np.testing.assert_allclose(ring.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(ring.numpy(), lin.numpy(), rtol=0,
                                   atol=1e-5)
        start += n
    np.testing.assert_allclose(tr[0]["k"].numpy(), np.asarray(jr[0]["k"]),
                               rtol=0, atol=1e-6)
    assert tr[0]["index"] == total


@pytest.mark.parametrize("length_penalty", [1.0, 0.6])
def test_beam_search_equals_jax(llama, length_penalty):
    jmodel, jparams, tmodel, tparams = llama
    prompt = np.random.default_rng(4).integers(1, 96, (1, 7)).astype(
        np.int32)
    # an eod the beams meet: the greedy continuation's third token
    eod = int(np.asarray(jgen.greedy_generate(
        jmodel, jparams, jnp.asarray(prompt), jnp.asarray([7]), 4)[0])[0, 9])
    jb, js = jgen.beam_search(jmodel, jparams, jnp.asarray(prompt),
                              beam_size=4, max_new_tokens=6, eod_id=eod,
                              length_penalty=length_penalty)
    tb, ts = tgen.beam_search(tmodel, tparams, torch.from_numpy(prompt),
                              beam_size=4, max_new_tokens=6, eod_id=eod,
                              length_penalty=length_penalty)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("b,n,threshold", [
    (1, 100, 10), (4, 8, None), (4, 8, 32), (4, 8, 31), (6, 5, 12),
    (6, 5, 9), (6, 5, 4), (8, 64, 512), (8, 64, 100), (7, 3, 5),
    (12, 10, 30), (12, 10, 1)])
def test_prefill_chunks_equal_jax(b, n, threshold):
    assert tgen._prefill_chunks(b, n, threshold) == \
        jgen._prefill_chunks(b, n, threshold)


def test_stop_and_ban_rules_and_top_p_decay_on_greedy_rows(llama):
    """Rules chosen from the plain greedy output so that each fires: a
    stop id, a stop bigram and a banned pair; top_p's decay leaves greedy
    rows as they are.  Tokens equal the JAX package's."""
    toks, lens = _prompts(5)
    jt, _, _, _ = _both(llama, toks, lens, max_new_tokens=9, greedy=True)
    row = jt[0]
    rules = [
        dict(eod_id=int(row[15])),
        dict(extra_stop_ids=(int(row[14]),)),
        dict(stop_pairs=((int(row[13]), int(row[14])),)),
        dict(ban_pairs=((int(row[13]), int(row[14])),)),
        dict(top_p=0.9, top_p_decay=0.5, top_p_bound=0.2),
    ]
    for kw in rules:
        jt2, tt2, jlp, tlp = _both(llama, toks, lens, max_new_tokens=9,
                                   greedy=True, return_log_probs=True, **kw)
        np.testing.assert_array_equal(tt2, jt2)
        np.testing.assert_allclose(tlp, jlp, rtol=0, atol=1e-5)
    # the ban moved row 0 off its greedy token at that position
    assert tt2.shape == jt.shape


class _Tok:
    """A numeric tokenizer: text is space-separated ids."""
    vocab_size = 96
    eod = 95
    pad = 0

    def tokenize(self, text):
        return [int(t) % 96 for t in text.split()]

    def detokenize(self, ids):
        return " ".join(str(int(i)) for i in ids)


def test_generate_and_post_process_equal_jax(llama):
    jmodel, jparams, tmodel, tparams = llama
    prompts = ["5 17 23 4 9 11", "8 3 60 2", "40 41 42 43 44 45 46 47"]
    kw = dict(tokens_to_generate=7, return_output_log_probs=True,
              top_k_sampling=1, add_BOS=True)
    want = japi.generate_and_post_process(jmodel, jparams, _Tok(),
                                          prompts, **kw)
    got = tapi.generate_and_post_process(tmodel, tparams, _Tok(), prompts,
                                         **kw)
    assert got[0] == want[0] and got[1] == want[1] and got[3] == want[3]
    np.testing.assert_allclose(got[2], np.asarray(want[2]), rtol=0,
                               atol=1e-5)
    texts, scores = tapi.beam_search_and_post_process(
        tmodel, tparams, _Tok(), prompts[:1], tokens_to_generate=5,
        beam_size=3, stop_token=7)
    jtexts, jscores = japi.beam_search_and_post_process(
        jmodel, jparams, _Tok(), prompts[:1], tokens_to_generate=5,
        beam_size=3, stop_token=7)
    assert texts == jtexts
    np.testing.assert_allclose(scores, jscores, rtol=0, atol=1e-5)


def test_rolling_cache_auto_rule_and_int8_note(mistral, capsys):
    """``rolling_cache=None`` turns the ring on past the window (tokens
    equal the JAX package's either way) and then ignores int8 with the
    JAX package's note."""
    jmodel, jparams, tmodel, tparams = mistral
    prompts = ["1 2 3 4 5 6 7 8 9 10"]
    got = tapi.generate(tmodel, tparams, _Tok(), prompts, 6, greedy=True,
                        int8_kv_cache=True)
    assert "int8_kv_cache is ignored" in capsys.readouterr().out
    want = japi.generate(jmodel, jparams, _Tok(), prompts, 6, greedy=True,
                         int8_kv_cache=True)
    assert got[1] == want[1]


def test_sampled_rows_follow_the_seed(llama):
    _, _, tmodel, tparams = llama
    prompts = ["5 17 23 4 9 11", "8 3 60 2"]
    runs = [tapi.generate(tmodel, tparams, _Tok(), prompts, 8, top_k=5,
                          top_p=0.9, temperature=0.8, seed=s)[1]
            for s in (3, 3, 4)]
    assert runs[0] == runs[1]
    assert all(0 <= t < 96 for row in runs[2] for t in row)
