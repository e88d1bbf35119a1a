"""Speculative decoding in the port's engine against the JAX package's:
the same tiny params (carried across by weights.py), the same
EngineConfig with ``speculative`` on, the same repetitive greedy prompts,
single-stepped on the CPU.  The port with speculation on must give the
JAX engine's tokens and its drafted and accepted counts, and the tokens
of the port with speculation off.  Also: a sampled slot's stream does not
change with speculation, Falcon's MQA over int8 pools, and a verify batch
with inactive slots (vlens 0)."""

import jax
import pytest
import torch

from megatron_llm_tpu.models.falcon import FalconModel as JaxFalcon
from megatron_llm_tpu.models.falcon import falcon_config as jax_falcon_config
from megatron_llm_tpu.models.llama import LlamaModel as JaxLlama
from megatron_llm_tpu.models.llama import llama_config as jax_llama_config
from megatron_llm_tpu.serving import EngineConfig as JaxEngineConfig
from megatron_llm_tpu.serving import InferenceEngine as JaxEngine
from megatron_llm_tpu.serving import SamplingParams as JaxSamplingParams
from megatron_llm_torch.models.falcon import FalconModel, falcon_config
from megatron_llm_torch.models.llama import LlamaModel, llama_config
from megatron_llm_torch.serving import (
    EngineConfig,
    InferenceEngine,
    SamplingParams,
)
from megatron_llm_torch.weights import params_from_jax

torch.set_num_threads(1)
KW = dict(num_layers=2, seq_length=64, max_position_embeddings=64,
          padded_vocab_size=64)
ENGINE_KW = dict(num_slots=4, block_size=8, prefill_chunk=16,
                 max_model_len=64)
# repetitive prompts: each repeats a short motif, so prompt lookup drafts
PROMPTS = [([3, 9, 27, 17] * 5)[:n] for n in (18, 11)] + [
    ([5, 6, 7] * 8)[:20], [40, 41, 42, 43, 40, 41, 42]]


def _pair(jax_cls, jax_cfg_fn, cls, cfg_fn):
    jmodel = jax_cls(jax_cfg_fn("tiny", use_flash_attn=False, **KW))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = cfg_fn("tiny", **KW)
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    return jmodel, jparams, cls(tcfg, device="cpu"), tparams


@pytest.fixture(scope="module")
def llama():
    return _pair(JaxLlama, jax_llama_config, LlamaModel, llama_config)


@pytest.fixture(scope="module")
def falcon():
    return _pair(JaxFalcon, jax_falcon_config, FalconModel, falcon_config)


def _drive(engine, reqs, limit=2000):
    for _ in range(limit):
        if all(r.state == "done" for r in reqs):
            return
        engine.step()
    raise AssertionError("engine did not finish the requests")


def _serve(engine, sp_cls, prompts, n=16, **sp):
    reqs = [engine.submit(p, sp_cls(max_new_tokens=n,
                                    **(sp or dict(temperature=0.0))))
            for p in prompts]
    _drive(engine, reqs)
    return reqs


@pytest.mark.parametrize("int8", [False, True], ids=["llama", "falcon_int8"])
def test_speculative_greedy_tokens_and_counts_match_jax(llama, falcon, int8):
    jmodel, jparams, tmodel, tparams = falcon if int8 else llama
    cfg = dict(ENGINE_KW, speculative=True, draft_k=4, int8_kv_cache=int8)
    jeng = JaxEngine(jmodel, jparams, JaxEngineConfig(**cfg))
    teng = InferenceEngine(tmodel, tparams, EngineConfig(**cfg))
    plain = InferenceEngine(tmodel, tparams,
                            EngineConfig(**dict(cfg, speculative=False)))
    want = _serve(jeng, JaxSamplingParams, PROMPTS)
    got = _serve(teng, SamplingParams, PROMPTS)
    off = _serve(plain, SamplingParams, PROMPTS)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [r.tokens for r in got] == [r.tokens for r in off]
    assert [(r.spec_drafted, r.spec_accepted) for r in got] == \
        [(r.spec_drafted, r.spec_accepted) for r in want]
    js, ts = jeng.stats(), teng.stats()
    assert ts["speculative"] is True and ts["draft_k"] == 4
    for key in ("drafted_tokens", "accepted_tokens", "decode_steps",
                "tokens_generated"):
        assert ts[key] == js[key], key
    assert ts["accepted_tokens"] > 0
    # accepted drafts save steps: fewer verify steps than plain decodes
    assert ts["decode_steps"] < plain.stats()["decode_steps"]
    assert plain.stats()["speculative"] is False


def test_sampled_slot_stream_is_the_same_with_speculation(llama):
    """A sampled request beside drafting greedy ones: with speculation on
    its generator is drawn once a step, as in the decode program, so its
    tokens equal the speculation-off run's; the greedy ones' too."""
    _, _, tmodel, tparams = llama
    sp = dict(temperature=1.0, top_k=20, seed=11)
    out = []
    for spec in (False, True):
        eng = InferenceEngine(tmodel, tparams,
                              EngineConfig(**ENGINE_KW, speculative=spec))
        reqs = [eng.submit(PROMPTS[0], SamplingParams(max_new_tokens=16,
                                                      **sp)),
                eng.submit(PROMPTS[2], SamplingParams(max_new_tokens=16,
                                                      temperature=0.0))]
        _drive(eng, reqs)
        out.append(([r.tokens for r in reqs], reqs[0].spec_drafted,
                    reqs[1].spec_drafted))
    assert out[1][0] == out[0][0]
    assert out[1][1] == 0 and out[1][2] > 0     # only the greedy one drafts


def test_verify_batch_with_inactive_slots(llama, monkeypatch):
    """Two requests in four slots: every verify step carries inactive
    rows (vlens 0, context 0) beside drafting ones, and the tokens are
    the plain engine's."""
    _, _, tmodel, tparams = llama
    seen = []
    eng = InferenceEngine(tmodel, tparams,
                          EngineConfig(**ENGINE_KW, speculative=True))
    impl = eng._verify_impl

    def spy(params, pages, tokens, context_lens, block_tables, vlens,
            *rest):
        seen.append((vlens.copy(), context_lens.copy()))
        return impl(params, pages, tokens, context_lens, block_tables,
                    vlens, *rest)

    monkeypatch.setattr(eng, "_verify_impl", spy)
    got = _serve(eng, SamplingParams, PROMPTS[:2])
    plain = InferenceEngine(tmodel, tparams, EngineConfig(**ENGINE_KW))
    want = _serve(plain, SamplingParams, PROMPTS[:2])
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert seen and all((v == 0).sum() >= 2 for v, _ in seen)
    assert any((v > 1).any() for v, _ in seen)          # drafts verified
    assert all(((v == 0) & (c == 0)).any() for v, c in seen)


def test_speculation_needs_a_draft(llama):
    _, _, tmodel, tparams = llama
    with pytest.raises(ValueError):
        InferenceEngine(tmodel, tparams, EngineConfig(
            **ENGINE_KW, speculative=True, draft_k=0))


@pytest.mark.parametrize("int8", [False, True], ids=["llama", "falcon_int8"])
def test_speculation_reaches_the_position_table_end(llama, falcon, int8):
    """A drafting request that runs to max_model_len ==
    max_position_embeddings: the verify step's padded rows sit past the
    rotary table's end, and must neither fail the step nor change the
    tokens and counts the JAX engine gives."""
    jmodel, jparams, tmodel, tparams = falcon if int8 else llama
    cfg = dict(ENGINE_KW, speculative=True, draft_k=4, int8_kv_cache=int8)
    assert cfg["max_model_len"] == KW["max_position_embeddings"]
    prompt = PROMPTS[2]
    n = cfg["max_model_len"] - len(prompt)
    want = _serve(JaxEngine(jmodel, jparams, JaxEngineConfig(**cfg)),
                  JaxSamplingParams, [prompt], n=n)
    got = _serve(InferenceEngine(tmodel, tparams, EngineConfig(**cfg)),
                 SamplingParams, [prompt], n=n)
    assert got[0].finish_reason == want[0].finish_reason == "length"
    assert len(got[0].tokens) == len(want[0].tokens) == cfg["max_model_len"]
    assert got[0].tokens == want[0].tokens
    assert (got[0].spec_drafted, got[0].spec_accepted) == \
        (want[0].spec_drafted, want[0].spec_accepted)
    assert got[0].spec_accepted > 0
