"""The port's Mixtral (megatron_llm_torch/models/mixtral.py, the mixture of
experts in every layer) against the JAX package's, from the same
JAX-initialised params carried across by megatron_llm_torch/weights.py:
the logits; one train step's loss, metrics (``moe aux loss`` and, at a
non-zero coefficient, ``moe z loss``) and grads against the JAX
``build_train_step``; recompute (selective, full) equal to none;
``flops_per_token``; the KV decode through the paged caches against the
full forward at capacity 8; and the serving engine's greedy tokens
against the JAX engine's, decode and chunked prefill.  fp32: logits
1e-4, loss and metrics 1e-5, grads 2e-5 of each leaf's max-abs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import ParallelConfig as JaxParallelConfig
from megatron_llm_tpu.config import TrainConfig as JaxTrainConfig
from megatron_llm_tpu.models.language_model import (
    flops_per_token as jax_flops_per_token)
from megatron_llm_tpu.models.mixtral import MixtralModel as JaxMixtral
from megatron_llm_tpu.models.mixtral import mixtral_config as jax_mixtral
from megatron_llm_tpu.optimizer import MegatronOptimizer as JaxOptimizer
from megatron_llm_tpu.serving import EngineConfig as JaxEngineConfig
from megatron_llm_tpu.serving import InferenceEngine as JaxEngine
from megatron_llm_tpu.serving import SamplingParams as JaxSamplingParams
from megatron_llm_tpu.training import build_train_step as jax_train_step
from megatron_llm_torch.config import ParallelConfig, TrainConfig
from megatron_llm_torch.models import MODEL_REGISTRY
from megatron_llm_torch.models.language_model import (
    flops_per_token,
    language_model_forward,
)
from megatron_llm_torch.models.mixtral import MixtralModel, mixtral_config
from megatron_llm_torch.optimizer import MegatronOptimizer
from megatron_llm_torch.serving import (
    EngineConfig,
    InferenceEngine,
    SamplingParams,
)
from megatron_llm_torch.text_generation.generation import (
    init_paged_kv_caches)
from megatron_llm_torch.training import build_train_step
from megatron_llm_torch.tree import tree_leaves_with_path
from megatron_llm_torch.weights import params_from_jax, params_to_numpy

torch.set_num_threads(1)
LOGIT_ATOL, ATOL, GRAD_ATOL = 1e-4, 1e-5, 2e-5
VOCAB, SEQ = 64, 16
KW = dict(num_layers=2, hidden_size=32, num_attention_heads=4,
          num_attention_heads_kv=2, ffn_hidden_size=48, num_experts=4,
          padded_vocab_size=VOCAB, seq_length=SEQ,
          max_position_embeddings=64)


def _models(**kw):
    kw = dict(KW, **kw)
    jmodel = JaxMixtral(jax_mixtral("tiny", use_flash_attn=False, **kw))
    jparams = jmodel.init(jax.random.PRNGKey(3))
    tcfg = mixtral_config("tiny", **kw)
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    return jmodel, jparams, MixtralModel(tcfg, device="cpu"), tparams


def _flat(tree):
    return {"/".join(p): np.asarray(v, np.float32)
            for p, v in tree_leaves_with_path(tree)}


def _batch(seed, shape):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, VOCAB, shape).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=-1),
            "loss_mask": (rng.random(shape) > 0.2).astype(np.float32)}


def test_registry_and_architecture_checks():
    assert MODEL_REGISTRY["mixtral"] is MixtralModel
    with pytest.raises(ValueError, match="sparse MoE"):
        MixtralModel(mixtral_config("tiny", num_experts=0), device="cpu")
    with pytest.raises(ValueError, match="biases"):
        mixtral_config("tiny", add_bias_linear=True)
    with pytest.raises(ValueError, match="moe_top_k"):
        mixtral_config("tiny", moe_top_k=5)
    with pytest.raises(ValueError, match="moe_expert_axis"):
        mixtral_config("tiny", moe_expert_axis="sideways")
    cfg = mixtral_config("8x7B")
    want = jax_mixtral("8x7B")
    for f in dataclasses.fields(cfg):
        if hasattr(want, f.name):
            got, ref = getattr(cfg, f.name), getattr(want, f.name)
            assert getattr(got, "value", got) == getattr(ref, "value",
                                                         ref), f.name


@pytest.mark.parametrize("factor", [1.25, 8.0], ids=["tight", "ample"])
def test_logits_match_jax(factor):
    jmodel, jparams, tmodel, tparams = _models(moe_capacity_factor=factor)
    tokens = np.random.default_rng(0).integers(0, VOCAB, (2, 12))
    want = np.asarray(jmodel(jparams, jnp.asarray(tokens)))
    got = tmodel(tparams, torch.from_numpy(tokens))
    assert isinstance(got, torch.Tensor)        # generation drops the aux
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL, rtol=0)


def test_loss_aux_and_grads_match_jax():
    jmodel, jparams, tmodel, tparams = _models()
    b = _batch(0, (2, SEQ))
    w = np.random.default_rng(1).standard_normal((2, SEQ)).astype(
        np.float32)
    c = np.array([0.25, 0.5], np.float32)

    def jloss(p):
        tok, aux = jmodel(p, jnp.asarray(b["tokens"]),
                          labels=jnp.asarray(b["labels"]), train=True)
        return jnp.sum(tok * w) + jnp.sum(aux * c), (tok, aux)

    (_, (want_tok, want_aux)), want_g = jax.value_and_grad(
        jloss, has_aux=True)(jparams)
    named = tree_leaves_with_path(tparams)
    leaves = [p.requires_grad_(True) for _, p in named]
    tok, aux = tmodel(tparams, torch.from_numpy(b["tokens"]),
                      labels=torch.from_numpy(b["labels"]), train=True)
    np.testing.assert_allclose(tok.detach().numpy(), np.asarray(want_tok),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(aux.detach().numpy(), np.asarray(want_aux),
                               atol=ATOL, rtol=0)
    loss = (tok * torch.from_numpy(w)).sum() + (aux * torch.from_numpy(c)
                                                ).sum()
    grads = torch.autograd.grad(loss, leaves)
    got = {"/".join(p): g.numpy() for (p, _), g in zip(named, grads)}
    want = _flat(jax.device_get(want_g))
    assert got.keys() == want.keys()
    assert "transformer/layers/mlp/router/kernel" in got
    for k in want:
        scale = max(np.abs(want[k]).max(), 1.0)
        np.testing.assert_allclose(got[k], want[k], atol=GRAD_ATOL * scale,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("z_coeff", [0.0, 1e-3])
def test_train_step_matches_jax(z_coeff):
    jmodel, jparams, tmodel, tparams = _models(moe_z_loss_coeff=z_coeff,
                                               moe_aux_loss_coeff=0.05)
    kw = dict(micro_batch_size=2, global_batch_size=4, train_iters=2,
              lr=1e-3, weight_decay=0.01, clip_grad=1.0)
    jopt = JaxOptimizer(JaxTrainConfig(**kw))
    topt = MegatronOptimizer(TrainConfig(**kw))
    jstep = jax_train_step(jmodel, jopt, JaxParallelConfig(), 2)
    tstep = build_train_step(tmodel, topt, ParallelConfig(), 2)
    jp = jax.tree_util.tree_map(jnp.array, jparams)
    js, ts = jopt.init(jp), topt.init(tparams)
    for it in range(2):
        b = _batch(10 + it, (2, 2, SEQ))
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()},
                           jax.random.PRNGKey(it), 1e-3, 0.01)
        tparams, ts, tm = tstep(tparams, ts,
                                {k: torch.from_numpy(v)
                                 for k, v in b.items()}, None, 1e-3, 0.01)
        keys = {"lm loss", "grad_norm", "moe aux loss"} | (
            {"moe z loss"} if z_coeff else set())
        assert set(tm) - {"loss_scale", "skipped_iter"} == keys
        assert set(jm) - {"loss_scale", "skipped_iter"} == keys
        for key in sorted(keys):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       atol=ATOL, rtol=0,
                                       err_msg=f"{key} step {it}")
    got = _flat(params_to_numpy(tparams))
    want = _flat(jax.device_get(jp))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("granularity", ["selective", "full"])
def test_recompute_equals_no_recompute(granularity):
    """The checkpointed layer returns its aux with its output, so the aux
    (and its grads) count once."""
    _, _, tmodel, tparams = _models()
    b = _batch(4, (2, SEQ))

    def run(model):
        named = tree_leaves_with_path(tparams)
        leaves = [p.requires_grad_(True) for _, p in named]
        tok, aux = model(tparams, torch.from_numpy(b["tokens"]),
                         labels=torch.from_numpy(b["labels"]), train=True)
        grads = torch.autograd.grad(tok.sum() + aux.sum(), leaves)
        return tok.detach(), aux.detach(), grads

    plain = run(tmodel)
    again = run(MixtralModel(tmodel.cfg.replace(
        recompute_granularity=granularity), device="cpu"))
    assert torch.equal(plain[0], again[0])
    assert torch.equal(plain[1], again[1])
    for g0, g1 in zip(plain[2], again[2]):
        assert torch.equal(g0, g1)


def test_flops_per_token_matches_jax():
    for size, kw in (("tiny", KW), ("8x7B", {})):
        tcfg = mixtral_config(size, **kw)
        jcfg = jax_mixtral(size, **kw)
        assert flops_per_token(tcfg) == jax_flops_per_token(jcfg)
        assert flops_per_token(tcfg, 1000) == jax_flops_per_token(jcfg, 1000)
    dense = flops_per_token(mixtral_config("tiny", **dict(KW,
                                                          num_experts=0)))
    assert flops_per_token(mixtral_config("tiny", **KW)) > dense


def test_kv_decode_matches_the_full_forward():
    """Prefill 4 tokens a row through the paged caches, then decode 6 one
    at a time (each row routes alone, at the capacity floor): the logits
    equal the one-shot forward's, as the JAX package's KV decode does at
    capacity 8."""
    _, _, tmodel, tparams = _models(moe_capacity_factor=8.0)
    cfg = tmodel.cfg
    toks = np.random.RandomState(0).randint(0, VOCAB, (2, 10))
    full = tmodel(tparams, torch.from_numpy(toks)).numpy()
    bs, M = 8, 2
    pools = init_paged_kv_caches(cfg, 1 + 2 * M, bs, device="cpu")
    bt = torch.arange(1, 1 + 2 * M, dtype=torch.int32).reshape(2, M)
    parts, ctx = [], torch.zeros(2, dtype=torch.int32)
    for lo, hi in [(0, 4)] + [(t, t + 1) for t in range(4, 10)]:
        n = hi - lo
        caches = [dict(p, block_tables=bt, context_lens=ctx,
                       valid_lens=torch.full((2,), n, dtype=torch.int32))
                  for p in pools]
        pos = (ctx.long()[:, None] + torch.arange(n)[None, :])
        with torch.no_grad():
            logits, _ = language_model_forward(
                tparams, torch.from_numpy(toks[:, lo:hi]), pos, None, cfg,
                kv_caches=caches)
        parts.append(logits.numpy())
        ctx = ctx + n
    np.testing.assert_allclose(np.concatenate(parts, axis=1), full,
                               atol=2e-4, rtol=0)


PROMPTS = [[(5 * i + 3) % 60 + 1 for i in range(n)] for n in (3, 17, 30, 9)]
ENGINE_KW = dict(num_slots=4, block_size=8, prefill_chunk=16,
                 max_model_len=64)


@pytest.mark.parametrize("chunk", [16, 64], ids=["chunked", "one_chunk"])
def test_engine_greedy_tokens_match_jax(chunk):
    """The engine's rows: decode [S, 1] (capacity floor 4 a slot) and
    prefill [1, C] with the chunk's padding at its end; the tight
    capacity factor 1.25 makes the prefill chunks drop tokens, so the
    same tokens drop in both packages only with the same row layouts."""
    jmodel, jparams, tmodel, tparams = _models(moe_capacity_factor=1.25)
    cfg = dict(ENGINE_KW, prefill_chunk=chunk)
    jeng = JaxEngine(jmodel, jparams, JaxEngineConfig(**cfg))
    teng = InferenceEngine(tmodel, tparams, EngineConfig(**cfg))

    def serve(engine, sp_cls):
        reqs = [engine.submit(p, sp_cls(max_new_tokens=8, temperature=0.0))
                for p in PROMPTS]
        for _ in range(2000):
            if all(r.state == "done" for r in reqs):
                return reqs
            engine.step()
        raise AssertionError("engine did not finish the requests")

    want = serve(jeng, JaxSamplingParams)
    got = serve(teng, SamplingParams)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    js, ts = jeng.stats(), teng.stats()
    for key in ("decode_steps", "prefill_chunks", "tokens_generated"):
        assert ts[key] == js[key], key
