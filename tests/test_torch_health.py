"""The port's model-health observatory (megatron_llm_torch/health.py and
the optimizer step's ``layer_stats``) against the JAX package's, on the
same JAX-initialised params carried across by
megatron_llm_torch/weights.py: the group names of the Llama, Falcon,
GPT-2 and Mixtral trees; ``compute_layer_stats`` on the same params,
grads and updates (a NaN row included); the optimizer step's per-group
stats, fp32 and bf16 params, on a clean and on a skipped non-finite step
(the NaN localizer's record), with the same params as a step without
stats; the train step's ``layer_stats`` metric; the derived params norm;
and the host-side record helpers.  fp32 stats rtol 1e-5."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import megatron_llm_tpu.models as jm
from megatron_llm_tpu import health as jax_health
from megatron_llm_tpu.config import ParallelConfig as JaxParallelConfig
from megatron_llm_tpu.config import TrainConfig as JaxTrainConfig
from megatron_llm_tpu.optimizer import MegatronOptimizer as JaxOptimizer
from megatron_llm_tpu.training import build_train_step as jax_train_step
import megatron_llm_torch.models as tm
from megatron_llm_torch import health
from megatron_llm_torch.config import ParallelConfig, TrainConfig
from megatron_llm_torch.optimizer import MegatronOptimizer
from megatron_llm_torch.optimizer.optimizer import global_grad_norm
from megatron_llm_torch.training import build_train_step
from megatron_llm_torch.tree import tree_leaves_with_path, tree_map
from megatron_llm_torch.weights import params_from_jax

torch.set_num_threads(1)
RTOL = 1e-5
VOCAB, SEQ = 64, 16
TINY = dict(num_layers=2, hidden_size=32, num_attention_heads=4,
            ffn_hidden_size=48, padded_vocab_size=VOCAB, seq_length=SEQ,
            max_position_embeddings=SEQ)
# name -> (model class, config function, overrides)
FAMILIES = {
    "llama": ("LlamaModel", "llama_config", {}),
    "falcon": ("FalconModel", "falcon_config", {}),
    "gpt2": ("GPTModel", "gpt2_config",
             dict(hidden_dropout=0.0, attention_dropout=0.0)),
    "mixtral": ("MixtralModel", "mixtral_config",
                dict(num_experts=4, num_attention_heads_kv=2)),
}


def _models(name):
    cls, cfg_fn, kw = FAMILIES[name]
    kw = dict(TINY, **kw)
    jmodel = getattr(jm, cls)(getattr(jm, cfg_fn)("tiny", **kw))
    jparams = jmodel.init(jax.random.PRNGKey(5))
    tcfg = getattr(tm, cfg_fn)("tiny", **kw)
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    return jmodel, jparams, getattr(tm, cls)(tcfg, device="cpu"), tparams


def _like(tparams, seed, scale=1.0, nan_row=False):
    """A tree shaped like ``tparams`` of seeded normals (numpy), as (JAX
    tree, port tree); ``nan_row`` puts a NaN into layer row 1 of the
    first stacked leaf."""
    rng = np.random.default_rng(seed)
    flat = {}
    for path, p in tree_leaves_with_path(tparams):
        a = (rng.standard_normal(tuple(p.shape)) * scale).astype(np.float32)
        flat[path] = a
    if nan_row:
        path = next(p for p in flat if "layers" in p)
        flat[path][1].reshape(-1)[3] = np.nan

    def build(node, prefix=()):
        if isinstance(node, dict):
            return {k: build(v, prefix + (k,)) for k, v in node.items()}
        return flat[prefix]

    host = build(tparams)
    return (jax.tree_util.tree_map(jnp.asarray, host),
            tree_map(lambda a: torch.from_numpy(a.copy()), host))


def _assert_stats(got, want):
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy()
        w = np.asarray(want[k])
        if k == "nonfinite_grads":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0, err_msg=k)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_group_names_match_jax(name):
    _, jparams, _, tparams = _models(name)
    want = jax_health.layer_group_names(jparams)
    assert health.layer_group_names(tparams) == want
    assert want[:3] == ["embedding", "layer_000", "layer_001"]


@pytest.mark.parametrize("nan_row", [False, True])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_compute_layer_stats_matches_jax(name, nan_row):
    _, jparams, _, tparams = _models(name)
    jg, tg = _like(tparams, 1, nan_row=nan_row)
    ju, tu = _like(tparams, 2, scale=1e-3)
    want = jax_health.compute_layer_stats(jparams, jg, ju)
    got = health.compute_layer_stats(tparams, tg, tu)
    _assert_stats(got, want)
    if nan_row:
        assert got["nonfinite_grads"].tolist()[2] == 1     # layer_001


def _opt_kw():
    return dict(micro_batch_size=2, global_batch_size=2, train_iters=3,
                lr=1e-3, weight_decay=0.01, clip_grad=0.5)


@pytest.mark.parametrize("skipped", [False, True])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("name", ["llama", "mixtral"])
def test_optimizer_layer_stats_match_jax(name, dtype, skipped):
    _, jparams, _, tparams = _models(name)
    if dtype == "bf16":
        jparams = jax.tree_util.tree_map(
            lambda p: p.astype(jnp.bfloat16), jparams)
        tparams = tree_map(lambda p: p.to(torch.bfloat16), tparams)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    jopt = JaxOptimizer(JaxTrainConfig(**_opt_kw()), params_dtype=jdt)
    topt = MegatronOptimizer(TrainConfig(**_opt_kw()), params_dtype=tdt)
    jg, tg = _like(tparams, 3, nan_row=skipped)
    js, ts = jopt.init(jparams), topt.init(tparams)
    jp, js2, jstats = jopt.step(jparams, jg, js, 1e-3, 0.01,
                                layer_stats=True)
    plain = tree_map(lambda p: p.clone(), tparams)
    tp, ts2, tstats = topt.step(tparams, tg, ts, 1e-3, 0.01,
                                layer_stats=True)
    assert bool(tstats["found_inf"]) is skipped
    _assert_stats(tstats["layer_stats"], jstats["layer_stats"])
    if skipped:
        # the NaN localizer's record: the poisoned row, no update
        assert tstats["layer_stats"]["nonfinite_grads"].tolist()[2] == 1
        assert not tstats["layer_stats"]["update_norm"].any()
        return
    # the stats change nothing: the same params as a step without them
    plain, _, pst = topt.step(plain, tg, topt.init(plain), 1e-3, 0.01)
    assert "layer_stats" not in pst
    for (path, a), (_, b) in zip(tree_leaves_with_path(tp),
                                 tree_leaves_with_path(plain)):
        assert torch.equal(a, b), path


def test_train_step_layer_stats_match_jax():
    jmodel, jparams, tmodel, tparams = _models("llama")
    kw = dict(micro_batch_size=2, global_batch_size=4, train_iters=2,
              lr=1e-3, clip_grad=1.0)
    jopt = JaxOptimizer(JaxTrainConfig(**kw))
    topt = MegatronOptimizer(TrainConfig(**kw))
    jstep = jax_train_step(jmodel, jopt, JaxParallelConfig(), 2,
                           log_layer_stats=True)
    tstep = build_train_step(tmodel, topt, ParallelConfig(), 2,
                             log_layer_stats=True)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, VOCAB, (2, 2, SEQ)).astype(np.int32)
    b = {"tokens": toks, "labels": np.roll(toks, -1, axis=-1),
         "loss_mask": np.ones(toks.shape, np.float32)}
    jp = jax.tree_util.tree_map(jnp.array, jparams)
    _, _, jm_ = jstep(jp, jopt.init(jp),
                      {k: jnp.asarray(v) for k, v in b.items()},
                      jax.random.PRNGKey(0), 1e-3, 0.0)
    _, _, tm_ = tstep(tparams, topt.init(tparams),
                      {k: torch.from_numpy(v) for k, v in b.items()},
                      None, 1e-3, 0.0)
    _assert_stats(tm_["layer_stats"], jax.device_get(jm_["layer_stats"]))


def test_derived_params_norm_equals_the_params_norm():
    _, _, _, tparams = _models("gpt2")
    jg, tg = _like(tparams, 6)
    names = health.layer_group_names(tparams)
    stats = health.compute_layer_stats(tparams, tg)
    rec = health.to_record(names, {k: v.tolist() for k, v in stats.items()})
    want = float(global_grad_norm(tparams))
    assert math.isclose(health.derived_params_norm(rec), want,
                        rel_tol=1e-6)


def test_record_helpers_are_the_jax_packages():
    names = ["embedding", "layer_000", "layer_001", "lm_head"]
    stats = {"grad_norm": [1.0, float("nan"), 40.0, 1.5],
             "param_norm": [2.0, 3.0, 0.0, float("inf")],
             "update_norm": [1e-3, 2e-3, 3e-3, 4e-3],
             "nonfinite_grads": [0, 7, 0, 0]}
    for kw in ({}, {"top_k": 1, "outlier_factor": 2.0}):
        want = jax_health.to_record(names, stats)
        got = health.to_record(names, stats)
        assert got == want
        assert health.find_offenders(got, **kw) == \
            jax_health.find_offenders(want, **kw)
        assert health.describe_offenders(health.find_offenders(got, **kw)) \
            == jax_health.describe_offenders(
                jax_health.find_offenders(want, **kw))
    assert health.describe_offenders(
        health.find_offenders({"groups": []})) is None
