"""The port's training path against the JAX package's, from the same
JAX-initialised params carried across by megatron_llm_torch/weights.py:
the per-token loss and every param grad on a tiny Llama, a GQA config
and a Mistral sliding-window config, with flash attention on and off
(on the CPU the port takes the kernels' plain versions, the JAX package
its reference math); then three steps of ``build_train_step`` with two
micro-batches in both packages from the same params and batches.
fp32; loss and grads atol 1e-5 (grads relative to each leaf's max-abs),
params and metrics after the steps within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import ParallelConfig as JaxParallelConfig
from megatron_llm_tpu.config import TrainConfig as JaxTrainConfig
from megatron_llm_tpu.models.llama import LlamaModel as JaxLlama
from megatron_llm_tpu.models.llama import llama_config as jax_llama_config
from megatron_llm_tpu.optimizer import MegatronOptimizer as JaxOptimizer
from megatron_llm_tpu.training import build_train_step as jax_train_step
from megatron_llm_torch.config import ParallelConfig, TrainConfig
from megatron_llm_torch.models.llama import LlamaModel, llama_config
from megatron_llm_torch.optimizer import MegatronOptimizer
from megatron_llm_torch.training import build_train_step
from megatron_llm_torch.tree import tree_leaves_with_path, tree_map
from megatron_llm_torch.weights import params_from_jax, params_to_numpy

torch.set_num_threads(1)
ATOL = 1e-5
CONFIGS = {
    "llama": dict(),
    "gqa": dict(num_attention_heads_kv=2),
    "mistral_window": dict(sliding_window_size=5),
}
VOCAB, SEQ = 64, 16


def _kwargs(name, flash):
    return dict(num_layers=2, hidden_size=64, num_attention_heads=4,
                ffn_hidden_size=96, padded_vocab_size=VOCAB,
                seq_length=SEQ, max_position_embeddings=SEQ,
                use_flash_attn=flash, **CONFIGS[name])


def _models(name, flash):
    kw = _kwargs(name, flash)
    jmodel = JaxLlama(jax_llama_config("tiny", **kw))
    jparams = jmodel.init(jax.random.PRNGKey(7))
    tcfg = llama_config("tiny", **kw)
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    return jmodel, jparams, LlamaModel(tcfg, device="cpu"), tparams


def _batch(seed, shape):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, VOCAB, shape).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=-1),
            "loss_mask": (rng.random(shape) > 0.2).astype(np.float32)}


def _flat(tree):
    return {"/".join(p): np.asarray(v, np.float32)
            for p, v in tree_leaves_with_path(tree)}


@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_and_param_grads_match_jax(name, flash):
    jmodel, jparams, tmodel, tparams = _models(name, flash)
    b = _batch(0, (2, SEQ))
    w = np.random.default_rng(1).standard_normal((2, SEQ)).astype(
        np.float32)

    def jloss(p):
        tok = jmodel(p, jnp.asarray(b["tokens"]),
                     labels=jnp.asarray(b["labels"]), train=True)
        return jnp.sum(tok * w), tok

    (_, want_tok), want_g = jax.value_and_grad(jloss, has_aux=True)(jparams)
    leaves = [p.requires_grad_(True) for _, p in
              tree_leaves_with_path(tparams)]
    tok = tmodel(tparams, torch.from_numpy(b["tokens"]),
                 labels=torch.from_numpy(b["labels"]), train=True)
    np.testing.assert_allclose(tok.detach().numpy(), np.asarray(want_tok),
                               atol=ATOL, rtol=0)
    grads = torch.autograd.grad((tok * torch.from_numpy(w)).sum(), leaves)
    got = {"/".join(p): g.numpy() for (p, _), g in
           zip(tree_leaves_with_path(tparams), grads)}
    want = _flat(jax.device_get(want_g))
    assert got.keys() == want.keys()
    for k in want:
        scale = max(np.abs(want[k]).max(), 1.0)
        np.testing.assert_allclose(got[k], want[k], atol=ATOL * scale,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("name", ["llama", "mistral_window"])
def test_three_train_steps_match_jax(name):
    jmodel, jparams, tmodel, tparams = _models(name, True)
    kw = dict(micro_batch_size=2, global_batch_size=4, train_iters=3,
              lr=1e-4, weight_decay=0.01, clip_grad=1.0)
    jopt = JaxOptimizer(JaxTrainConfig(**kw))
    topt = MegatronOptimizer(TrainConfig(**kw))
    jstep = jax_train_step(jmodel, jopt, JaxParallelConfig(), 2)
    tstep = build_train_step(tmodel, topt, ParallelConfig(), 2)
    # the JAX step donates its params and state: work on a copy
    jp = jax.tree_util.tree_map(jnp.array, jparams)
    js, ts = jopt.init(jp), topt.init(tparams)
    for it in range(3):
        b = _batch(10 + it, (2, 2, SEQ))
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()},
                           jax.random.PRNGKey(it), 1e-4, 0.01)
        tparams, ts, tm = tstep(tparams, ts,
                                {k: torch.from_numpy(v)
                                 for k, v in b.items()}, None, 1e-4, 0.01)
        for key in ("lm loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       atol=ATOL, rtol=0,
                                       err_msg=f"{key} step {it}")
        assert tm["skipped_iter"] == int(jm["skipped_iter"]) == 0
    got = _flat(params_to_numpy(tparams))
    want = _flat(jax.device_get(jp))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0,
                                   err_msg=k)
    m_got = _flat(params_to_numpy(ts.exp_avg))
    m_want = _flat(jax.device_get(js.exp_avg))
    for k in m_want:
        np.testing.assert_allclose(m_got[k], m_want[k], atol=ATOL, rtol=0,
                                   err_msg=k)


def test_eval_step_matches_the_train_losses():
    _, _, tmodel, tparams = _models("gqa", True)
    opt = MegatronOptimizer(TrainConfig())
    b = {k: torch.from_numpy(v) for k, v in _batch(3, (2, 2, SEQ)).items()}
    ev = build_train_step(tmodel, opt, ParallelConfig(), 2,
                          forward_only=True)
    loss = ev(tparams, b, None)
    tr = build_train_step(tmodel, opt, ParallelConfig(), 2)
    _, _, m = tr(tree_map(lambda t: t.clone(), tparams), opt.init(tparams),
                 b, None, 0.0, 0.0)
    np.testing.assert_allclose(float(loss), float(m["lm loss"]), atol=1e-6)


def test_unported_training_options_raise():
    # dropout, recompute, the fused LM-head cross entropy and the chunked
    # attention train since they were ported (test_torch_dropout.py,
    # test_torch_recompute.py, test_torch_fused_ce.py,
    # test_torch_chunked_attention.py); tensor, sequence and data
    # parallelism, ZeRO-1 and the pipeline run (test_torch_tp_*.py,
    # test_torch_dp.py, test_torch_pp.py); the other parallel degrees
    # still raise
    ParallelConfig(tensor_model_parallel_size=2, sequence_parallel=True)
    ParallelConfig(data_parallel_size=2, use_distributed_optimizer=True)
    ParallelConfig(tensor_model_parallel_size=2,
                   pipeline_model_parallel_size=2)
    with pytest.raises(NotImplementedError):
        ParallelConfig(pipeline_model_parallel_size=2, num_slices=2)
    with pytest.raises(NotImplementedError):
        ParallelConfig(data_parallel_size=2, context_parallel_size=2)
