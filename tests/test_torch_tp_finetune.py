"""The port's ``finetune.py`` at tp 2 + SP against the JAX package's
unsharded train step.  One world of 2 gloo ranks on the CPU
(``_torch_tp_world.py``) runs ``finetune.main`` with
``--tensor_model_parallel_size 2 --sequence_parallel``; the JAX step runs
3 iterations from the port's one-device params of the same ``--seed``
(the init keeps each rank's slices of those draws) on the synthetic
batches the entry point draws from that seed, at the learning rates the
run logged: each iteration's loss and grad norm within 1e-5 relative
(fp32), on both ranks.  Each rank's summary line counts half the params
and the replicated norms whole.  Then, in one process with the layout
set for tp 2 (no process group), each feature that still runs in a
world of one only raises ``NotImplementedError`` at its site, and so do
the parallel degrees the port lacks (data parallelism, ZeRO-1 and the
checkpoints at tp are held in ``test_torch_dp.py`` and
``test_torch_tp_checkpoint.py``)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_tp_world import run_world
from megatron_llm_tpu.config import ParallelConfig as JaxParallelConfig
from megatron_llm_tpu.config import TrainConfig as JaxTrainConfig
from megatron_llm_tpu.models.llama import LlamaModel as JaxLlama
from megatron_llm_tpu.models.llama import llama_config as jax_llama_config
from megatron_llm_tpu.optimizer import MegatronOptimizer as JaxOptimizer
from megatron_llm_tpu.training import build_train_step as jax_train_step
from megatron_llm_torch import finetune, topology
from megatron_llm_torch.config import (
    ParallelConfig,
    train_config_from_args,
    transformer_config_from_args,
)
from megatron_llm_torch.models.llama import LlamaModel
from megatron_llm_torch.weights import params_to_numpy

torch.set_num_threads(1)
ITERS = 3
ARGV = ["--model_name=llama2", "--num_layers=2", "--hidden_size=64",
        "--num_attention_heads=4", "--num_attention_heads_kv=2",
        "--ffn_hidden_size=96", "--seq_length=32",
        "--max_position_embeddings=32", "--micro_batch_size=2",
        "--global_batch_size=4", f"--train_iters={ITERS}", "--lr=1e-3",
        "--vocab_size=256", "--log_interval=1", "--device=cpu", "--seed=5"]
TP_FLAGS = ["--tensor_model_parallel_size=2", "--sequence_parallel",
            "--distributed_backend=gloo"]
RTOL = 1e-5


def _jax_run(lrs):
    """(losses, grad norms) of the JAX step over ITERS iterations from the
    port's one-device init, with the entry point's batches and LRs."""
    args = finetune.parse_args(ARGV, extra_args_provider=finetune.extra_args)
    finetune._apply_model_defaults(args, ARGV)
    cfg = transformer_config_from_args(args)
    params = params_to_numpy(LlamaModel(cfg, device="cpu").init(args.seed))
    size = {k: getattr(cfg, k) for k in (
        "num_layers", "hidden_size", "num_attention_heads",
        "num_attention_heads_kv", "ffn_hidden_size", "padded_vocab_size",
        "seq_length", "max_position_embeddings")}
    jmodel = JaxLlama(jax_llama_config("tiny", use_flash_attn=False, **size))
    tc = dataclasses.asdict(train_config_from_args(args))
    jopt = JaxOptimizer(JaxTrainConfig(**tc))
    num_micro = args.global_batch_size // args.micro_batch_size
    step = jax_train_step(jmodel, jopt, JaxParallelConfig(), num_micro)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state = jopt.init(p)
    rng = np.random.RandomState(args.seed)
    out = []
    for it in range(ITERS):
        toks = rng.randint(0, args.padded_vocab_size,
                           (num_micro, args.micro_batch_size,
                            args.seq_length)).astype(np.int32)
        batch = {"tokens": jnp.asarray(toks),
                 "labels": jnp.asarray(np.roll(toks, -1, axis=-1)),
                 "loss_mask": jnp.ones(toks.shape, jnp.float32)}
        p, state, m = step(p, state, batch, jax.random.PRNGKey(it),
                           lrs[it], args.weight_decay)
        out.append((float(m["lm loss"]), float(m["grad_norm"])))
    return out, params


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    ranks = run_world(tmp_path_factory.mktemp("tp_finetune"), "finetune", 2,
                      dict(argv=ARGV + TP_FLAGS))
    lrs = [ranks[0]["logged"][i + 1]["lr"] for i in range(ITERS)]
    want, params = _jax_run(lrs)
    return ranks, want, params


@pytest.mark.parametrize("iteration", range(1, ITERS + 1))
def test_finetune_at_tp2_sp_matches_the_jax_train_step(run, iteration):
    ranks, want, _ = run
    loss, norm = want[iteration - 1]
    for r, res in enumerate(ranks):
        got = res["logged"][iteration]
        np.testing.assert_allclose(got["loss"], loss, rtol=RTOL, atol=0,
                                   err_msg=f"loss, rank {r}")
        np.testing.assert_allclose(got["grad_norm"], norm, rtol=RTOL,
                                   atol=0, err_msg=f"grad norm, rank {r}")


def test_each_rank_holds_half_the_params(run):
    ranks, _, params = run
    full = sum(np.asarray(v).nbytes for v in jax.tree_util.tree_leaves(
        params))
    # the replicated norms: two a layer and the final one, of 64 fp32
    replicated = (2 * 2 + 1) * 64 * 4
    for r, res in enumerate(ranks):
        lines = [ln for ln in res["stdout"].splitlines()
                 if "rank summary: " in ln]
        assert len(lines) == 1
        summary = json.loads(lines[0].split("rank summary: ", 1)[1])
        assert (summary["rank"], summary["tp_rank"], summary["tp"]) == (
            r, r, 2)
        assert 2 * summary["param_bytes"] == full + replicated
        # the tp collectives ran over gloo on CPU tensors
        assert summary["collectives"]["gloo/cpu/all_gather"] > 0
    # rank 0 logs; rank 1 prints its summary only
    assert " iteration" in ranks[0]["stdout"]
    assert " iteration" not in ranks[1]["stdout"]


# ---------------------------------------------------------------------------
# refused at tp > 1 (one process, the layout set without a process group)
# ---------------------------------------------------------------------------

@pytest.fixture
def tp2():
    topology.initialize_model_parallel(2, world_size=2, rank=0)
    yield
    topology.destroy_model_parallel()


@pytest.mark.parametrize("flags", [["--lora_rank=4"]],
                         ids=lambda f: f[0].lstrip("-").split("=")[0])
def test_finetune_refuses_one_device_features_at_tp(monkeypatch, flags):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="tensor-parallel size 2"):
        finetune.main(ARGV + TP_FLAGS + flags)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("field", [
    "pipeline_model_parallel_size", "context_parallel_size",
    "expert_model_parallel_size", "num_slices",
    "virtual_pipeline_model_parallel_size"])
def test_other_parallel_degrees_are_refused_at_tp(field):
    value = 2
    with pytest.raises(NotImplementedError, match="ROADMAP item 15"):
        ParallelConfig(tensor_model_parallel_size=2, sequence_parallel=True,
                       **{field: value})


def _tiny(name="llama"):
    from _torch_tp_world import _family_model

    return _family_model(name, True)


def test_lora_and_int8_weights_are_refused_at_tp(tp2):
    from megatron_llm_torch.lora import LoraAdapter
    from megatron_llm_torch.quantization import quantize_linear_weights_int8

    with pytest.raises(NotImplementedError, match="LoRA"):
        LoraAdapter(_tiny(), {})
    with pytest.raises(NotImplementedError, match="int8 weights"):
        quantize_linear_weights_int8({})


def test_serving_is_refused_at_tp(tp2):
    from megatron_llm_torch.serving.engine import InferenceEngine

    model = _tiny()
    with pytest.raises(NotImplementedError, match="serving"):
        InferenceEngine(model, {})
    # the model's cache path too (the legacy generate path's caches)
    from megatron_llm_torch.text_generation.generation import init_kv_caches

    params = model.init(0)
    caches = init_kv_caches(model.cfg, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="serving"):
        model(params, torch.zeros(1, 4, dtype=torch.long),
              kv_caches=caches)


@pytest.mark.parametrize("which", ["bert", "t5", "biencoder",
                                   "classification"])
def test_encoders_are_refused_at_tp(tp2, which):
    from megatron_llm_torch import models as m

    cfg = m.bert_config()
    make = {"bert": lambda: m.BertModel(cfg, device="cpu"),
            "t5": lambda: m.T5Model(m.t5_config(), device="cpu"),
            "biencoder": lambda: m.BiEncoderModel(cfg, device="cpu"),
            "classification": lambda: m.ClassificationModel(
                cfg, 3, device="cpu")}[which]
    with pytest.raises(NotImplementedError, match="ROADMAP item 15"):
        make()


def test_mixture_of_experts_and_layer_stats_are_refused_at_tp(tp2):
    """The MoE's expert axis stays refused at tp; the layer stats run at
    tp since they count each element once over tp x dp
    (``test_torch_dp.py``)."""
    from megatron_llm_torch.models.mixtral import MixtralModel, mixtral_config

    with pytest.raises(NotImplementedError, match="expert axis"):
        MixtralModel(mixtral_config("tiny"), device="cpu").init(0)


def test_fused_cross_entropy_is_refused_at_tp(tp2):
    model = _family_model_fused()
    params = model.init(0)
    with pytest.raises(NotImplementedError, match="fused_lm_cross_entropy"):
        model(params, torch.zeros(2, 32, dtype=torch.long),
              labels=torch.zeros(2, 32, dtype=torch.long))


def _family_model_fused():
    from _torch_tp_world import _family_model

    return _family_model("llama", True, fused_lm_cross_entropy=True)
