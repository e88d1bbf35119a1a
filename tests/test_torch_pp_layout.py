"""The pipeline's layout and flags in the port against the JAX package:
the VPP permutation helpers and the work-item decode on numpy inputs
(``megatron_llm_tpu/parallel/pipeline.py`` needs no mesh for them), a
stage's rows of the stack, the virtual stages derived from
``--num_layers_per_virtual_pipeline_stage`` as the JAX package's
``validate_args`` derives them, the pp groups and neighbours of the
layout, ``is_one_device`` at pp, the entry point's refusals at pp (LoRA,
``--eval_only``, BERT, T5 and ICT) and the parallel degrees still
refused."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu import arguments as jax_arguments
from megatron_llm_tpu.optimizer.optimizer import (
    OptimizerState as JaxOptimizerState,
)
from megatron_llm_tpu.parallel import pipeline as jax_pipeline
from megatron_llm_torch import arguments, finetune, topology
from megatron_llm_torch.config import ParallelConfig
from megatron_llm_torch.optimizer.grad_scaler import GradScalerState
from megatron_llm_torch.optimizer.optimizer import OptimizerState
from megatron_llm_torch.parallel import pipeline

torch.set_num_threads(1)
LAYOUTS = [(4, 2, 1), (4, 2, 2), (8, 2, 2), (8, 2, 4), (8, 4, 2),
           (12, 2, 3), (16, 4, 2)]


@pytest.fixture
def layout():
    yield topology
    topology.destroy_model_parallel()


@pytest.mark.parametrize("L,S,V", LAYOUTS)
def test_stage_major_permutation_is_the_jax_packages(L, S, V):
    np.testing.assert_array_equal(
        pipeline.vpp_stage_major_permutation(L, S, V),
        jax_pipeline.vpp_stage_major_permutation(L, S, V))


@pytest.mark.parametrize("L,S,V", LAYOUTS)
def test_permute_and_unpermute_are_the_jax_packages(L, S, V):
    rng = np.random.RandomState(L * 100 + S * 10 + V)
    tree = {"a": rng.randn(L, 3).astype(np.float32),
            "b": {"c": rng.randn(L, 2, 2).astype(np.float32)}}
    jtree = {"a": jnp.asarray(tree["a"]), "b": {"c": jnp.asarray(
        tree["b"]["c"])}}
    for ours, theirs in ((pipeline.permute_layer_stack,
                          jax_pipeline.permute_layer_stack),
                         (pipeline.unpermute_layer_stack,
                          jax_pipeline.unpermute_layer_stack)):
        got = ours(tree, L, S, V)
        want = theirs(jtree, L, S, V)
        np.testing.assert_array_equal(got["a"], np.asarray(want["a"]))
        np.testing.assert_array_equal(got["b"]["c"],
                                      np.asarray(want["b"]["c"]))
        # torch leaves take the same rows
        got_t = ours({"a": torch.from_numpy(tree["a"])}, L, S, V)
        np.testing.assert_array_equal(got_t["a"].numpy(),
                                      np.asarray(want["a"]))
    back = pipeline.unpermute_layer_stack(
        pipeline.permute_layer_stack(tree, L, S, V), L, S, V)
    np.testing.assert_array_equal(back["a"], tree["a"])


def _params_like(L, rng):
    return {"embedding": {"word": {"embedding": rng.randn(5, 2).astype(
                np.float32)}},
            "transformer": {"layers": {"w": rng.randn(L, 3).astype(
                np.float32)}, "final_norm": {"scale": np.ones(2,
                                                              np.float32)}}}


@pytest.mark.parametrize("to_stage_major", [True, False])
def test_params_and_optimizer_layouts_convert_as_the_jax_packages(
        to_stage_major):
    L, S, V = 8, 2, 2
    rng = np.random.RandomState(0)
    trees = [_params_like(L, rng) for _ in range(3)]

    def jnp_tree(t):
        if isinstance(t, dict):
            return {k: jnp_tree(v) for k, v in t.items()}
        return jnp.asarray(t)

    got = pipeline.convert_params_layout(trees[0], L, S, V,
                                         to_stage_major=to_stage_major)
    want = jax_pipeline.convert_params_layout(
        jnp_tree(trees[0]), L, S, V, to_stage_major=to_stage_major)
    np.testing.assert_array_equal(
        got["transformer"]["layers"]["w"],
        np.asarray(want["transformer"]["layers"]["w"]))
    assert got["embedding"] is trees[0]["embedding"]
    scaler = GradScalerState(scale=1.0, growth_tracker=0,
                             hysteresis_tracker=2)
    state = OptimizerState(step=3, master_params=trees[0],
                           exp_avg=trees[1], exp_avg_sq=trees[2],
                           grad_scaler=scaler)
    jstate = JaxOptimizerState(
        step=jnp.int32(3), master_params=jnp_tree(trees[0]),
        exp_avg=jnp_tree(trees[1]), exp_avg_sq=jnp_tree(trees[2]),
        grad_scaler=None)
    got = pipeline.convert_opt_state_layout(state, L, S, V,
                                            to_stage_major=to_stage_major)
    want = jax_pipeline.convert_opt_state_layout(
        jstate, L, S, V, to_stage_major=to_stage_major)
    for name in ("master_params", "exp_avg", "exp_avg_sq"):
        np.testing.assert_array_equal(
            getattr(got, name)["transformer"]["layers"]["w"],
            np.asarray(getattr(want, name)["transformer"]["layers"]["w"]))
    assert got.step == 3 and got.grad_scaler is scaler
    # vpp 1 and a tree without a layer stack are left as they are
    assert pipeline.convert_params_layout(trees[0], L, S, 1,
                                          to_stage_major=True) is trees[0]
    assert pipeline.convert_opt_state_layout(None, L, S, V,
                                             to_stage_major=True) is None


@pytest.mark.parametrize("M,S,V", [(4, 2, 1), (4, 2, 2), (6, 3, 2),
                                   (8, 2, 4), (4, 4, 1)])
def test_work_items_decode_as_the_jax_packages(M, S, V):
    for w in range(-S - 1, M * V + S + 1):
        m, v, valid = jax_pipeline._decode_item(jnp.int32(w), M, S, V)
        got = pipeline._decode_item(w, M, S, V)
        assert got[2] == bool(valid), w
        if got[2]:
            assert got[:2] == (int(m), int(v)), w


@pytest.mark.parametrize("L,S,V", LAYOUTS)
def test_a_stage_holds_its_rows_of_the_stage_major_stack(L, S, V):
    perm = jax_pipeline.vpp_stage_major_permutation(L, S, V)
    stack = np.arange(L * 2, dtype=np.float32).reshape(L, 2)
    tree = {"embedding": {"word": {"embedding": np.ones((3, 2))}},
            "transformer": {"layers": {"w": stack},
                            "final_norm": {"scale": np.ones(2)}}}
    rows = []
    for k in range(S):
        mine = pipeline.stage_layer_rows(L, S, V, k)
        assert mine == [int(i) for i in perm[k * L // S:(k + 1) * L // S]]
        cut = pipeline.stage_rows(tree, k, S, V, L)
        np.testing.assert_array_equal(cut["transformer"]["layers"]["w"],
                                      stack[mine])
        assert cut["embedding"] is tree["embedding"]
        rows += mine
    assert sorted(rows) == list(range(L))


def _jax_args(argv, world):
    args = jax_arguments.build_base_parser().parse_args(argv)
    return jax_arguments.validate_args(args, world_size=world)


def _port_args(argv, world):
    return arguments.validate_args(arguments.build_parser().parse_args(argv),
                                   world_size=world)


BASE = ["--num_layers", "8", "--hidden_size", "64",
        "--num_attention_heads", "4", "--seq_length", "32",
        "--micro_batch_size", "1", "--global_batch_size", "4",
        "--vocab_size", "128"]


@pytest.mark.parametrize("pp,per_stage", [(2, 1), (2, 2), (2, 4), (4, 1),
                                          (2, None)])
def test_virtual_stages_are_derived_as_the_jax_package_derives_them(
        pp, per_stage):
    """The interleaved pipeline's vpp is the stage's layers over the
    layers of a virtual stage (8 layers, pp 2, 1 layer a virtual stage:
    vpp 4), not the flag's own value."""
    argv = BASE + ["--pipeline_model_parallel_size", str(pp)]
    if per_stage is not None:
        argv += ["--num_layers_per_virtual_pipeline_stage", str(per_stage)]
    want = _jax_args(argv, pp)
    got = _port_args(argv, pp)
    assert got.virtual_pipeline_model_parallel_size == \
        want.virtual_pipeline_model_parallel_size
    assert got.data_parallel_size == want.data_parallel_size
    from megatron_llm_torch.config import parallel_config_from_args

    pc = parallel_config_from_args(got)
    assert pc.virtual_pipeline_model_parallel_size == \
        want.virtual_pipeline_model_parallel_size
    assert pc.pipeline_model_parallel_size == pp


@pytest.mark.parametrize("argv", [
    # virtual stages without a pipeline
    ["--num_layers_per_virtual_pipeline_stage", "1"],
    # 8 layers over 3 stages
    ["--pipeline_model_parallel_size", "3"],
    # a stage's 4 layers are not whole virtual stages of 3
    ["--pipeline_model_parallel_size", "2",
     "--num_layers_per_virtual_pipeline_stage", "3"],
    # the interleaved schedule groups the 2 micro batches by 4 stages
    ["--pipeline_model_parallel_size", "4",
     "--num_layers_per_virtual_pipeline_stage", "1",
     "--global_batch_size", "2"],
])
def test_pipeline_layouts_that_do_not_divide_are_refused(argv):
    world = 4 if "4" in argv[1:2] else 2
    with pytest.raises(ValueError):
        _port_args(BASE + argv, world)


def test_pp_groups_and_neighbours_follow_the_jax_meshs_order(layout):
    # [slice, pp, dp, cp, tp] = [1, 2, 2, 1, 2]: pp strides dp x tp = 4
    grid = layout.initialize_model_parallel(2, 2, world_size=8, rank=5)
    assert grid.shape == (1, 2, 2, 1, 2)
    assert layout.get_pipeline_model_parallel_rank() == 1
    assert layout.is_pipeline_last_stage()
    assert not layout.is_pipeline_first_stage()
    assert layout.get_pipeline_model_parallel_next_rank() == 1
    assert layout.get_pipeline_model_parallel_prev_rank() == 1
    layout.initialize_model_parallel(1, 4, world_size=8, rank=2)
    # pp 4 x dp 2: the stages of rank 2's pipeline are 0, 2, 4, 6
    assert layout.get_pipeline_model_parallel_rank() == 1
    assert layout.get_pipeline_model_parallel_next_rank() == 4
    assert layout.get_pipeline_model_parallel_prev_rank() == 0
    with pytest.raises(RuntimeError):
        layout.get_pipeline_model_parallel_group()


def test_is_one_device_is_false_at_pp(layout):
    """A stage holds only its rows of the stack: the save paths' single
    writer case is not a pipeline's."""
    layout.initialize_model_parallel(1, world_size=1, rank=0)
    assert layout.is_one_device()
    layout.initialize_model_parallel(1, 2, world_size=2, rank=0)
    assert layout.get_tensor_model_parallel_world_size() == 1
    assert layout.get_data_parallel_world_size() == 1
    assert not layout.is_one_device()


TINY = ["--model_name=llama2", "--num_layers=4", "--hidden_size=64",
        "--num_attention_heads=4", "--seq_length=32",
        "--max_position_embeddings=32", "--micro_batch_size=2",
        "--global_batch_size=4", "--train_iters=1", "--lr=1e-3",
        "--vocab_size=128", "--device=cpu",
        "--pipeline_model_parallel_size=2"]


@pytest.mark.parametrize("flag,match", [("--lora_rank=4", "pp=1"),
                                        ("--eval_only", "--eval_only")])
def test_lora_and_eval_only_exit_at_pp(monkeypatch, flag, match):
    """As the JAX CLI refuses them (root finetune.py:422-424, :550-554),
    before any process group starts."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match=match):
        finetune.main(TINY + [flag])
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("entry", ["pretrain_bert", "pretrain_t5",
                                   "pretrain_ict"])
def test_encoders_are_refused_at_pp(monkeypatch, entry):
    import importlib

    monkeypatch.setenv("WORLD_SIZE", "2")
    main = importlib.import_module(f"megatron_llm_torch.{entry}").main
    with pytest.raises(NotImplementedError, match="decoder stacks only"):
        main([a for a in TINY if not a.startswith("--model_name")])


def test_encoder_models_are_refused_by_the_pipeline(layout):
    from megatron_llm_torch import models as m

    layout.initialize_model_parallel(1, 2, world_size=2, rank=0)
    with pytest.raises(NotImplementedError, match="decoder stacks only"):
        pipeline.refuse_at_pp(m.BertModel(m.bert_config(), device="cpu"))
    with pytest.raises(NotImplementedError, match="token mean"):
        pipeline.refuse_at_pp(
            m.LlamaModel(m.llama_config("tiny"), device="cpu"),
            lambda loss, mask: loss.mean())


@pytest.mark.parametrize("field", ["context_parallel_size",
                                   "expert_model_parallel_size",
                                   "num_slices"])
def test_the_other_parallel_degrees_are_still_refused(field):
    ParallelConfig(pipeline_model_parallel_size=2,
                   virtual_pipeline_model_parallel_size=2)
    with pytest.raises(NotImplementedError, match="ROADMAP item 15"):
        ParallelConfig(pipeline_model_parallel_size=2, **{field: 2})


@pytest.mark.parametrize("vpp,schedule", [(1, "1f1b"), (2, "stream")])
def test_the_schedule_follows_vpp(layout, vpp, schedule):
    """1F1B at vpp 1, the stream (interleaved) engine above it."""
    from megatron_llm_torch import models as m
    from megatron_llm_torch.config import TrainConfig
    from megatron_llm_torch.optimizer import MegatronOptimizer

    layout.initialize_model_parallel(1, 2, vpp, world_size=2, rank=0)
    model = m.LlamaModel(m.llama_config("tiny", num_layers=4),
                         device="cpu")
    pc = ParallelConfig(pipeline_model_parallel_size=2,
                        virtual_pipeline_model_parallel_size=vpp)
    step = pipeline.build_pipeline_train_step(
        model, MegatronOptimizer(TrainConfig()), pc, 4)
    assert step.schedule == schedule
