"""The port's LoRA (megatron_llm_torch/lora.py and the low-rank path of
parallel/layers.py) against the JAX package's, on a tiny Llama from the
same JAX-initialised params, with the same adapters carried across: the
adapter tree holds the JAX tree's leaves; at zero init the adapted model
equals the base bit for bit; the low-rank path equals the merged kernel
and the JAX adapted model (fp32, 1e-5); ``merge_lora`` equals the JAX
merge; two train steps move only the adapters, with the JAX steps' loss,
grad norm and adapters (1e-5); and ``finetune.main --lora_rank`` trains,
saves the merged base-format tree and the server's ``--load`` serves
it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu import lora as jax_lora
from megatron_llm_tpu.config import ParallelConfig as JaxParallelConfig
from megatron_llm_tpu.config import TrainConfig as JaxTrainConfig
from megatron_llm_tpu.models.llama import LlamaModel as JaxLlama
from megatron_llm_tpu.models.llama import llama_config as jax_llama_config
from megatron_llm_tpu.optimizer import MegatronOptimizer as JaxOptimizer
from megatron_llm_tpu.training import build_train_step as jax_train_step
from megatron_llm_torch import checkpointing, finetune
from megatron_llm_torch.config import ParallelConfig, TrainConfig
from megatron_llm_torch.lora import (
    DEFAULT_TARGETS,
    LoraAdapter,
    attach_lora,
    init_lora,
    merge_lora,
)
from megatron_llm_torch.models.llama import LlamaModel, llama_config
from megatron_llm_torch.optimizer import MegatronOptimizer
from megatron_llm_torch.training import build_train_step
from megatron_llm_torch.tree import tree_leaves_with_path
from megatron_llm_torch.weights import _to_tensor, params_to_numpy

torch.set_num_threads(1)
ATOL = 1e-5
VOCAB, SEQ, RANK = 64, 16, 4
KW = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
          num_attention_heads_kv=2, ffn_hidden_size=96,
          padded_vocab_size=VOCAB, seq_length=SEQ,
          max_position_embeddings=SEQ)


def _port_tree(tree):
    """A JAX tree (numpy leaves, None at untargeted nodes) -> the port's
    (tensor leaves, untargeted nodes left out)."""
    if isinstance(tree, dict):
        out = {k: _port_tree(v) for k, v in tree.items()}
        return {k: v for k, v in out.items() if v is not None and v != {}}
    return None if tree is None else _to_tensor(tree, None, "cpu")


def _flat(tree):
    return {"/".join(p): np.asarray(v, np.float32)
            for p, v in tree_leaves_with_path(tree)}


def _jax_flat(tree):
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    return {"/".join(k.key for k in path): np.asarray(v, np.float32)
            for path, v in leaves}


@pytest.fixture(scope="module")
def setup():
    jmodel = JaxLlama(jax_llama_config("tiny", use_flash_attn=False, **KW))
    jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(7)))
    tmodel = LlamaModel(llama_config("tiny", **KW), device="cpu")
    tparams = _port_tree(jparams)
    jl = jax_lora.init_lora(jmodel, jparams, RANK, jax.random.PRNGKey(1),
                            alpha=8.0)
    # B non-zero, so that the low-rank path shows in the outputs
    rng = np.random.RandomState(2)

    def fill_b(node):
        if isinstance(node, dict):
            if "lora_B" in node:
                return {**node, "lora_B": jnp.asarray(
                    rng.randn(*node["lora_B"].shape).astype(np.float32)
                    * 0.1)}
            return {k: fill_b(v) for k, v in node.items()}
        return node

    jl_b = jax.device_get(fill_b(jl))
    return jmodel, jparams, tmodel, tparams, jax.device_get(jl), jl_b


def _tokens(seed=0, shape=(2, 12)):
    return np.random.default_rng(seed).integers(0, VOCAB, shape)


def test_adapter_tree_holds_the_jax_leaves(setup):
    jmodel, jparams, tmodel, tparams, jl, _ = setup
    mine = init_lora(tmodel, tparams, RANK, 5, alpha=8.0)
    want = {k: v.shape for k, v in _jax_flat(jl).items()}
    got = {"/".join(p): tuple(t.shape) for p, t in
           tree_leaves_with_path(mine)}
    assert got == want
    assert list(got) == list(_jax_flat(jl))        # the same leaf order
    for p, t in tree_leaves_with_path(mine):
        if p[-1] == "lora_B":
            assert torch.all(t == 0)
        if p[-1] == "lora_scale":
            assert t.dtype == torch.float32 and torch.all(t == 2.0)
    assert set(DEFAULT_TARGETS) == set(jax_lora.DEFAULT_TARGETS)
    # the default alpha is 2 * rank, so the scale is 2
    dflt = init_lora(tmodel, tparams, RANK, 5)
    assert float(dflt["transformer"]["layers"]["attention"]["dense"][
        "lora_scale"][0]) == 2.0


def test_zero_init_adapters_leave_the_base_model(setup):
    _, _, tmodel, tparams, _, _ = setup
    lora = init_lora(tmodel, tparams, RANK, 5)
    toks = torch.from_numpy(_tokens())
    adapter = LoraAdapter(tmodel, tparams)
    assert torch.equal(adapter(lora, toks), tmodel(tparams, toks))


def test_low_rank_path_equals_the_merged_kernel_and_jax(setup):
    jmodel, jparams, tmodel, tparams, _, jl_b = setup
    lora = _port_tree(jl_b)
    toks = _tokens()
    got = LoraAdapter(tmodel, tparams)(lora, torch.from_numpy(toks))
    merged = tmodel(merge_lora(tparams, lora), torch.from_numpy(toks))
    want = np.asarray(jmodel(jax_lora.attach_lora(jparams, jl_b),
                             jnp.asarray(toks)))
    base = tmodel(tparams, torch.from_numpy(toks)).numpy()
    assert np.abs(got.numpy() - base).max() > 1e-3      # the path shows
    np.testing.assert_allclose(got.numpy(), merged.numpy(), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # the forward view shares the base tensors
    view = attach_lora(tparams, lora)
    qkv = view["transformer"]["layers"]["attention"]["query_key_value"]
    assert qkv["kernel"] is tparams["transformer"]["layers"]["attention"][
        "query_key_value"]["kernel"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_merge_equals_the_jax_merge(setup, dtype):
    _, jparams, _, tparams, _, jl_b = setup
    cast = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, cast), jparams)
    jlb = jax.tree_util.tree_map(
        lambda a: a if a.dtype == jnp.float32 and a.ndim == 1
        else jnp.asarray(a, cast), jl_b)
    want = _jax_flat(jax.device_get(jax_lora.merge_lora(jp, jlb)))
    tp = {k: v for k, v in _port_tree(jax.device_get(jp)).items()}
    got = _flat(params_to_numpy(merge_lora(tp, _port_tree(
        jax.device_get(jlb)))))
    assert got.keys() == want.keys()
    atol = ATOL if dtype == torch.float32 else 2e-2
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0,
                                   err_msg=k)


def test_train_steps_move_only_the_adapters_as_jax(setup):
    jmodel, jparams, tmodel, tparams, jl, _ = setup
    kw = dict(micro_batch_size=2, global_batch_size=4, train_iters=2,
              lr=1e-3, weight_decay=0.01, clip_grad=1.0)
    jadapter = jax_lora.LoraAdapter(jmodel, jparams)
    tadapter = LoraAdapter(tmodel, tparams)
    jopt = JaxOptimizer(JaxTrainConfig(**kw))
    topt = MegatronOptimizer(TrainConfig(**kw))
    jstep = jax_train_step(jadapter, jopt, JaxParallelConfig(), 2)
    tstep = build_train_step(tadapter, topt, ParallelConfig(), 2)
    jlora = jax.tree_util.tree_map(jnp.array, jl)
    tlora = _port_tree(jl)
    before = {k: v.clone() for k, v in
              (("/".join(p), t) for p, t in tree_leaves_with_path(tparams))}
    js, ts = jopt.init(jlora), topt.init(tlora)
    assert ts.master_params is None        # fp32 adapters: no masters
    n_state = sum(t.numel() for _, t in tree_leaves_with_path(ts.exp_avg))
    assert n_state == sum(t.numel() for _, t in tree_leaves_with_path(
        tlora))
    rng = np.random.default_rng(3)
    for it in range(2):
        toks = rng.integers(0, VOCAB, (2, 2, SEQ)).astype(np.int32)
        b = {"tokens": toks, "labels": np.roll(toks, -1, axis=-1),
             "loss_mask": np.ones(toks.shape, np.float32)}
        jlora, js, jm = jstep(jlora, js,
                              {k: jnp.asarray(v) for k, v in b.items()},
                              jax.random.PRNGKey(it), 1e-3, 0.01)
        tlora, ts, tm = tstep(tlora, ts,
                              {k: torch.from_numpy(v) for k, v in b.items()},
                              None, 1e-3, 0.01)
        for key in ("lm loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       atol=ATOL, rtol=0,
                                       err_msg=f"{key} step {it}")
    for p, t in tree_leaves_with_path(tparams):
        assert torch.equal(t, before["/".join(p)]), p
        assert t.grad is None and not t.requires_grad
    got = _flat(params_to_numpy(tlora))
    want = _jax_flat(jax.device_get(jlora))
    assert got.keys() == want.keys()
    moved = 0.0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0,
                                   err_msg=k)
        if k.endswith("lora_B"):
            moved = max(moved, np.abs(got[k]).max())
        if k.endswith("lora_scale"):
            assert np.all(got[k] == 2.0)       # the scale is not trained
    assert moved > 0


TINY = ["--model_name=llama2", "--num_layers=2", "--hidden_size=64",
        "--num_attention_heads=4", "--seq_length=32",
        "--max_position_embeddings=32", "--micro_batch_size=2",
        "--global_batch_size=4", "--train_iters=3", "--lr=1e-2",
        "--vocab_size=128", "--log_interval=1", "--device", "cpu"]


def test_finetune_trains_saves_merged_and_the_server_loads_it(tmp_path,
                                                             capsys):
    from megatron_llm_torch.run_text_generation_server import (
        build_parser, build_server)

    base = str(tmp_path / "base")
    assert finetune.main(TINY + ["--train_iters=1", "--save", base]) == 1
    out = str(tmp_path / "lora")
    argv = TINY + ["--lora_rank", "4", "--lora_alpha", "16",
                   "--lora_targets", "query_key_value,dense,dense_h_to_4h",
                   "--load", base, "--finetune", "--save", out]
    assert finetune.main(argv) == 3
    log = capsys.readouterr().out
    assert "LoRA rank 4" in log and log.count(" iteration") >= 3
    params, opt, meta = checkpointing.load_checkpoint(out, device="cpu")
    assert opt is None and meta["iteration"] == 3
    base_params, _, _ = checkpointing.load_checkpoint(base, device="cpu")
    # a base-format tree: the base's leaves, the targeted kernels moved
    assert _flat(params).keys() == _flat(base_params).keys()
    changed = {k for k, v in _flat(params).items()
               if not np.array_equal(v, _flat(base_params)[k])}
    assert changed == {f"transformer/layers/{k}/kernel" for k in (
        "attention/query_key_value", "attention/dense",
        "mlp/dense_h_to_4h")}
    # LoRA with --load but without --finetune is refused
    with pytest.raises(SystemExit, match="--finetune"):
        finetune.main(TINY + ["--lora_rank", "4", "--load", base])
    srv_argv = ["--model_name", "llama2", "--num_layers", "2",
                "--hidden_size", "64", "--num_attention_heads", "4",
                "--ffn_hidden_size", "256", "--padded_vocab_size", "128",
                "--seq_length", "32",
                "--max_position_embeddings", "32", "--device", "cpu",
                "--serve_num_slots", "2", "--serve_block_size", "8",
                "--serve_prefill_chunk", "16", "--load", out]

    class Tok:
        vocab_size, eod, pad = 128, 127, 0

    server = build_server(build_parser().parse_args(srv_argv), Tok())
    try:
        served = server.engine.params
        for k, v in _flat(params).items():
            np.testing.assert_array_equal(_flat(served)[k], v, err_msg=k)
    finally:
        server.engine.stop()
