"""The port's tensor-parallel pieces against the JAX package's, in one
world of 4 gloo ranks on the CPU (``_torch_tp_world.py``): the seven
mappings (forward, and the input grad under each rank's own cotangent)
against the JAX mappings under ``shard_map`` on the 8-device virtual
mesh at tp 4; the vocab-parallel cross entropy (loss and logit grads,
with and without label smoothing) and max indices (ties to the lowest
id) against ``shard_vocab_parallel_*`` and the unsharded loss; dropout
masks that do not depend on the sharding; and the topology's layout of
a world of 4 (tp 2, dp 2; tp 3 refused) and a run's start-up
(``initialize_megatron``: the vocab padded to 128 x tp).  In one process: the rank
order against the JAX mesh's device order, the dp derivation and the
invalid sizes (``tests/test_parallel_state.py``'s cases), the spec
tables against the JAX package's, and the backend rules.  fp32;
forwards and grads atol 1e-6, losses rtol 1e-5 (the JAX tests')."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_tp_world import run_world
from megatron_llm_tpu import topology as jax_topology
from megatron_llm_tpu.ops import cross_entropy as jax_ce
from megatron_llm_tpu.parallel import mappings as jax_mappings
from megatron_llm_torch import random as mrandom
from megatron_llm_torch import topology

torch.set_num_threads(1)
TP = 4
ATOL = 1e-6
MAPPINGS = {
    # name: (JAX mapping, x per rank is the same (replicated input),
    #        local x shape, w per rank is the same (replicated output))
    "copy": (jax_mappings.copy_to_tensor_model_parallel_region, True,
             (8, 6), False),
    "reduce": (jax_mappings.reduce_from_tensor_model_parallel_region, False,
               (8, 6), True),
    "scatter": (jax_mappings.scatter_to_tensor_model_parallel_region, True,
                (8, 16), False),
    "gather": (jax_mappings.gather_from_tensor_model_parallel_region, False,
               (8, 4), True),
    "sp_scatter": (jax_mappings.scatter_to_sequence_parallel_region, True,
                   (16, 6), False),
    "sp_gather": (jax_mappings.gather_from_sequence_parallel_region, False,
                  (4, 6), False),
    "sp_reduce_scatter": (
        jax_mappings.reduce_scatter_to_sequence_parallel_region, False,
        (16, 6), False),
}
shard_map = jax_topology.shard_map
DROPOUT = dict(key=mrandom.base_key(11), p=0.9, shape=(2, 16, 8))


def _mesh():
    jax_topology.destroy_model_parallel()
    return jax_topology.initialize_model_parallel(tensor_model_parallel_size=TP)


def _per_rank(mesh, fn, *arrays):
    """``fn`` on each tp rank's block of the stacked [TP, ...] arrays,
    its outputs stacked back in rank order."""
    def local(*blocks):
        outs = fn(*(b[0] for b in blocks))
        return tuple(o[None] for o in outs)

    spec = P("tp")
    return shard_map(local, mesh=mesh, in_specs=(spec,) * len(arrays),
                     out_specs=(spec, spec))(*arrays)


def _mapping_inputs(rng):
    out = {}
    for name, (_, same_x, shape, same_w) in MAPPINGS.items():
        x = rng.standard_normal((1 if same_x else TP,) + shape)
        x = np.repeat(x, TP, 0) if same_x else x
        out[name] = {"x": x.astype(np.float32)}
    return out


def _out_shape(name, shape):
    if name == "scatter":
        return (shape[0], shape[1] // TP)
    if name == "gather":
        return (shape[0], shape[1] * TP)
    if name in ("sp_scatter", "sp_reduce_scatter"):
        return (shape[0] // TP, shape[1])
    if name == "sp_gather":
        return (shape[0] * TP, shape[1])
    return shape


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the world's results by rank, the JAX package's side)."""
    rng = np.random.default_rng(0)
    maps = _mapping_inputs(rng)
    for name, (_, _, shape, same_w) in MAPPINGS.items():
        oshape = _out_shape(name, shape)
        w = rng.standard_normal((1 if same_w else TP,) + oshape)
        maps[name]["w"] = (np.repeat(w, TP, 0) if same_w else w).astype(
            np.float32)
    logits = (rng.standard_normal((4, 8, 64)) * 3).astype(np.float32)
    labels = rng.integers(0, 64, (4, 8)).astype(np.int32)
    ties = rng.standard_normal((4, 8, 64)).astype(np.float32)
    # the row's max twice, in two shards: the lowest id wins
    ties[..., 5] = ties[..., 37] = 10.0
    ce = dict(logits=logits, labels=labels, ties=ties,
              w=rng.standard_normal((4, 8)).astype(np.float32))
    payload = dict(mappings=maps, ce=ce, dropout=DROPOUT)
    ranks = run_world(tmp_path_factory.mktemp("tp_ops"), "ops", TP, payload)

    mesh = _mesh()
    want = {}
    for name, (fn, _, _, _) in MAPPINGS.items():
        def one(x, w, fn=fn):
            y, vjp = jax.vjp(lambda v: fn("tp", v), x)
            return y, vjp(w)[0]

        y, gx = _per_rank(mesh, one, jnp.asarray(maps[name]["x"]),
                          jnp.asarray(maps[name]["w"]))
        want[f"map_{name}"] = (np.asarray(y), np.asarray(gx))
    for smooth in (0.0, 0.1):
        f = shard_map(
            lambda lg, lb, s=smooth: jax_ce.shard_vocab_parallel_cross_entropy(
                lg, lb, "tp", s),
            mesh=mesh, in_specs=(P(None, None, "tp"), P()), out_specs=P())
        loss = np.asarray(f(jnp.asarray(logits), jnp.asarray(labels)))
        grad = np.asarray(jax.grad(lambda lg, s=smooth: jnp.sum(
            jax_ce.vocab_parallel_cross_entropy(lg, jnp.asarray(labels), s)
            * jnp.asarray(ce["w"])))(jnp.asarray(logits)))
        want[f"ce_{smooth}"] = (loss, grad)
    f = shard_map(lambda lg: jax_ce.shard_vocab_parallel_max_indices(lg, "tp"),
                  mesh=mesh, in_specs=(P(None, None, "tp"),), out_specs=P())
    want["max_indices"] = np.asarray(f(jnp.asarray(logits)))
    want["max_indices_ties"] = np.asarray(f(jnp.asarray(ties)))
    jax_topology.destroy_model_parallel()
    return ranks, want


@pytest.mark.parametrize("name", sorted(MAPPINGS))
def test_mapping_matches_jax_forward_and_backward(world, name):
    ranks, want = world
    y_want, g_want = want[f"map_{name}"]
    for r, res in enumerate(ranks):
        y, g = res[f"map_{name}"]
        np.testing.assert_allclose(y, y_want[r], atol=ATOL, rtol=0,
                                   err_msg=f"{name} forward, rank {r}")
        np.testing.assert_allclose(g, g_want[r], atol=ATOL, rtol=0,
                                   err_msg=f"{name} backward, rank {r}")


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_vocab_parallel_cross_entropy_matches_jax(world, smoothing):
    ranks, want = world
    loss_want, grad_want = want[f"ce_{smoothing}"]
    vl = grad_want.shape[-1] // TP
    for r, res in enumerate(ranks):
        loss, grad = res[f"ce_{smoothing}"]
        np.testing.assert_allclose(loss, loss_want, rtol=1e-5, atol=0)
        np.testing.assert_allclose(grad, grad_want[..., r * vl:(r + 1) * vl],
                                   atol=ATOL, rtol=0, err_msg=f"rank {r}")


@pytest.mark.parametrize("which", ["max_indices", "max_indices_ties"])
def test_vocab_parallel_max_indices_match_jax(world, which):
    ranks, want = world
    for res in ranks:
        np.testing.assert_array_equal(res[which], want[which])
    if which == "max_indices_ties":
        assert (want[which] == 5).all()


def test_dropout_masks_do_not_depend_on_the_sharding(world):
    ranks, _ = world
    full = mrandom.bernoulli(DROPOUT["key"], DROPOUT["p"], DROPOUT["shape"],
                             "cpu").numpy()
    n = DROPOUT["shape"][1] // TP
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["mask_seq"],
                                      full[:, r * n:(r + 1) * n])
    assert 0 < full.mean() < 1


def test_a_world_of_4_lays_out_tp_2_and_dp_2(world):
    ranks, _ = world
    for r, res in enumerate(ranks):
        lay = res["layout_tp2"]
        assert np.asarray(lay["grid"]).shape == (1, 1, 2, 1, 2)
        assert (lay["tp"], lay["dp"]) == (2, 2)
        assert (lay["tp_rank"], lay["dp_rank"]) == (r % 2, r // 2)
        # the tp group's all-reduce sums its own block of ranks
        assert lay["tp_sum"] == (1.0 if r < 2 else 5.0)
        assert res["layout_tp3"].startswith("RuntimeError")


def test_a_non_finite_grad_on_one_rank_skips_the_step_on_all(world):
    ranks, _ = world
    assert [res["all_finite"] for res in ranks] == [0.0] * TP


def test_initialize_megatron_pads_the_vocab_to_128_times_tp(world):
    ranks, _ = world
    for r, res in enumerate(ranks):
        # --vocab_size 1000 at tp 4: the next multiple of 512; the world
        # (4) is tp, dp 1; gloo on the CPU from the default backend flag
        assert res["initialize"] == dict(padded_vocab_size=1024, world=TP,
                                         dp=1, rank=r, device="cpu", tp=TP)


# ---------------------------------------------------------------------------
# one process: the layout's arithmetic (tests/test_parallel_state.py)
# ---------------------------------------------------------------------------

@pytest.fixture
def layout():
    yield topology
    topology.destroy_model_parallel()


def test_initialize_and_destroy_model_parallel(layout):
    layout.initialize_model_parallel(2, 4, world_size=8, rank=0)
    assert layout.model_parallel_is_initialized()
    assert layout.get_tensor_model_parallel_world_size() == 2
    assert layout.get_pipeline_model_parallel_world_size() == 4
    assert layout.get_data_parallel_world_size() == 1
    assert layout.get_world_size() == 8
    layout.destroy_model_parallel()
    assert not layout.model_parallel_is_initialized()
    assert layout.get_tensor_model_parallel_world_size() == 1


def test_dp_derivation(layout):
    layout.initialize_model_parallel(2, world_size=8, rank=5)
    assert layout.get_data_parallel_world_size() == 4
    assert (layout.get_tensor_model_parallel_rank(),
            layout.get_data_parallel_rank()) == (1, 2)


def test_invalid_sizes(layout):
    with pytest.raises(RuntimeError):
        layout.initialize_model_parallel(3, world_size=8)


def test_vpp_state(layout):
    layout.initialize_model_parallel(1, 4, 2, world_size=8)
    assert layout.get_virtual_pipeline_model_parallel_world_size() == 2


@pytest.mark.parametrize("tp,pp,cp", [(2, 2, 1), (4, 1, 1), (2, 1, 2),
                                      (1, 2, 2)])
def test_rank_order_is_the_jax_meshs(tp, pp, cp):
    mesh = jax_topology.initialize_model_parallel(
        tensor_model_parallel_size=tp, pipeline_model_parallel_size=pp,
        context_parallel_size=cp)
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    np.testing.assert_array_equal(topology.rank_grid(8, tp, pp, cp), ids)


def test_no_process_group_builds_no_tp_group(layout):
    layout.initialize_model_parallel(2, world_size=2, rank=1)
    with pytest.raises(RuntimeError):
        layout.get_tensor_model_parallel_group()


# ---------------------------------------------------------------------------
# the spec tables and the backends
# ---------------------------------------------------------------------------

def _jax_family(name):
    from megatron_llm_tpu import models as jm

    return {"llama": (jm.LlamaModel, jm.llama_config),
            "gpt2": (jm.GPTModel, jm.gpt2_config),
            "falcon": (jm.FalconModel, jm.falcon_config),
            "gpt_neox": (jm.GPTNeoXModel, jm.gpt_neox_config)}[name]


@pytest.mark.parametrize("name", ["llama", "gpt2", "falcon", "gpt_neox"])
def test_spec_tables_are_the_jax_packages(name):
    from megatron_llm_torch.models.language_model import (
        init_language_model_params,
    )
    from megatron_llm_torch.parallel.sharding import (
        language_model_param_specs,
    )
    from megatron_llm_torch.tree import tree_leaves_with_path

    model_cls, cfg_fn = _jax_family(name)
    jmodel = model_cls(cfg_fn("tiny"))
    jparams = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    want = jax.tree_util.tree_map(
        lambda s: tuple(s), jmodel.param_specs(jparams),
        is_leaf=lambda v: isinstance(v, tuple))
    from _torch_tp_world import _family_model

    tmodel = _family_model(name, False)
    tparams = init_language_model_params(None, tmodel.cfg, device="meta")
    got = language_model_param_specs(tparams, tmodel.cfg)
    flat = dict(tree_leaves_with_path(got))
    want_flat = {tuple(str(getattr(k, "key", k)) for k in path): v
                 for path, v in jax.tree_util.tree_flatten_with_path(
                     want, is_leaf=lambda v: isinstance(v, tuple))[0]}
    assert flat == want_flat


def test_backend_flag_reads_xla_as_the_devices_own():
    assert topology.resolve_backend("xla", "cuda") == "nccl"
    assert topology.resolve_backend("xla", "cpu") == "gloo"
    assert topology.resolve_backend("gloo", "cuda") == "gloo"
    with pytest.raises(ValueError):
        topology.resolve_backend("nccl", "cpu")


def test_nccl_refuses_two_ranks_on_one_gpu(monkeypatch):
    """A second local rank on a one-GPU machine raises under NCCL (NCCL
    refuses a shared device) before any group is made; under gloo it
    shares the GPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="NCCL"):
        topology.initialize_distributed("nccl", "cuda")
    with pytest.raises(RuntimeError, match="NCCL"):
        topology.initialize_distributed("xla", "cuda")
