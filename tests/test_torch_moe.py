"""The port's mixture of experts (megatron_llm_torch/models/moe.py) against
the JAX package's ``moe_mlp``, from the same JAX-initialised params and
numpy inputs made from a seed: out and the aux ``[lb, z]`` in fp32
(1e-5) and bf16 (2e-2), at an ample and a tight capacity, with the
experts drawn at std 1/sqrt(fan_in) so that the outputs are of order 1;
the bf16 combine (gates rounded to bf16, the k terms added in fp32 and
rounded once) bit for bit against JAX through an activation that both
compute exactly (reglu); a router that
overflows the capacity (the dropped tokens give zero); identical experts
(the dense MLP); the zero router (lb = 1, ties to the lower expert
index); decode rows at the capacity floor; and the grads of x, the
router and the experts against ``jax.grad`` (fp32, 2e-5 of each
leaf's max-abs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import TransformerConfig as JaxConfig
from megatron_llm_tpu.models.moe import init_moe_mlp_params
from megatron_llm_tpu.models.moe import moe_capacity as jax_capacity
from megatron_llm_tpu.models.moe import moe_mlp as jax_moe
from megatron_llm_tpu.models.transformer import mlp as jax_dense_mlp
from megatron_llm_torch.config import TransformerConfig
from megatron_llm_torch.models.moe import (
    moe_capacity,
    moe_mlp,
    route,
    slot_positions,
)
from megatron_llm_torch.models.transformer import mlp as dense_mlp
from megatron_llm_torch.tree import tree_leaves_with_path, tree_map
from megatron_llm_torch.weights import _to_tensor

torch.set_num_threads(1)
ATOL = {"fp32": 1e-5, "bf16": 2e-2}
GRAD_ATOL = 2e-5


def _cfgs(dtype="fp32", **kw):
    base = dict(num_layers=2, hidden_size=32, num_attention_heads=4,
                ffn_hidden_size=64, num_experts=4, moe_top_k=2,
                glu_activation="swiglu", add_bias_linear=False,
                moe_capacity_factor=8.0, params_dtype=dtype,
                compute_dtype=dtype)
    base.update(kw)
    return JaxConfig(**base), TransformerConfig(**base)


def _params(jcfg, seed=0, unit=False):
    """The JAX init; with ``unit`` the experts are redrawn at std
    1/sqrt(fan_in), which gives outputs of order 1 (the init's std 0.02
    gives about 1e-3, below the bf16 tolerance)."""
    jp = jax.device_get(init_moe_mlp_params(jax.random.PRNGKey(seed), jcfg,
                                            jcfg.params_jnp_dtype))
    if unit:
        rs = np.random.RandomState(seed + 7)
        for leaf, w in jp["experts"].items():
            jp["experts"][leaf] = jnp.asarray(
                rs.randn(*w.shape) / np.sqrt(w.shape[1]), w.dtype)
    tp = tree_map(lambda a: _to_tensor(a, None, "cpu"), jax.device_get(jp))
    return jp, tp


def _x(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _run_both(jcfg, tcfg, jp, tp, x):
    jx = jnp.asarray(x, jcfg.compute_jnp_dtype)
    want, want_aux = jax_moe(jx, jp, jcfg)
    tx = torch.from_numpy(x).to(tcfg.compute_torch_dtype)
    got, got_aux = moe_mlp(tx, tp, tcfg)
    assert got.dtype == tx.dtype and got_aux.dtype == torch.float32
    return (got.float().numpy(), got_aux.numpy(),
            np.asarray(want, np.float32), np.asarray(want_aux))


@pytest.mark.parametrize("factor", [8.0, 1.0], ids=["ample", "tight"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_out_and_aux_match_jax(dtype, factor):
    jcfg, tcfg = _cfgs(dtype, moe_capacity_factor=factor)
    jp, tp = _params(jcfg, unit=True)
    got, got_aux, want, want_aux = _run_both(jcfg, tcfg, jp, tp,
                                             _x((2, 16, 32)))
    assert moe_capacity(tcfg, 16) == jax_capacity(jcfg, 16)
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, atol=ATOL[dtype], rtol=0)
    np.testing.assert_allclose(got_aux, want_aux, atol=ATOL[dtype], rtol=0)


def test_overflowing_router_drops_the_later_tokens():
    """Capacity 1 and a router forced to one expert: each row keeps only
    its first token, every later token's output is exactly 0, as in the
    JAX package."""
    jcfg, tcfg = _cfgs(moe_top_k=1, moe_capacity_factor=1e-9,
                       moe_min_capacity=1)
    jp, tp = _params(jcfg)
    wr = np.zeros((32, 4), np.float32)
    wr[0, 2] = 1e6
    jp["router"]["kernel"] = jnp.asarray(wr)
    tp["router"]["kernel"] = torch.from_numpy(wr)
    x = np.abs(_x((2, 8, 32))) + 0.1
    assert moe_capacity(tcfg, 8) == 1
    got, _, want, _ = _run_both(jcfg, tcfg, jp, tp, x)
    assert np.abs(got[:, 0]).max() > 0
    assert np.all(got[:, 1:] == 0.0)
    np.testing.assert_allclose(got, want, atol=ATOL["fp32"], rtol=0)


def test_identical_experts_equal_the_dense_mlp():
    jcfg, tcfg = _cfgs(moe_top_k=1)
    jp, tp = _params(jcfg)
    for leaf in ("w_in", "w_out"):
        tp["experts"][leaf] = tp["experts"][leaf][:1].expand_as(
            tp["experts"][leaf]).contiguous()
    dense = {"dense_h_to_4h": {"kernel": tp["experts"]["w_in"][0]},
             "dense_4h_to_h": {"kernel": tp["experts"]["w_out"][0]}}
    x = torch.from_numpy(_x((2, 16, 32)))
    got, aux = moe_mlp(x, tp, tcfg)
    np.testing.assert_allclose(got.numpy(), dense_mlp(x, dense,
                                                      tcfg).numpy(),
                               atol=ATOL["fp32"], rtol=0)
    jdense = {"dense_h_to_4h": {"kernel": jp["experts"]["w_in"][0]},
              "dense_4h_to_h": {"kernel": jp["experts"]["w_out"][0]}}
    want = np.asarray(jax_dense_mlp(jnp.asarray(x.numpy()), jdense, jcfg))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL["fp32"], rtol=0)
    assert aux.shape == (2,) and torch.isfinite(aux).all()


def test_zero_router_gives_lb_one_and_ties_to_the_lower_index():
    """A zero router ties every expert: lb = E * sum(frac / E) = 1, and
    top-k takes experts 0..k-1 for every token (jax.lax.top_k's order),
    so the tight buffers fill in token order as the JAX package's do."""
    jcfg, tcfg = _cfgs(moe_capacity_factor=1.0)
    jp, tp = _params(jcfg)
    jp["router"]["kernel"] = jnp.zeros((32, 4), jnp.float32)
    tp["router"]["kernel"] = torch.zeros(32, 4)
    x = _x((2, 16, 32))
    _, _, gates, idx = route(torch.from_numpy(x), tp["router"]["kernel"],
                             tcfg)
    assert idx.tolist() == [[[0, 1]] * 16] * 2
    assert torch.all(gates == 0.5)
    got, got_aux, want, want_aux = _run_both(jcfg, tcfg, jp, tp, x)
    np.testing.assert_allclose(got_aux[0], 1.0, atol=1e-6)
    np.testing.assert_allclose(got_aux, want_aux, atol=ATOL["fp32"], rtol=0)
    # capacity 8 of 16 tokens on experts 0 and 1: the last 8 drop
    assert moe_capacity(tcfg, 16) == 8
    assert np.all(got[:, 8:] == 0.0) and np.abs(got[:, :8]).max() > 0
    np.testing.assert_allclose(got, want, atol=ATOL["fp32"], rtol=0)


def test_partial_ties_keep_index_order():
    """Equal probabilities among some experts rank by index, whatever
    their place in the row."""
    probs_logits = torch.tensor([[[0.0, 1.0, 1.0, 0.5],
                                  [2.0, 0.0, 2.0, 2.0],
                                  [0.0, 0.0, 0.0, 0.0]]])
    _, tcfg = _cfgs()
    eye = torch.eye(4)
    _, _, _, idx = route(probs_logits, eye, tcfg)
    assert idx.tolist() == [[[1, 2], [0, 2], [0, 1]]]
    pos = slot_positions(idx, 4)
    # token-major slots: (1, 2), (0, 2), (0, 1)
    assert pos.tolist() == [[0, 0, 0, 1, 1, 1]]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_decode_rows_at_the_capacity_floor(dtype):
    """The engine's decode shape: one token a row, S rows; each row
    routes alone with c = moe_min_capacity."""
    jcfg, tcfg = _cfgs(dtype, moe_capacity_factor=1.25)
    jp, tp = _params(jcfg, unit=True)
    assert moe_capacity(tcfg, 1) == tcfg.moe_min_capacity == 4
    got, got_aux, want, want_aux = _run_both(jcfg, tcfg, jp, tp,
                                             _x((8, 1, 32)))
    assert np.abs(want).max() > 0.5
    np.testing.assert_allclose(got, want, atol=ATOL[dtype], rtol=0)
    np.testing.assert_allclose(got_aux, want_aux, atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("shape,factor", [((2, 16, 32), 8.0),
                                          ((2, 16, 32), 1.0),
                                          ((8, 1, 32), 1.25)],
                         ids=["ample", "tight", "decode"])
def test_bf16_combine_is_bitwise_jax(shape, factor):
    """The bf16 rules of the combine (the gates rounded to bf16, the k
    terms of a token added in fp32 and rounded once) make the same bits
    as the JAX package's bf16 einsum.  reglu is exact in both (a relu and
    one rounded product), so no activation rounding hides a difference:
    a combine over unrounded gates, or one that rounds each term, changes
    about a third of the outputs by one bf16 step."""
    jcfg, tcfg = _cfgs("bf16", moe_capacity_factor=factor,
                       glu_activation="reglu")
    jp, tp = _params(jcfg, unit=True)
    got, _, want, _ = _run_both(jcfg, tcfg, jp, tp, _x(shape))
    assert np.abs(want).max() > 0.5
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("factor", [8.0, 1.0], ids=["ample", "tight"])
def test_grads_match_jax(factor):
    jcfg, tcfg = _cfgs(moe_capacity_factor=factor)
    jp, tp = _params(jcfg)
    x = _x((2, 16, 32))
    w = _x((2, 16, 32), seed=2)
    c = np.array([0.3, 0.7], np.float32)

    def jloss(p, xx):
        out, aux = jax_moe(xx, p, jcfg)
        return jnp.sum(out * w) + jnp.sum(aux * c)

    want_gp, want_gx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    named = tree_leaves_with_path(tp)
    leaves = [p.requires_grad_(True) for _, p in named]
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe_mlp(tx, tp, tcfg)
    loss = (out * torch.from_numpy(w)).sum() + (aux * torch.from_numpy(c)
                                                ).sum()
    grads = torch.autograd.grad(loss, leaves + [tx])
    want = {"/".join(p): np.asarray(v) for p, v in tree_leaves_with_path(
        jax.device_get(want_gp))}
    want["x"] = np.asarray(want_gx)
    got = {"/".join(p): g.numpy() for (p, _), g in zip(named, grads)}
    got["x"] = grads[-1].numpy()
    assert got.keys() == want.keys()
    for k in want:
        scale = max(np.abs(want[k]).max(), 1.0)
        np.testing.assert_allclose(got[k], want[k], atol=GRAD_ATOL * scale,
                                   rtol=0, err_msg=k)
    assert np.abs(got["router/kernel"]).max() > 0
    assert all(np.abs(got["experts/w_in"][e]).max() > 0 for e in range(4))
