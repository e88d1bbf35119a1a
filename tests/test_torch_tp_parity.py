"""Sharded == unsharded for every model family of
``tests/test_model_parallel_parity.py``, the port's way: the JAX
package's unsharded forward on its own params (``PRNGKey(0)``) and the
seed's tokens, against the port at tp 4, tp 4 + SP, tp 2 + SP and tp 2,
each layout one world of gloo ranks on the CPU (``_torch_tp_world.py``)
that loads the same params cut to its rank (``params_from_jax``) and
runs all 7 families: the per-token loss within atol 2e-5 (fp32) on every rank.
At tp 4 + SP and at tp 4 the grads of the mean loss of Llama, of Falcon
(one KV head that 4 ranks share) and of GPT-2 (learned positions,
biases, LayerNorm) on every leaf, after the step's finish over the tp
group and a gather, within 3e-5 of the leaf's max-abs against JAX's
unsharded grads.  A training forward with hidden and attention dropout
under one key gives the port's one-device loss at every layout (the
masks do not depend on the sharding).  Falcon-7B's 71 heads at tp 2 are
refused by name."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_tp_world import _family_model, run_world
from megatron_llm_tpu.models import (
    FalconModel,
    GemmaModel,
    GPTModel,
    GPTNeoXModel,
    LlamaModel,
    MistralModel,
    Qwen2Model,
    falcon_config,
    gemma_config,
    gpt2_config,
    gpt_neox_config,
    llama_config,
    mistral_config,
    qwen2_config,
)
from megatron_llm_torch.models.language_model import (
    init_language_model_params,
)
from megatron_llm_torch.tree import tree_leaves_with_path

torch.set_num_threads(1)
CASES = {
    "llama": (LlamaModel, llama_config),
    "gpt2": (GPTModel, gpt2_config),
    "falcon": (FalconModel, falcon_config),
    "mistral": (MistralModel, mistral_config),
    "qwen2": (Qwen2Model, qwen2_config),
    "gemma": (GemmaModel, gemma_config),
    "gpt_neox": (GPTNeoXModel, gpt_neox_config),
}
LAYOUTS = {"tp4": (4, False), "tp4_sp": (4, True), "tp2_sp": (2, True),
           "tp2": (2, False)}
GRAD_FAMILIES = ("llama", "falcon", "gpt2")
GRAD_LAYOUTS = ("tp4_sp", "tp4")
DROPOUT = dict(hidden_dropout=0.2, attention_dropout=0.3,
               use_flash_attn=False)
DROPOUT_KEY = 12345
ATOL = 2e-5
GRAD_ATOL = 3e-5


def _leaf_names(name):
    model = _family_model(name, False)
    tree = init_language_model_params(None, model.cfg, device="meta")
    return ["/".join(p) for p, _ in tree_leaves_with_path(tree)]


GRAD_LEAVES = [(n, leaf) for n in GRAD_FAMILIES for leaf in _leaf_names(n)]


@pytest.fixture(scope="module")
def jax_side():
    """Per family: the JAX params (numpy), tokens, labels, the unsharded
    per-token loss and, for GRAD_FAMILIES, the grads of its mean."""
    out = {}
    for name, (model_cls, cfg_fn) in CASES.items():
        cfg = cfg_fn("tiny", seq_length=32, max_position_embeddings=32)
        model = model_cls(cfg)
        params = model.init(jax.random.PRNGKey(0))
        rng = np.random.RandomState(0)
        tokens = rng.randint(0, cfg.padded_vocab_size, (4, 32)).astype(
            np.int32)
        labels = np.roll(tokens, -1, axis=1)
        t, lab = jnp.asarray(tokens), jnp.asarray(labels)
        base = model(params, t, labels=lab, train=False)
        case = dict(params=jax.device_get(params), tokens=tokens,
                    labels=labels, base=np.asarray(base))
        if name in GRAD_FAMILIES:
            g = jax.grad(lambda p: model(p, t, labels=lab,
                                         train=False).mean())(params)
            case["grads"] = {
                "/".join(str(getattr(k, "key", k)) for k in path):
                    np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(
                    jax.device_get(g))[0]}
        out[name] = case
    return out


@pytest.fixture(scope="module")
def port_dropout(jax_side):
    """The port's one-device training loss under DROPOUT and one key."""
    from megatron_llm_torch.weights import params_from_jax

    out = {}
    for name in ("llama", "gpt2", "falcon"):
        case = jax_side[name]
        model = _family_model(name, False, **DROPOUT)
        params = params_from_jax(case["params"], model.cfg, device="cpu")
        with torch.no_grad():
            out[name] = model(params, torch.from_numpy(case["tokens"]).long(),
                              labels=torch.from_numpy(case["labels"]).long(),
                              train=True, rng_key=DROPOUT_KEY).numpy()
    return out


_WORLDS = {}


@pytest.fixture(scope="module")
def worlds(jax_side, tmp_path_factory):
    """layout -> every rank's results (one world a layout)."""
    def world(layout):
        if layout not in _WORLDS:
            tp, sp = LAYOUTS[layout]
            fams = {n: {k: c[k] for k in ("params", "tokens", "labels")}
                    for n, c in jax_side.items()}
            payload = dict(
                sequence_parallel=sp, families=fams,
                grads=GRAD_FAMILIES if layout in GRAD_LAYOUTS else (),
                dropout={n: dict(fams[n], over=DROPOUT, key=DROPOUT_KEY)
                         for n in ("llama", "gpt2", "falcon")})
            _WORLDS[layout] = run_world(
                tmp_path_factory.mktemp(layout), "families", tp, payload)
        return _WORLDS[layout]

    yield world
    _WORLDS.clear()


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_tp_parity(jax_side, worlds, layout, name):
    base = jax_side[name]["base"]
    for r, res in enumerate(worlds(layout)):
        np.testing.assert_allclose(res[name], base, atol=ATOL, rtol=0,
                                   err_msg=f"{name} {layout} rank {r}")


@pytest.mark.parametrize("name,leaf", GRAD_LEAVES,
                         ids=[f"{n}-{leaf}" for n, leaf in GRAD_LEAVES])
def test_grad_parity_tp4_sp(jax_side, worlds, name, leaf):
    _grads_match(jax_side, worlds("tp4_sp"), name, leaf)


@pytest.mark.parametrize("name,leaf", GRAD_LEAVES,
                         ids=[f"{n}-{leaf}" for n, leaf in GRAD_LEAVES])
def test_grad_parity_tp4(jax_side, worlds, name, leaf):
    """Without SP every replicated leaf's grad is whole on each rank
    already (the copy's all-reduce backward): the finish sums only the
    shared K/V columns."""
    _grads_match(jax_side, worlds("tp4"), name, leaf)


def _grads_match(jax_side, ranks, name, leaf):
    want = jax_side[name]["grads"][leaf]
    for r, res in enumerate(ranks):
        got = dict((("/".join(p), v) for p, v in
                    tree_leaves_with_path(res[f"{name}_grads"])))[leaf]
        assert got.shape == want.shape
        scale = max(np.abs(want).max(), 1.0)
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL * scale, rtol=0,
                                   err_msg=f"{name} {leaf} rank {r}")


@pytest.mark.parametrize("name", ["llama", "gpt2", "falcon"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_dropout_does_not_depend_on_the_layout(port_dropout, worlds, layout,
                                               name):
    for r, res in enumerate(worlds(layout)):
        np.testing.assert_allclose(res[f"{name}_dropout"],
                                   port_dropout[name], atol=ATOL, rtol=0,
                                   err_msg=f"{name} {layout} rank {r}")


def test_shared_kv_grads_are_equal_on_the_ranks_that_hold_them(worlds):
    """Falcon's one KV head is held by all 4 ranks: after the step's
    finish every rank's K/V columns carry the same (summed) grad."""
    from megatron_llm_torch.parallel.sharding import head_layout

    cfg = _family_model("falcon", True).cfg
    lay = head_layout(cfg, 4)
    kv = []
    for res in worlds("tp4_sp"):
        g = res["falcon_local_grads"]["transformer"]["layers"]["attention"][
            "query_key_value"]["kernel"]
        kv.append(g.reshape(g.shape[:-1] + (lay.nh_local + 2, lay.d))[
            ..., lay.nh_local:, :])
    for other in kv[1:]:
        np.testing.assert_array_equal(other, kv[0])


def test_heads_tp_does_not_divide_are_refused_by_name():
    from megatron_llm_torch.models.falcon import falcon_config as port_falcon
    from megatron_llm_torch.parallel.sharding import head_layout

    with pytest.raises(NotImplementedError, match="71 query heads"):
        head_layout(port_falcon("7B"), 2)
    # 4 query heads on 2 groups at tp 8: the ranks outnumber the heads
    with pytest.raises(NotImplementedError, match="4 query heads"):
        head_layout(_family_model("mistral", False).cfg, 8)
