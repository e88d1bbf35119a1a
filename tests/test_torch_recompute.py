"""Recompute (``recompute_granularity``) in the port: each layer of a
training forward under ``torch.utils.checkpoint``.  For every
granularity the loss and every param grad equal the port's own run
without recompute bit for bit, with dropout too (its masks come from
generators seeded inside the layer function), and the JAX package's run
under the same granularity (fp32, 2e-5; the masks made equal as in
``test_torch_dropout.py``).  A ``saved_tensors_hooks`` count shows that
recompute keeps fewer tensors, and a count of the backward's ops that
'full' runs the layers' products again while 'selective' keeps them and
runs the rest again.  The parser maps ``--recompute_activations`` and
``--recompute_method`` as the JAX parser does."""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import megatron_llm_tpu.models as jm
from megatron_llm_tpu import arguments as jax_arguments
import megatron_llm_torch.models as tm
from megatron_llm_torch import arguments
from megatron_llm_torch import random as mrandom
from megatron_llm_torch.tree import tree_leaves_with_path
from megatron_llm_torch.weights import params_from_jax

torch.set_num_threads(1)
GRANULARITIES = ["full", "uniform", "block", "selective"]
KW = dict(num_layers=3, hidden_size=32, num_attention_heads=4,
          ffn_hidden_size=64, padded_vocab_size=64, seq_length=16,
          max_position_embeddings=16)
FAMILIES = {
    "gpt2": ("GPTModel", "gpt2_config", dict(hidden_dropout=0.1,
                                             attention_dropout=0.1)),
    "llama": ("LlamaModel", "llama_config", dict(num_attention_heads_kv=2)),
}


def _mask(shape, p=None):
    shape = tuple(int(n) for n in shape)
    return np.random.RandomState(int(np.prod(shape)) % (2 ** 32)).rand(
        *shape) < 0.8


def _setup(family, granularity, jax_too=False, **kw):
    model_name, cfg_name, extra = FAMILIES[family]
    kw = dict(KW, **extra, **kw)
    jcfg = getattr(jm, cfg_name)("tiny", **kw)
    jparams = getattr(jm, model_name)(jcfg).init(jax.random.PRNGKey(1))
    tcfg = getattr(tm, cfg_name)("tiny", **kw)
    params = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    model = getattr(tm, model_name)(
        tcfg.replace(recompute_granularity=granularity), device="cpu")
    jmodel = getattr(jm, model_name)(dataclasses.replace(
        jcfg, recompute_granularity=granularity))
    return model, params, (jmodel, jparams) if jax_too else None


def _batch():
    rng = np.random.RandomState(2)
    toks = rng.randint(0, 64, (2, 16))
    return toks, np.roll(toks, -1, axis=-1), rng.rand(2, 16).astype(
        np.float32)


def _run(model, params, key=None):
    toks, labels, w = _batch()
    named = tree_leaves_with_path(params)
    leaves = [p.requires_grad_(True) for _, p in named]
    tok = model(params, torch.from_numpy(toks),
                labels=torch.from_numpy(labels), rng_key=key, train=True)
    grads = torch.autograd.grad((tok * torch.from_numpy(w)).sum(), leaves)
    return tok.detach(), {"/".join(p): g for (p, _), g in zip(named, grads)}


@pytest.mark.parametrize("key", [None, 99], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("granularity", GRANULARITIES)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_bitwise_equal_to_no_recompute(family, granularity, key):
    model, params, _ = _setup(family, granularity)
    plain = model.__class__(model.cfg.replace(recompute_granularity=None),
                            device="cpu")
    tok, grads = _run(model, params, key)
    tok0, grads0 = _run(plain, params, key)
    assert torch.equal(tok, tok0)
    for k in grads0:
        assert torch.equal(grads[k], grads0[k]), k


@pytest.mark.parametrize("granularity", GRANULARITIES)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_matches_jax_under_the_same_granularity(family, granularity,
                                                monkeypatch):
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None: jnp.asarray(
                            _mask(shape)))
    monkeypatch.setattr(mrandom, "bernoulli",
                        lambda key, p, shape, device: torch.from_numpy(
                            _mask(shape)).to(device))
    model, params, (jmodel, jparams) = _setup(family, granularity,
                                              jax_too=True)
    toks, labels, w = _batch()

    def jloss(p):
        tok = jmodel(p, jnp.asarray(toks), labels=jnp.asarray(labels),
                     rng_key=jax.random.PRNGKey(0), train=True)
        return jnp.sum(tok * w), tok

    (_, want_tok), want_g = jax.value_and_grad(jloss, has_aux=True)(jparams)
    tok, grads = _run(model, params, key=5)
    np.testing.assert_allclose(tok.numpy(), np.asarray(want_tok), atol=1e-5,
                               rtol=0)
    want = {"/".join(p): np.asarray(v) for p, v in tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jax.device_get(want_g)))}
    assert grads.keys() == want.keys()
    for k in want:
        scale = max(np.abs(want[k]).max(), 1.0)
        np.testing.assert_allclose(grads[k].numpy(), want[k],
                                   atol=2e-5 * scale, rtol=0, err_msg=k)


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def _saved_and_backward_ops(granularity):
    model, params, _ = _setup("gpt2", granularity)
    toks, labels, _ = _batch()
    leaves = [p.requires_grad_(True) for _, p in
              tree_leaves_with_path(params)]
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = model(params, torch.from_numpy(toks),
                     labels=torch.from_numpy(labels), rng_key=3,
                     train=True).mean()
    with _OpCount() as count:
        torch.autograd.grad(loss, leaves)
    return sum(saved), count.ops


def test_recompute_keeps_less_and_recomputes_what_its_policy_says():
    saved, ops = {}, {}
    for g in (None, "full", "selective"):
        saved[g], ops[g] = _saved_and_backward_ops(g)
    assert saved["full"] < saved[None] / 2
    assert saved["selective"] < saved[None] / 2
    L = KW["num_layers"]
    # the backward of no recompute runs no forward op again
    assert ops[None]["_softmax"] == ops[None]["rsqrt"] == 0
    assert ops[None]["rand"] == 0
    # full runs each layer's forward again: its four products, softmax,
    # both norms (one rsqrt each) and its three masks' draws; selective
    # keeps the products (the layers' mm and addmm outputs) and runs the
    # rest again
    for g in ("full", "selective"):
        assert ops[g]["_softmax"] == L, g
        assert ops[g]["rsqrt"] == 2 * L, g
        assert ops[g]["rand"] == 3 * L, g
    extra_mm = (ops["full"]["mm"] + ops["full"]["addmm"]
                - ops[None]["mm"] - ops[None]["addmm"])
    assert extra_mm == 4 * L
    assert (ops["selective"]["mm"] + ops["selective"]["addmm"]
            == ops[None]["mm"] + ops[None]["addmm"])


def test_eval_and_no_grad_forwards_take_no_checkpoint(monkeypatch):
    from megatron_llm_torch.models import transformer as T

    model, params, _ = _setup("llama", "full")
    calls = []
    monkeypatch.setattr(T, "checkpoint",
                        lambda *a, **kw: calls.append(1) or a[0](*a[1:5]))
    toks = torch.from_numpy(_batch()[0])
    with torch.no_grad():
        model(params, toks, labels=toks, train=True)
    model(params, toks, labels=toks, train=False)
    assert calls == []
    model(params, toks, labels=toks, train=True)
    assert len(calls) == KW["num_layers"]


BASE = ["--num_layers=2", "--hidden_size=64", "--num_attention_heads=4",
        "--seq_length=32", "--micro_batch_size=1", "--padded_vocab_size=128"]


@pytest.mark.parametrize("flags", [
    [], ["--recompute_activations"], ["--recompute_method", "uniform"],
    ["--recompute_method", "block"],
    ["--recompute_granularity", "full", "--recompute_method", "block"],
    ["--recompute_granularity", "selective", "--recompute_method", "block"],
    ["--recompute_granularity", "full", "--recompute_activations"],
    ["--recompute_num_layers", "3", "--recompute_granularity", "uniform"],
], ids=lambda f: "_".join(a.lstrip("-") for a in f) or "none")
def test_parser_maps_the_reference_spellings_as_the_jax_parser(flags):
    jargs = jax_arguments.validate_args(
        jax_arguments.build_base_parser().parse_args(BASE + flags),
        world_size=1)
    targs = arguments.validate_args(
        arguments.build_parser().parse_args(BASE + flags))
    assert (targs.recompute_granularity, targs.recompute_num_layers) == (
        jargs.recompute_granularity, jargs.recompute_num_layers)
