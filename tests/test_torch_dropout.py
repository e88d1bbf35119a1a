"""Dropout in the port against the JAX package's.

The two packages cannot draw the same bits (threefry against torch's
generators), so the parity tests make the masks equal: a test-only
monkeypatch replaces ``jax.random.bernoulli`` and the port's
``random.bernoulli`` by one numpy mask that depends only on the shape
(the JAX stack's scan traces its layer body once, so every layer gets
the same mask there, and the patched port draw gives the same).  With
equal masks the port's ``_dropout``, ``core_attention``, a sequential
and a parallel layer, the embedding, and the whole loss of a GPT-2 and
a Falcon config with their grads equal the JAX package's (fp32, atol
1e-5; grads 2e-5).  LIMA's rates equal ``_lima_dropout_rates`` exactly.
Unpatched: a mask's keep share lies within binomial bounds, eval draws
nothing, the masks differ by micro-batch and step, and a two-step run
with dropout 0.1 resumed at step 1 equals the uninterrupted run bit for
bit."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import megatron_llm_tpu.models as jm
from megatron_llm_tpu.models import language_model as jlm
from megatron_llm_tpu.models import transformer as jT
import megatron_llm_torch.models as tm
from megatron_llm_torch import random as mrandom
from megatron_llm_torch.config import ParallelConfig, TrainConfig
from megatron_llm_torch.models import language_model as tlm
from megatron_llm_torch.models import transformer as tT
from megatron_llm_torch.optimizer import MegatronOptimizer
from megatron_llm_torch.training import build_train_step
from megatron_llm_torch.tree import tree_leaves_with_path, tree_map
from megatron_llm_torch.weights import params_from_jax

torch.set_num_threads(1)
ATOL, GTOL = 1e-5, 2e-5
KW = dict(num_layers=3, hidden_size=32, num_attention_heads=4,
          ffn_hidden_size=64, padded_vocab_size=64, seq_length=16,
          max_position_embeddings=16, hidden_dropout=0.1,
          attention_dropout=0.2)
FAMILIES = {"gpt2": ("GPTModel", "gpt2_config", "tiny", {}),
            "falcon": ("FalconModel", "falcon_config", "tiny",
                       dict(num_attention_heads_kv=1))}


def _mask(shape, p=None):
    """The test's mask: a function of the shape alone (keep ~0.8)."""
    shape = tuple(int(n) for n in shape)
    seed = int(np.prod(shape)) * 7 + len(shape)
    return np.random.RandomState(seed % (2 ** 32)).rand(*shape) < 0.8


@pytest.fixture
def same_masks(monkeypatch):
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None: jnp.asarray(
                            _mask(shape)))
    monkeypatch.setattr(mrandom, "bernoulli",
                        lambda key, p, shape, device: torch.from_numpy(
                            _mask(shape)).to(device))


def _cfgs(family, **kw):
    model_name, cfg_name, size, extra = FAMILIES[family]
    kw = dict(KW, **extra, **kw)
    return (getattr(jm, cfg_name)(size, **kw),
            getattr(tm, cfg_name)(size, **kw), model_name)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_matches_jax(same_masks, rate):
    x = np.random.RandomState(0).randn(2, 8, 16).astype(np.float32)
    want = jT._dropout(jnp.asarray(x), rate, jax.random.PRNGKey(0), True)
    got = tT._dropout(_t(x), rate, 3, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    # the traced per-layer rate of LIMA's path
    lima = jT._dropout(jnp.asarray(x), jnp.float32(rate),
                       jax.random.PRNGKey(0), True)
    np.testing.assert_allclose(got.numpy(), np.asarray(lima), atol=ATOL,
                               rtol=0)
    for off in (tT._dropout(_t(x), rate, 3, False),
                tT._dropout(_t(x), rate, None, True),
                tT._dropout(_t(x), 0.0, 3, True)):
        assert torch.equal(off, _t(x))


def test_core_attention_matches_jax(same_masks):
    jcfg, tcfg, _ = _cfgs("gpt2")
    rng = np.random.RandomState(1)
    q = rng.randn(2, 16, 4, 8).astype(np.float32)
    k = rng.randn(2, 16, 4, 8).astype(np.float32)
    v = rng.randn(2, 16, 4, 8).astype(np.float32)
    want = jT.core_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jcfg, None, jax.random.PRNGKey(0), True)
    got = tT.core_attention(_t(q), _t(k), _t(v), tcfg, None, 9, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    plain = tT.core_attention(_t(q), _t(k), _t(v), tcfg, None)
    assert not torch.allclose(plain, got)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_layer_matches_jax(same_masks, family):
    jcfg, tcfg, _ = _cfgs(family)
    jp = jT.init_layer_params(jax.random.PRNGKey(2), jcfg, jnp.float32)
    tp = tree_map(_t, jax.device_get(jp))
    x = np.random.RandomState(3).randn(2, 16, 32).astype(np.float32)
    jfreqs, tfreqs = jT.rotary_freqs(jcfg), tT.rotary_freqs(tcfg)
    want, _, _ = jT.transformer_layer(
        jnp.asarray(x), jp, jcfg, freqs=jfreqs, rng_key=jax.random.PRNGKey(4),
        train=True)
    got, _ = tT.transformer_layer(_t(x), tp, tcfg, freqs=tfreqs, rng_key=11,
                                  train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_embedding_dropout_matches_jax(same_masks):
    jcfg, tcfg, _ = _cfgs("gpt2")
    jparams = jm.GPTModel(jcfg).init(jax.random.PRNGKey(5))
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    toks = np.random.RandomState(6).randint(0, 64, (2, 16))
    want = jlm.embedding_forward(jnp.asarray(toks), None,
                                 jparams["embedding"], jcfg,
                                 rng_key=jax.random.PRNGKey(0), train=True)
    got = tlm.embedding_forward(_t(toks), None, tparams["embedding"], tcfg,
                                rng_key=1, train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def _loss_and_grads_jax(jmodel, jparams, toks, labels, w):
    def f(p):
        tok = jmodel(p, jnp.asarray(toks), labels=jnp.asarray(labels),
                     rng_key=jax.random.PRNGKey(0), train=True)
        return jnp.sum(tok * w), tok
    (_, tok), g = jax.value_and_grad(f, has_aux=True)(jparams)
    flat = {"/".join(p): np.asarray(v) for p, v in tree_leaves_with_path(
        tree_map(np.asarray, jax.device_get(g)))}
    return np.asarray(tok), flat


def _loss_and_grads_torch(tmodel, tparams, toks, labels, w, key=17):
    named = tree_leaves_with_path(tparams)
    leaves = [p.requires_grad_(True) for _, p in named]
    tok = tmodel(tparams, _t(toks), labels=_t(labels), rng_key=key,
                 train=True)
    grads = torch.autograd.grad((tok * _t(w)).sum(), leaves)
    return tok.detach().numpy(), {"/".join(p): g.numpy()
                                  for (p, _), g in zip(named, grads)}


@pytest.mark.parametrize("lima", [False, True], ids=["uniform", "lima"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_grads_match_jax(same_masks, family, lima):
    jcfg, tcfg, name = _cfgs(family, lima_dropout=lima)
    jmodel = getattr(jm, name)(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(8))
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    rng = np.random.RandomState(9)
    toks = rng.randint(0, 64, (2, 16))
    labels = np.roll(toks, -1, axis=-1)
    w = rng.rand(2, 16).astype(np.float32)
    want_tok, want_g = _loss_and_grads_jax(jmodel, jparams, toks, labels, w)
    got_tok, got_g = _loss_and_grads_torch(
        getattr(tm, name)(tcfg, device="cpu"), tparams, toks, labels, w)
    np.testing.assert_allclose(got_tok, want_tok, atol=ATOL, rtol=0)
    assert got_g.keys() == want_g.keys()
    for k in want_g:
        scale = max(np.abs(want_g[k]).max(), 1.0)
        np.testing.assert_allclose(got_g[k], want_g[k], atol=GTOL * scale,
                                   rtol=0, err_msg=k)
    # and the dropout did something
    plain = getattr(tm, name)(tcfg, device="cpu")(
        tparams, _t(toks), labels=_t(labels), train=False)
    assert not np.allclose(plain.detach().numpy(), got_tok, atol=1e-3)


@pytest.mark.parametrize("L", [1, 2, 5, 24])
def test_lima_rates_equal_the_jax_package_s(L):
    for p in (0.1, 0.3):
        jcfg, tcfg, _ = _cfgs("gpt2", num_layers=L, hidden_dropout=p,
                              lima_dropout=True)
        want = np.asarray(jT._lima_dropout_rates(jcfg))
        got = tT._lima_dropout_rates(tcfg)
        assert len(got) == L
        assert np.array_equal(np.asarray(got, np.float32), want)
        assert [float(r) for r in want] == got


def test_keep_share_lies_within_binomial_bounds():
    n = 1 << 20
    for p in (0.9, 0.5):
        keep = mrandom.bernoulli(mrandom.base_key(3), p, (n,), "cpu")
        assert keep.dtype == torch.bool
        sd = (n * p * (1 - p)) ** 0.5
        assert abs(int(keep.sum()) - n * p) < 6 * sd
    x = torch.ones(1000, 1000)
    y = tT._dropout(x, 0.1, 5, True)
    assert set(torch.unique(y).tolist()) <= {0.0, float(
        torch.tensor(1.0) / torch.tensor(0.9))}
    assert abs(float(y.mean()) - 1.0) < 6 * (0.1 / 0.9 / 1e6) ** 0.5


def _gpt(**kw):
    cfg = tm.gpt2_config("tiny", **dict(KW, **kw))
    model = tm.GPTModel(cfg, device="cpu")
    return model, model.init(4)


def test_eval_draws_nothing(monkeypatch):
    model, params = _gpt()
    toks = torch.from_numpy(np.random.RandomState(1).randint(0, 64, (2, 16)))

    def refuse(*a, **kw):
        raise AssertionError("a mask was drawn outside training")

    monkeypatch.setattr(mrandom, "bernoulli", refuse)
    with torch.no_grad():
        a = model(params, toks, labels=toks, rng_key=3, train=False)
        b = model(params, toks, labels=toks, train=True)  # no key
    assert torch.equal(a, b)
    opt = MegatronOptimizer(TrainConfig())
    batch = {"tokens": toks[None], "labels": toks[None],
             "loss_mask": torch.ones(1, 2, 16)}
    ev = build_train_step(model, opt, ParallelConfig(), 1,
                          forward_only=True)
    assert float(ev(params, batch, 7)) == pytest.approx(float(a.mean()))


def test_masks_differ_by_micro_batch_and_step():
    model, params = _gpt()
    toks = torch.from_numpy(np.random.RandomState(1).randint(0, 64, (2, 16)))
    base = mrandom.base_key(1234)
    with torch.no_grad():
        def loss(key):
            return model(params, toks, labels=toks, rng_key=key,
                         train=True)
        step0 = mrandom.fold_in(base, 0)
        a, a2 = loss(mrandom.fold_in(step0, 0)), loss(mrandom.fold_in(step0, 0))
        b = loss(mrandom.fold_in(step0, 1))
        c = loss(mrandom.fold_in(mrandom.fold_in(base, 1), 0))
    assert torch.equal(a, a2)
    assert not torch.equal(a, b) and not torch.equal(a, c)


def _expected_draws(cfg, mkey, b, s):
    """(key, shape) of every mask a training forward on micro-batch key
    ``mkey`` draws, in order: the embedding, then each layer's attention
    probs, the sum after attention and the MLP output (Falcon's parallel
    layer drops its one attention + MLP sum)."""
    h, ng = cfg.hidden_size, cfg.num_attention_heads_kv or \
        cfg.num_attention_heads
    probs = (b, ng, cfg.num_attention_heads // ng, s, s)
    k_embed, k_stack = mrandom.split(mkey)
    want = [(k_embed, (b, s, h))]
    for key in mrandom.split(k_stack, cfg.num_layers):
        k_attn, k_h1, k_h2 = mrandom.split(key, 3)
        want += [(k_attn, probs), (k_h1, (b, s, h))]
        if not cfg.parallel_attn:
            want.append((k_h2, (b, s, h)))
    return want


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_every_site_draws_its_own_stream(monkeypatch, family):
    """A training step of two micro-batches draws one mask a site, each
    from its own key: 3L + 1 distinct keys a micro-batch (2L + 1 for
    Falcon's parallel layer), none shared across the micro-batches."""
    _, tcfg, name = _cfgs(family)
    model = getattr(tm, name)(tcfg, device="cpu")
    params = model.init(4)
    draws = []
    real = mrandom.bernoulli

    def record(key, p, shape, device):
        draws.append((key, tuple(shape)))
        return real(key, p, shape, device)

    monkeypatch.setattr(mrandom, "bernoulli", record)
    toks = torch.from_numpy(np.random.RandomState(1).randint(0, 64,
                                                             (2, 2, 16)))
    batch = {"tokens": toks, "labels": toks,
             "loss_mask": torch.ones(2, 2, 16)}
    opt = MegatronOptimizer(TrainConfig())
    step = build_train_step(model, opt, ParallelConfig(), 2)
    step_key = mrandom.fold_in(mrandom.base_key(1234), 0)
    step(params, opt.init(params), batch, step_key, 1e-3, 0.0)
    want = [d for i in range(2) for d in _expected_draws(
        tcfg, mrandom.fold_in(step_key, i), 2, 16)]
    assert draws == want
    per_micro = (2 if tcfg.parallel_attn else 3) * tcfg.num_layers + 1
    assert len(draws) == 2 * per_micro
    assert len({k for k, _ in draws}) == len(draws)


def _corpus(tmp_path, vocab=64, docs=120):
    from megatron_llm_torch.data.indexed_dataset import make_builder

    prefix = str(tmp_path / "corpus_text_document")
    rng = np.random.RandomState(1234)
    b = make_builder(prefix + ".bin", vocab_size=vocab)
    for _ in range(docs):
        b.add_item(rng.randint(0, vocab, rng.randint(5, 80)))
        b.end_document()
    b.finalize(prefix + ".idx")
    return prefix


def test_resume_draws_the_uninterrupted_masks(tmp_path, monkeypatch):
    from megatron_llm_torch import checkpointing, pretrain_gpt, training

    prefix = _corpus(tmp_path)
    flags = ["--num_layers=2", "--hidden_size=32",
             "--num_attention_heads=4", "--seq_length=16",
             "--max_position_embeddings=16", "--micro_batch_size=2",
             "--global_batch_size=4", "--lr=1e-3", "--vocab_size=64",
             "--log_interval=1", "--device", "cpu", "--data_path", prefix,
             "--split", "90,10,0", "--eval_interval", "100",
             "--eval_iters", "1", "--train_iters=2"]
    losses = {}
    real = training.training_log

    def log_line(iteration, train_iters, metrics, *a, **kw):
        losses[iteration, run[0]] = metrics["lm loss"]
        return real(iteration, train_iters, metrics, *a, **kw)

    monkeypatch.setattr(training, "training_log", log_line)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    run = ["straight"]
    assert pretrain_gpt.main(flags + ["--save", a, "--save_interval",
                                      "1"]) == 2
    run[0] = "resumed"
    assert pretrain_gpt.main(flags + ["--load", a, "--load_iters", "1",
                                      "--save", b]) == 2
    assert losses[2, "resumed"] == losses[2, "straight"]
    for part in ("model", "optim"):
        pa = checkpointing._read_tree(os.path.join(a, "iter_0000002", part),
                                      "cpu")
        pb = checkpointing._read_tree(os.path.join(b, "iter_0000002", part),
                                      "cpu")
        assert sorted(pa) == sorted(pb)
        for k in pa:
            assert torch.equal(pa[k], pb[k]), k
    # the same run without dropout takes another path
    run[0] = "no dropout"
    pretrain_gpt.main(flags + ["--hidden_dropout=0", "--attention_dropout=0",
                               "--train_iters=1"])
    assert losses[1, "no dropout"] != losses[1, "straight"]
