"""The dense model families of the port against the JAX package's, at the
JAX ``"tiny"`` shapes, from the same JAX-initialised params carried across
by megatron_llm_torch/weights.py: Falcon (with and without the MLP's own
LayerNorm), GPT-2 (learned positions, biases), GPT-NeoX (partial rotary),
Mistral, Qwen2 (QKV bias), Gemma (embedding multiplier, head_dim apart from
hidden / heads), and a post-LN GPT.  fp32: logits within 1e-4; for Falcon
and GPT-2 the loss and every param grad (2e-4 of the leaf's max-abs) and
one full optimizer step (params within 1e-5).  Also: the wrappers'
refusals, ``params_from_jax``'s checks of the tree against the config, the
trainer's and the server's presets, and both entry points with
``--model_name=falcon`` on the CPU."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import megatron_llm_tpu.models as jm
from megatron_llm_tpu.config import ParallelConfig as JaxParallelConfig
from megatron_llm_tpu.config import TrainConfig as JaxTrainConfig
from megatron_llm_tpu.models.language_model import (
    embedding_forward as jax_embedding_forward)
from megatron_llm_tpu.optimizer import MegatronOptimizer as JaxOptimizer
from megatron_llm_tpu.training import build_train_step as jax_train_step
import megatron_llm_torch.models as tm
from megatron_llm_torch import finetune
from megatron_llm_torch import run_text_generation_server as server
from megatron_llm_torch.arguments import parse_args
from megatron_llm_torch.config import (
    ParallelConfig,
    TrainConfig,
    transformer_config_from_args,
)
from megatron_llm_torch.models.language_model import embedding_forward
from megatron_llm_torch.optimizer import MegatronOptimizer
from megatron_llm_torch.serving import SamplingParams
from megatron_llm_torch.training import build_train_step
from megatron_llm_torch.tree import tree_leaves_with_path
from megatron_llm_torch.weights import params_from_jax, params_to_numpy

torch.set_num_threads(1)
SEQ = 16
SMALL = dict(seq_length=SEQ, max_position_embeddings=SEQ,
             padded_vocab_size=256)
NO_DROPOUT = dict(hidden_dropout=0.0, attention_dropout=0.0)
# name -> (model class name, config function name, overrides)
FAMILIES = {
    "falcon": ("FalconModel", "falcon_config", {}),
    "falcon_parallel_layernorm": ("FalconModel", "falcon_config",
                                  dict(parallel_layernorm=True,
                                       num_attention_heads_kv=2)),
    "gpt2": ("GPTModel", "gpt2_config", NO_DROPOUT),
    "gpt2_post_ln": ("GPTModel", "gpt2_config",
                     dict(NO_DROPOUT, use_post_ln=True)),
    "gpt_neox": ("GPTNeoXModel", "gpt_neox_config", {}),
    "mistral": ("MistralModel", "mistral_config", {}),
    "qwen2": ("Qwen2Model", "qwen2_config", {}),
    "gemma": ("GemmaModel", "gemma_config", {}),
    "mixtral": ("MixtralModel", "mixtral_config", {}),
}


def _models(name, **more):
    cls, cfg_fn, kw = FAMILIES[name]
    kw = dict(SMALL, **kw, **more)
    jmodel = getattr(jm, cls)(getattr(jm, cfg_fn)("tiny", **kw))
    jparams = jmodel.init(jax.random.PRNGKey(11))
    tcfg = getattr(tm, cfg_fn)("tiny", **kw)
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    return jmodel, jparams, getattr(tm, cls)(tcfg, device="cpu"), tparams


def _flat(tree):
    return {"/".join(p): np.asarray(v, np.float32)
            for p, v in tree_leaves_with_path(tree)}


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_logits_match_jax(name, flash):
    jmodel, jparams, tmodel, tparams = _models(name, use_flash_attn=flash)
    tokens = np.random.default_rng(0).integers(0, 256, (2, SEQ - 3))
    want = np.asarray(jmodel(jparams, jnp.asarray(tokens)))
    got = tmodel(tparams, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # the port's init draws the same tree the JAX init does
    own = tmodel.init(0)
    assert _flat(own).keys() == _flat(tparams).keys()
    for k, v in _flat(own).items():
        assert v.shape == _flat(tparams)[k].shape, k


@pytest.mark.parametrize("name", ["falcon", "falcon_parallel_layernorm",
                                  "gpt2", "gpt_neox"])
def test_loss_and_param_grads_match_jax(name):
    jmodel, jparams, tmodel, tparams = _models(name)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 256, (2, SEQ)).astype(np.int32)
    labels = np.roll(toks, -1, axis=-1)
    w = rng.standard_normal((2, SEQ)).astype(np.float32)

    def jloss(p):
        tok = jmodel(p, jnp.asarray(toks), labels=jnp.asarray(labels),
                     train=True)
        return jnp.sum(tok * w), tok

    (_, want_tok), want_g = jax.value_and_grad(jloss, has_aux=True)(jparams)
    named = tree_leaves_with_path(tparams)
    leaves = [p.requires_grad_(True) for _, p in named]
    tok = tmodel(tparams, torch.from_numpy(toks),
                 labels=torch.from_numpy(labels), train=True)
    np.testing.assert_allclose(tok.detach().numpy(), np.asarray(want_tok),
                               atol=1e-5, rtol=0)
    grads = torch.autograd.grad((tok * torch.from_numpy(w)).sum(), leaves)
    got = {"/".join(p): g.numpy() for (p, _), g in zip(named, grads)}
    want = _flat(jax.device_get(want_g))
    assert got.keys() == want.keys()
    for k in want:
        scale = max(np.abs(want[k]).max(), 1e-3)
        np.testing.assert_allclose(got[k], want[k], atol=2e-4 * scale,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("name", ["falcon", "gpt2"])
def test_one_train_step_matches_jax(name):
    jmodel, jparams, tmodel, tparams = _models(name)
    kw = dict(micro_batch_size=2, global_batch_size=4, train_iters=1,
              lr=1e-4, weight_decay=0.01, clip_grad=1.0)
    jopt = JaxOptimizer(JaxTrainConfig(**kw))
    topt = MegatronOptimizer(TrainConfig(**kw))
    jstep = jax_train_step(jmodel, jopt, JaxParallelConfig(), 2)
    tstep = build_train_step(tmodel, topt, ParallelConfig(), 2)
    before = _flat(jax.device_get(jparams))
    jp = jax.tree_util.tree_map(jnp.array, jparams)   # the step donates
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 256, (2, 2, SEQ)).astype(np.int32)
    b = {"tokens": toks, "labels": np.roll(toks, -1, axis=-1),
         "loss_mask": (rng.random(toks.shape) > 0.2).astype(np.float32)}
    jp, _, jmet = jstep(jp, jopt.init(jp),
                        {k: jnp.asarray(v) for k, v in b.items()},
                        jax.random.PRNGKey(0), 1e-4, 0.01)
    tparams, _, tmet = tstep(tparams, topt.init(tparams),
                             {k: torch.from_numpy(v) for k, v in b.items()},
                             None, 1e-4, 0.01)
    for key in ("lm loss", "grad_norm"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   atol=1e-5, rtol=1e-5, err_msg=key)
    got, want = _flat(params_to_numpy(tparams)), _flat(jax.device_get(jp))
    moved = 0.0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0,
                                   err_msg=k)
        moved = max(moved, np.abs(want[k] - before[k]).max())
    assert moved > 5e-5          # the step did move the params


def test_partial_rotary_leaves_the_tail_of_the_head_untouched():
    from megatron_llm_torch.models.transformer import rotary_freqs
    from megatron_llm_torch.ops.rope import apply_rotary_emb

    cfg = tm.gpt_neox_config("tiny", **SMALL)
    cos, sin = rotary_freqs(cfg, device="cpu")
    assert cos.shape == (SEQ, cfg.head_dim // 8)       # rot_d = d / 4
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, SEQ, 4, cfg.head_dim)).astype(np.float32))
    out = apply_rotary_emb(x, cos, sin)
    rot_d = cfg.head_dim // 4
    assert torch.equal(out[..., rot_d:], x[..., rot_d:])
    assert not torch.equal(out[:, 1:, :, :rot_d], x[:, 1:, :, :rot_d])


def test_embedding_multiplier_rounds_like_jax_in_bf16():
    """sqrt(3072) is no bf16 value: the scale is rounded to bf16 before
    the product in both packages, so the embeddings are equal."""
    kw = dict(SMALL, hidden_size=96, num_attention_heads=4,
              params_dtype="bf16", compute_dtype="bf16",
              embedding_multiplier=math.sqrt(3072))
    jcfg, tcfg = jm.gemma_config("tiny", **kw), tm.gemma_config("tiny", **kw)
    table = np.random.default_rng(4).standard_normal((256, 96)).astype(
        np.float32)
    toks = np.arange(40).reshape(2, 20)
    jtab = jnp.asarray(table).astype(jnp.bfloat16)
    ttab = torch.from_numpy(np.asarray(jtab, np.float32)).to(torch.bfloat16)
    want = jax_embedding_forward(jnp.asarray(toks), None,
                                 {"word": {"embedding": jtab}}, jcfg)
    got = embedding_forward(torch.from_numpy(toks), None,
                            {"word": {"embedding": ttab}}, tcfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("cls,cfg_fn,bad", [
    ("FalconModel", "falcon_config", dict(parallel_attn=False)),
    ("FalconModel", "falcon_config", dict(num_attention_heads_kv=4)),
    ("GPTNeoXModel", "gpt_neox_config", dict(parallel_layernorm=False)),
    ("GPTNeoXModel", "gpt_neox_config", dict(tie_embed_logits=True)),
    ("MistralModel", "mistral_config", dict(sliding_window_size=128)),
    ("Qwen2Model", "qwen2_config", dict(add_qkv_bias=False)),
    ("GemmaModel", "gemma_config", dict(glu_activation="swiglu")),
    ("GemmaModel", "gemma_config", dict(tie_embed_logits=False)),
    ("MixtralModel", "mixtral_config", dict(num_experts=0)),
    ("MixtralModel", "mixtral_config", dict(glu_activation="geglu")),
])
def test_wrappers_refuse_what_the_jax_wrappers_refuse(cls, cfg_fn, bad):
    with pytest.raises(AssertionError):
        getattr(jm, cls)(getattr(jm, cfg_fn)("tiny", **bad))
    with pytest.raises(ValueError):
        getattr(tm, cls)(getattr(tm, cfg_fn)("tiny", **bad), device="cpu")


@pytest.mark.parametrize("fn,size", [
    ("falcon_config", "7B"), ("falcon_config", "40B"),
    ("gpt2_config", "1.3B"), ("gpt_neox_config", "6.9b"),
    ("mistral_config", "7B"), ("qwen2_config", "0.5B"),
    ("gemma_config", "7B"), ("mixtral_config", "8x7B")])
def test_config_tables_equal_the_jax_tables(fn, size):
    want = getattr(jm, fn)(size)
    got = getattr(tm, fn)(size)
    for field in ("num_layers", "hidden_size", "num_attention_heads",
                  "num_attention_heads_kv", "ffn_hidden_size", "kv_channels",
                  "padded_vocab_size", "seq_length",
                  "max_position_embeddings", "normalization",
                  "glu_activation", "gelu_variant", "add_bias_linear",
                  "add_qkv_bias", "parallel_attn", "parallel_layernorm",
                  "tie_embed_logits", "rotary_percent", "rope_theta",
                  "layernorm_epsilon", "sliding_window_size",
                  "embedding_multiplier", "hidden_dropout",
                  "use_fused_layernorm", "use_fused_rmsnorm"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.position_embedding_type.value == \
        want.position_embedding_type.value
    assert set(tm.MODEL_REGISTRY) == set(jm.MODEL_REGISTRY)


def test_weights_check_the_tree_against_the_config():
    """A parallel-attention tree has no post_attention_norm (it used to
    raise KeyError), and a tree that does not fit the config's norms or
    positions is refused."""
    _, jparams, tmodel, _ = _models("falcon")
    tree = jax.device_get(jparams)
    assert "post_attention_norm" not in tree["transformer"]["layers"]
    out = params_from_jax(tree, tmodel.cfg, device="cpu")
    assert "bias" in out["transformer"]["layers"]["input_norm"]
    with pytest.raises(KeyError):       # the config asks for mlp_norm
        params_from_jax(tree, tmodel.cfg.replace(parallel_layernorm=True),
                        device="cpu")
    with pytest.raises(KeyError):       # sequential layers need their norm
        params_from_jax(tree, tmodel.cfg.replace(parallel_attn=False),
                        device="cpu")
    with pytest.raises(KeyError):       # LayerNorm leaves carry a bias
        params_from_jax(tree, tmodel.cfg.replace(normalization="rmsnorm"),
                        device="cpu")
    _, gparams, gmodel, _ = _models("gpt2")
    gtree = jax.device_get(gparams)
    assert gtree["embedding"]["position"]["embedding"].shape == (SEQ, 128)
    with pytest.raises(ValueError):     # a table of another length
        params_from_jax(gtree, gmodel.cfg.replace(
            max_position_embeddings=2 * SEQ), device="cpu")
    no_pos = dict(gtree, embedding={"word": gtree["embedding"]["word"]})
    with pytest.raises(KeyError):
        params_from_jax(no_pos, gmodel.cfg, device="cpu")
    with pytest.raises(KeyError):       # a rotary config takes no table
        params_from_jax(gtree, gmodel.cfg.replace(
            position_embedding_type="rotary"), device="cpu")


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

TINY = ["--num_layers=2", "--hidden_size=64", "--num_attention_heads=4",
        "--seq_length=32", "--max_position_embeddings=32",
        "--micro_batch_size=2", "--global_batch_size=4", "--train_iters=2",
        "--lr=1e-4", "--vocab_size=128", "--log_interval=1", "--device",
        "cpu"]


@pytest.mark.parametrize("family", ["falcon", "gpt_neox", "gemma", "gpt",
                                    "qwen2", "mistral", "llama3",
                                    "mixtral"])
def test_finetune_main_trains_the_family_on_the_cpu(family, capsys):
    extra = {"falcon": ["--num_attention_heads_kv=1"],
             "gpt": ["--hidden_dropout=0", "--attention_dropout=0"],
             "mixtral": ["--num_experts=4", "--num_attention_heads_kv=2"]}
    argv = [f"--model_name={family}"] + TINY + extra.get(family, [])
    assert finetune.main(argv) == 2
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith(" iteration")]
    assert len(lines) == 2 and "lm loss" in lines[0]
    if family == "mixtral":
        assert "moe aux loss" in lines[0]


def test_trainer_presets_are_the_jax_entry_points():
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "finetune.py")) as f:
        src = f.read()
    start = src.index("MODEL_DEFAULTS = {")
    end = src.index("\n}\n", start) + 3
    scope = {}
    exec(src[start:end], scope)        # the table is a literal
    assert finetune.MODEL_DEFAULTS == scope["MODEL_DEFAULTS"]
    assert importlib.util.find_spec("megatron_llm_torch.models.mixtral") \
        is not None
    # the mixtral preset lowers every MoE field into the config
    argv = ["--model_name=mixtral", "--moe_capacity_factor=2.0",
            "--moe_min_capacity=2", "--moe_aux_loss_coeff=0.05",
            "--moe_z_loss_coeff=1e-3"] + TINY
    args = parse_args(argv, extra_args_provider=finetune.extra_args)
    finetune._apply_model_defaults(args, argv)
    model = finetune.model_provider(args)
    assert type(model).__name__ == "MixtralModel"
    assert (model.cfg.num_experts, model.cfg.moe_top_k,
            model.cfg.moe_capacity_factor, model.cfg.moe_min_capacity,
            model.cfg.moe_aux_loss_coeff, model.cfg.moe_z_loss_coeff,
            model.cfg.rope_theta) == (8, 2, 2.0, 2, 0.05, 1e-3, 1e6)
    # the presets lower into the config; gemma derives its multiplier
    argv = ["--model_name=gemma"] + TINY
    args = parse_args(argv, extra_args_provider=finetune.extra_args)
    finetune._apply_model_defaults(args, argv)
    model = finetune.model_provider(args)
    assert model.cfg.embedding_multiplier == math.sqrt(64)
    assert model.cfg.glu_activation == "geglu"
    argv = ["--model_name=pythia"] + TINY
    args = parse_args(argv, extra_args_provider=finetune.extra_args)
    finetune._apply_model_defaults(args, argv)
    cfg = transformer_config_from_args(args)
    assert (cfg.parallel_attn, cfg.parallel_layernorm, cfg.rotary_percent,
            cfg.gelu_variant, cfg.add_bias_linear) == (
        True, True, 0.25, "exact", True)


class _FakeTokenizer:
    vocab_size = 64
    eod = 63
    pad = 0

    def tokenize(self, text):
        return [int(t) % 64 for t in text.split()]

    def detokenize(self, ids):
        return " ".join(str(i) for i in ids)


def test_server_builds_and_serves_falcon_with_int8_kv_on_the_cpu():
    argv = ["--model_name", "falcon", "--num_layers", "2", "--hidden_size",
            "64", "--num_attention_heads", "4", "--ffn_hidden_size", "96",
            "--padded_vocab_size", "64", "--seq_length", "64",
            "--max_position_embeddings", "64", "--device", "cpu",
            "--serve_num_slots", "2", "--serve_block_size", "8",
            "--serve_prefill_chunk", "16", "--seed", "0", "--int8_kv_cache"]
    srv = server.build_server(server.build_parser().parse_args(argv),
                              _FakeTokenizer())
    try:
        eng = srv.engine
        assert type(eng.model).__name__ == "FalconModel"
        assert eng.model.cfg.num_attention_heads_kv == 1
        assert "k_pages_q" in eng._st.pages[0]
        req = eng.submit([1, 2, 3, 4, 5],
                         SamplingParams(max_new_tokens=6,
                                               temperature=0.0))
        assert len(req.result(60).out_tokens) == 6
    finally:
        srv.engine.stop()


def test_server_families_take_their_own_config_tables():
    for family, (cfg_fn, size, presets) in server.FAMILIES.items():
        args = server.build_parser().parse_args(["--model_name", family])
        cfg = server.model_config_from_args(args)
        assert cfg == cfg_fn(size, **presets), family
        assert family in tm.MODEL_REGISTRY
    args = server.build_parser().parse_args(["--model_name", "falcon"])
    cfg = server.model_config_from_args(args)
    assert (cfg.hidden_size, cfg.num_attention_heads, cfg.num_query_groups,
            cfg.normalization, cfg.parallel_attn) == (
        4544, 71, 1, "layernorm", True)
