"""The port's HF/Meta converters against the JAX package's and against HF:
tiny HF models built here from local configs (no download), one per
family.  The port's converter output equals the JAX converter's leaf for
leaf, bit for bit (both are numpy permutations of the same weights); the
port's fp32 logits on the CPU lie within 1e-4 of HF's; ``megatron_to_hf``
gives HF's state dict back bit for bit; the rope settings are read in
both spellings of ``transformers``; the CLI writes a release checkpoint
the port loads; and ``--meta_weights`` gives the JAX Meta path's params."""

import json
import types

import numpy as np
import pytest
import torch

from megatron_llm_torch import checkpointing
from megatron_llm_torch.config import transformer_config_from_dict
from megatron_llm_torch.models import MODEL_REGISTRY
from megatron_llm_torch.weights_conversion import hf_to_megatron as port
from megatron_llm_torch.weights_conversion import megatron_to_hf as port_back

transformers = pytest.importorskip("transformers")

from weights_conversion import hf_to_megatron as ref  # noqa: E402

torch.set_num_threads(2)
TOL = 1e-4

# family -> (HF class, config kwargs, port converter name, tokens shape)
FAMILIES = {
    "llama2": ("LlamaForCausalLM", "LlamaConfig", dict(
        vocab_size=128, hidden_size=64, intermediate_size=176,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-5,
        tie_word_embeddings=False), (2, 16)),
    # Llama-3.1's theta and NTK-by-parts remap; positions past the
    # original 32 are where the remap bites
    "llama3": ("LlamaForCausalLM", "LlamaConfig", dict(
        vocab_size=128, hidden_size=64, intermediate_size=176,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-5, rope_theta=5e5,
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 32},
        tie_word_embeddings=False), (2, 96)),
    "mistral": ("MistralForCausalLM", "MistralConfig", dict(
        vocab_size=128, hidden_size=64, intermediate_size=176,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, sliding_window=8,
        tie_word_embeddings=False), (1, 32)),
    "qwen2": ("Qwen2ForCausalLM", "Qwen2Config", dict(
        vocab_size=128, hidden_size=64, intermediate_size=176,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-6,
        tie_word_embeddings=False, rope_theta=1e6), (2, 16)),
    # decoupled head_dim (32 != 64 / 4), MQA, tied head
    "gemma": ("GemmaForCausalLM", "GemmaConfig", dict(
        vocab_size=256, hidden_size=64, intermediate_size=176,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=1,
        head_dim=32, max_position_embeddings=64, rms_norm_eps=1e-6,
        hidden_act="gelu_pytorch_tanh"), (2, 16)),
    "gpt_neox": ("GPTNeoXForCausalLM", "GPTNeoXConfig", dict(
        vocab_size=256, hidden_size=64, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=64, rotary_pct=0.25,
        use_parallel_residual=True, layer_norm_eps=1e-5,
        hidden_act="gelu"), (2, 16)),
    # 4 experts, top-2, GQA; the converted capacity is dropless, as HF's
    # routing is
    "mixtral": ("MixtralForCausalLM", "MixtralConfig", dict(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=64, rms_norm_eps=1e-5,
        tie_word_embeddings=False), (2, 16)),
    # the new decoder architecture with 2 KV heads (the JAX tests' case)
    "falcon": ("FalconForCausalLM", "FalconConfig", dict(
        vocab_size=128, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_kv_heads=2, multi_query=True,
        new_decoder_architecture=True, parallel_attn=True, bias=False,
        max_position_embeddings=64, tie_word_embeddings=True,
        alibi=False), (2, 16)),
}

CONVERTER = {"llama2": "convert_llama_family",
             "llama3": "convert_llama_family",
             "mistral": "convert_llama_family", "qwen2": "convert_qwen2",
             "gemma": "convert_gemma", "gpt_neox": "convert_gpt_neox",
             "falcon": "convert_falcon", "mixtral": "convert_mixtral"}


def _hf(family, seed=0, **over):
    model_cls, cfg_cls, kw, _ = FAMILIES[family]
    torch.manual_seed(seed)
    cfg = getattr(transformers, cfg_cls)(**{**kw, **over})
    return getattr(transformers, model_cls)(cfg).eval()


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _port_model(family, config):
    cfg = transformer_config_from_dict(config)
    if family == "mistral":
        # the registry's MistralModel holds the published 4096 window
        return MODEL_REGISTRY["gpt"](cfg, device="cpu")
    return MODEL_REGISTRY[family](cfg, device="cpu")


def _hf_logits(hf, toks):
    with torch.no_grad():
        return hf(torch.from_numpy(toks)).logits


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_converter_matches_the_jax_converter_bit_for_bit(family):
    hf = _hf(family)
    params, config = getattr(port, CONVERTER[family])(hf)
    want_params, want_config = getattr(ref, CONVERTER[family])(hf)
    assert config == want_config
    got, want = _flat(params), _flat(want_params)
    assert sorted(got) == sorted(want)
    for key, leaf in got.items():
        assert leaf.dtype == torch.float32
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(want[key]),
                                      err_msg=str(key))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_port_logits_match_hf(family):
    hf = _hf(family, seed=1)
    params, config = getattr(port, CONVERTER[family])(hf)
    toks = np.random.RandomState(0).randint(
        0, config["padded_vocab_size"], FAMILIES[family][3])
    got = _port_model(family, config)(params, torch.from_numpy(toks))
    err = float((got - _hf_logits(hf, toks)).abs().max())
    assert err < TOL, err


def test_falcon7b_form_takes_hf_kv_heads():
    """Falcon-7B's form (multi_query on the original architecture): HF's
    config carries num_kv_heads equal to the query heads, but the model
    has one KV head; the port converts it as HF runs it."""
    hf = _hf("falcon", seed=2, num_kv_heads=None,
             new_decoder_architecture=False)
    params, config = port.convert_falcon(hf)
    assert hf.config.num_kv_heads == 4 and config["num_attention_heads_kv"] \
        == 1
    qkv = params["transformer"]["layers"]["attention"]["query_key_value"]
    assert tuple(qkv["kernel"].shape) == (2, 64, (4 + 2) * 16)
    toks = np.random.RandomState(1).randint(0, 128, (2, 16))
    got = _port_model("falcon", config)(params, torch.from_numpy(toks))
    assert float((got - _hf_logits(hf, toks)).abs().max()) < TOL
    back = port_back.falcon_state_dict(params, config)
    for k, v in hf.state_dict().items():
        assert torch.equal(back[k], v), k


WRITER = {"llama2": "llama_family_state_dict",
          "llama3": "llama_family_state_dict",
          "mistral": "llama_family_state_dict",
          "qwen2": "llama_family_state_dict",
          "gemma": "gemma_state_dict", "falcon": "falcon_state_dict",
          "mixtral": "mixtral_state_dict"}


@pytest.mark.parametrize("family", sorted(WRITER))
def test_megatron_to_hf_round_trips_bit_for_bit(family):
    hf = _hf(family, seed=3)
    params, config = getattr(port, CONVERTER[family])(hf)
    kw = ({"fused": port_back.fused_experts(hf)} if family == "mixtral"
          else {})
    back = getattr(port_back, WRITER[family])(params, config, **kw)
    orig = hf.state_dict()
    for k, v in orig.items():
        if k not in back and family == "gemma" and k == "lm_head.weight":
            continue                        # tied: HF re-ties it
        assert torch.equal(back[k], v), k
    # the regenerated config reads back the same rope settings, and the
    # state dict loads into it with nothing left over
    name = {"llama2": "llama2", "llama3": "llama3"}.get(family, family)
    cfg2 = port_back.hf_config_for(name, config)
    assert port.rope_settings(cfg2) == port.rope_settings(hf.config)
    hf2 = type(hf)(cfg2)
    missing, unexpected = hf2.load_state_dict(back, strict=False)
    assert not unexpected, unexpected
    toks = np.random.RandomState(2).randint(0, config["padded_vocab_size"],
                                            (1, 16))
    assert torch.equal(_hf_logits(hf2.eval(), toks), _hf_logits(hf, toks))


@pytest.mark.parametrize("family", sorted(WRITER))
def test_cli_round_trip_reloads_bit_for_bit(family, tmp_path):
    """``hf_to_megatron.main`` then ``megatron_to_hf.main`` (whose HF
    model starts with its parameters on the meta device): the saved
    model reloads with every tensor the original's and the same
    logits."""
    hf = _hf(family, seed=6)
    hf.save_pretrained(str(tmp_path / "hf"))
    port.main([family, "--model_path", str(tmp_path / "hf"), "--out",
               str(tmp_path / "ck")])
    port_back.main(["--input_dir", str(tmp_path / "ck"), "--output_dir",
                    str(tmp_path / "back")])
    back = type(hf).from_pretrained(str(tmp_path / "back"),
                                    dtype=torch.float32).eval()
    orig, got = hf.state_dict(), back.state_dict()
    assert sorted(got) == sorted(orig)
    for k, v in orig.items():
        assert torch.equal(got[k], v), k
    toks = np.random.RandomState(4).randint(0, FAMILIES[family][2][
        "vocab_size"], (1, 16))
    assert torch.equal(_hf_logits(back, toks), _hf_logits(hf, toks))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_export_model_starts_empty(family):
    """The export's HF model holds every parameter on the meta device and
    every buffer real: the rotary ``inv_freq`` equals a model built the
    usual way.  Modules built after it get real parameters again."""
    hf = _hf(family)
    empty = port_back.empty_model(hf.config)
    assert [n for n, _ in empty.named_parameters()] == [
        n for n, _ in hf.named_parameters()]
    assert all(p.is_meta for p in empty.parameters())
    bufs = dict(hf.named_buffers())
    assert bufs and sorted(dict(empty.named_buffers())) == sorted(bufs)
    for name, buf in empty.named_buffers():
        assert torch.equal(buf, bufs[name]), name
    assert not torch.nn.Linear(2, 2).weight.is_meta


def test_rope_settings_read_both_spellings():
    """transformers 4.x keeps rope_theta and rope_scaling as attributes,
    5.x one rope_parameters dict; a config with only the 5.x spelling
    converts to the same llama3 remap and theta."""
    hf = _hf("llama3", seed=4)
    attrs = port.rope_settings(hf.config)
    assert attrs[0] == 5e5 and attrs[1]["rope_type"] == "llama3"
    fields = {k: getattr(hf.config, k) for k in (
        "num_attention_heads", "num_key_value_heads", "hidden_size",
        "num_hidden_layers", "intermediate_size", "vocab_size",
        "rms_norm_eps", "max_position_embeddings", "tie_word_embeddings")}
    v5 = types.SimpleNamespace(**fields, rope_parameters={
        "rope_type": "llama3", "rope_theta": 5e5, "factor": 8.0,
        "low_freq_factor": 1.0, "high_freq_factor": 4.0,
        "original_max_position_embeddings": 32})
    assert not hasattr(v5, "rope_theta") and not hasattr(v5, "rope_scaling")
    shim = types.SimpleNamespace(config=v5, state_dict=hf.state_dict)
    got_params, got = port.convert_llama_family(shim)
    want_params, want = port.convert_llama_family(hf)
    assert got["rope_theta"] == want["rope_theta"] == 5e5
    assert got["rope_llama3_scaling"] == want["rope_llama3_scaling"] == (
        8.0, 1.0, 4.0, 32)
    assert got == want
    # a default rope type in the 5.x spelling is no scaling
    plain = types.SimpleNamespace(rope_parameters={"rope_type": "default",
                                                   "rope_theta": 1e6})
    assert port.rope_settings(plain) == (1e6, None)

    # hf_config_for writes the 5.x spelling where the class takes it
    class V5Config:
        def __init__(self, rope_parameters=None, **kw):
            self.rope_parameters = rope_parameters

    kw = port_back.rope_kwargs(V5Config, 5e5, port_back._rope_scaling_dict(
        want))
    assert port.rope_settings(V5Config(**kw)) == attrs


def _fused_names(sd, experts):
    """A 4.x Mixtral state dict under transformers 5.x's names: the
    router and the experts under ``mlp.``, each layer's experts fused
    into ``gate_up_proj`` [E, 2f, h] (w1 rows, then w3 rows) and
    ``down_proj`` [E, h, f] (as 5.x's loader fuses them)."""
    out, layers = {}, set()
    for k, v in sd.items():
        if ".block_sparse_moe.experts." in k:
            layers.add(k.split(".block_sparse_moe.")[0])
            continue
        out[k.replace(".block_sparse_moe.", ".mlp.")] = v
    for p in sorted(layers):
        moe = p + ".block_sparse_moe.experts."
        out[p + ".mlp.experts.gate_up_proj"] = torch.stack([
            torch.cat([sd[f"{moe}{e}.w1.weight"], sd[f"{moe}{e}.w3.weight"]])
            for e in range(experts)])
        out[p + ".mlp.experts.down_proj"] = torch.stack([
            sd[f"{moe}{e}.w2.weight"] for e in range(experts)])
    return out


def test_mixtral_raises():
    """Mixtral converts (it used to raise): a model holding
    transformers 5.x's fused expert layout gives the same params as the
    4.x layout, and the export writes whichever layout the installed
    class holds (``fused_experts``), bit for bit."""
    assert "mixtral" in port.build_parser()._actions[1].choices
    hf = _hf("mixtral", seed=4)
    sd = hf.state_dict()
    fused = _fused_names(sd, 4)
    assert not port_back.fused_experts(hf)
    assert port_back.fused_experts(types.SimpleNamespace(
        state_dict=lambda: fused))
    v5 = types.SimpleNamespace(config=hf.config, state_dict=lambda: fused)
    params, config = port.convert_mixtral(hf)
    p5, c5 = port.convert_mixtral(v5)
    assert c5 == config and config["moe_capacity_factor"] == 2.0
    got, want = _flat(p5), _flat(params)
    assert sorted(got) == sorted(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    back = port_back.mixtral_state_dict(params, config, fused=True)
    assert sorted(back) == sorted(fused)
    for k, v in fused.items():
        assert torch.equal(back[k], v), k
    cfg = port_back.hf_config_for("mixtral", config)
    assert (cfg.num_local_experts, cfg.num_experts_per_tok) == (4, 2)


def test_cli_writes_a_release_checkpoint_the_port_serves(tmp_path):
    hf = _hf("llama3", seed=5)
    hf.save_pretrained(str(tmp_path / "hf"))
    out = str(tmp_path / "ck")
    port.main(["llama3", "--model_path", str(tmp_path / "hf"), "--out", out,
               "--dtype", "fp32"])
    with open(tmp_path / "ck" / "latest_checkpointed_iteration.txt") as f:
        assert f.read() == "release"
    args = checkpointing.load_checkpoint_args(out)
    assert args["model_name"] == "llama3"
    assert args["rope_llama3_scaling"] == [8.0, 1.0, 4.0, 32]
    params, _, meta = checkpointing.load_checkpoint(out, device="cpu")
    toks = np.random.RandomState(3).randint(0, 128, (2, 64))
    got = _port_model("llama3", args)(params, torch.from_numpy(toks))
    assert float((got - _hf_logits(hf, toks)).abs().max()) < TOL
    # bf16 is the fp32 conversion rounded once
    out16 = str(tmp_path / "ck16")
    port.main(["llama3", "--model_path", str(tmp_path / "hf"), "--out",
               out16, "--dtype", "bf16"])
    p16, _, _ = checkpointing.load_checkpoint(out16, device="cpu")
    for key, leaf in _flat(p16).items():
        assert torch.equal(leaf, _flat(params)[key].to(torch.bfloat16)), key


DIM, FFN, HEADS, LAYERS, VOCAB = 16, 40, 4, 2, 64


def _write_meta_dir(path, rng, n_shards=2):
    """Meta's consolidated.*.pth shards and params.json, as
    tests/test_merge_llama.py builds them."""
    from megatron_llm_torch.weights_conversion.merge_llama import (
        MERGE_DIM,
        _short_name,
    )

    sd = {"tok_embeddings.weight": rng.randn(VOCAB, DIM),
          "norm.weight": rng.randn(DIM),
          "output.weight": rng.randn(VOCAB, DIM)}
    for i in range(LAYERS):
        p = f"layers.{i}."
        for k, shape in (("attention.wq", (DIM, DIM)),
                         ("attention.wk", (DIM, DIM)),
                         ("attention.wv", (DIM, DIM)),
                         ("attention.wo", (DIM, DIM)),
                         ("feed_forward.w1", (FFN, DIM)),
                         ("feed_forward.w2", (DIM, FFN)),
                         ("feed_forward.w3", (FFN, DIM))):
            sd[p + k + ".weight"] = rng.randn(*shape)
        sd[p + "attention_norm.weight"] = rng.randn(DIM)
        sd[p + "ffn_norm.weight"] = rng.randn(DIM)
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    for s in range(n_shards):
        shard = {}
        for name, arr in sd.items():
            dim = MERGE_DIM.get(_short_name(name))
            shard[name] = torch.from_numpy(
                arr.copy() if dim is None
                else np.split(arr, n_shards, axis=dim)[s].copy())
        torch.save(shard, path / f"consolidated.{s:02d}.pth")
    with open(path / "params.json", "w") as f:
        json.dump({"dim": DIM, "n_layers": LAYERS, "n_heads": HEADS,
                   "norm_eps": 1e-5, "vocab_size": VOCAB}, f)


def test_meta_weights_match_the_jax_meta_path(tmp_path):
    _write_meta_dir(tmp_path, np.random.RandomState(6))
    out = str(tmp_path / "ck")
    port.main(["llama2", "--model_path", str(tmp_path), "--meta_weights",
               "--out", out])
    params, _, meta = checkpointing.load_checkpoint(out, device="cpu")
    want_params, want_config = ref.CONVERTERS["llama2"](
        ref.MetaLlamaShim(str(tmp_path), "llama2"))
    assert meta["args"] == {**want_config, "model_name": "llama2"}
    got, want = _flat(params), _flat(want_params)
    assert sorted(got) == sorted(want)
    for key, leaf in got.items():
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(want[key]),
                                      err_msg=str(key))
    shim = port.MetaLlamaShim(str(tmp_path), "llama")
    assert shim.config.max_position_embeddings == 2048
