#!/usr/bin/env python
"""Port checkpoint -> HuggingFace conversion (the twin of the repo's
``weights_conversion/megatron_to_hf.py``).

Reference: ``weights_conversion/megatron_to_hf.py`` — inverse QKV/FFN
un-packing (:47-79) and per-architecture writers (:80-572).

It reads a port checkpoint (``megatron_llm_torch/checkpointing.py``; the
param tree holds torch tensors) and ``save_pretrained``s the HF model.
``hf_config_for`` writes the rope settings in the spelling of the
installed ``transformers``: ``rope_theta`` / ``rope_scaling`` (4.x), or
one ``rope_parameters`` dict where the config class takes it (5.x).
Mixtral's experts are written in the layout the installed class holds:
per-expert ``block_sparse_moe.experts.{e}.w1/w2/w3`` (4.x) or the fused
``mlp.experts.gate_up_proj`` / ``down_proj`` (5.x).

Usage:
    python -m megatron_llm_torch.weights_conversion.megatron_to_hf \\
        --input_dir /ckpts/llama2-7b --output_dir /out/hf --model llama2
"""

from __future__ import annotations

import argparse
import inspect
import time
from typing import Optional, Sequence

import numpy as np
import torch

from megatron_llm_torch.weights_conversion.util import (
    rotary_interleaved_to_hf,
    rotary_interleaved_to_hf_bias,
    unpack_glu_ffn,
    unpack_qkv,
    unpack_qkv_bias,
)


def _f32(a) -> np.ndarray:
    """A leaf (a tensor of any dtype and device, or an array) as fp32
    numpy on the host."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32).numpy()
    return np.asarray(a, np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(_f32(a)))


def _dense_glu_mlp_writer(sd, p, g, t):
    gate, up = unpack_glu_ffn(g("mlp", "dense_h_to_4h", "kernel"))
    sd[p + "mlp.gate_proj.weight"] = t(gate)
    sd[p + "mlp.up_proj.weight"] = t(up)
    sd[p + "mlp.down_proj.weight"] = t(
        np.ascontiguousarray(g("mlp", "dense_4h_to_h", "kernel").T))


def llama_family_state_dict(params, config, *, mlp_writer=None):
    """param tree -> HF LlamaForCausalLM/MistralForCausalLM state dict.

    ``mlp_writer(sd, prefix, g, t)``: per-layer mlp emitter hook —
    defaults to the dense GLU mlp."""
    nh = config["num_attention_heads"]
    ng = config.get("num_attention_heads_kv") or nh
    # gemma decouples head_dim from hidden/heads
    d = config.get("kv_channels") or config["hidden_size"] // nh
    L = config["num_layers"]
    t = _t
    mlp_writer = mlp_writer or _dense_glu_mlp_writer

    sd = {
        "model.embed_tokens.weight": t(
            params["embedding"]["word"]["embedding"]),
        "model.norm.weight": t(params["transformer"]["final_norm"]["scale"]),
    }
    if "lm_head" in params:
        sd["lm_head.weight"] = t(params["lm_head"]["weight"])
    else:
        # tied head (Qwen2-0.5B/1.5B): HF re-ties from the embedding
        sd["lm_head.weight"] = sd["model.embed_tokens.weight"]
    layers = params["transformer"]["layers"]
    has_qkv_bias = "bias" in layers["attention"]["query_key_value"]
    for i in range(L):
        g = lambda *path: _f32(_index(layers, path, i))
        p = f"model.layers.{i}."
        q, k, v = unpack_qkv(g("attention", "query_key_value", "kernel"),
                             nh, ng, d)
        sd[p + "self_attn.q_proj.weight"] = t(rotary_interleaved_to_hf(q, d))
        sd[p + "self_attn.k_proj.weight"] = t(rotary_interleaved_to_hf(k, d))
        sd[p + "self_attn.v_proj.weight"] = t(v)
        if has_qkv_bias:
            qb, kb, vb = unpack_qkv_bias(
                g("attention", "query_key_value", "bias"), nh, ng, d)
            sd[p + "self_attn.q_proj.bias"] = t(
                rotary_interleaved_to_hf_bias(qb, d))
            sd[p + "self_attn.k_proj.bias"] = t(
                rotary_interleaved_to_hf_bias(kb, d))
            sd[p + "self_attn.v_proj.bias"] = t(vb)
        sd[p + "self_attn.o_proj.weight"] = t(
            np.ascontiguousarray(g("attention", "dense", "kernel").T))
        mlp_writer(sd, p, g, t)
        sd[p + "input_layernorm.weight"] = t(g("input_norm", "scale"))
        sd[p + "post_attention_layernorm.weight"] = t(
            g("post_attention_norm", "scale"))
    return sd


def gemma_state_dict(params, config):
    """param tree -> HF GemmaForCausalLM state dict: the llama-family
    writer with the stored ``1 + w`` RMSNorm scales converted back to
    HF's zero-centered weights; the tied head is re-tied by HF."""
    sd = llama_family_state_dict(params, config)
    for k in list(sd):
        if k.endswith("layernorm.weight") or k == "model.norm.weight":
            sd[k] = sd[k] - 1.0
    return sd


def falcon_state_dict(params, config):
    """param tree -> HF FalconForCausalLM state dict (inverse of
    hf_to_megatron.convert_falcon; reference writer:
    megatron_to_hf.py:333-475)."""
    nh = config["num_attention_heads"]
    ng = config.get("num_attention_heads_kv") or nh
    d = config["hidden_size"] // nh
    qpg = nh // ng
    L = config["num_layers"]
    new_arch = bool(config.get("parallel_layernorm"))
    t = _t

    emb = _f32(params["embedding"]["word"]["embedding"])
    sd = {
        "transformer.word_embeddings.weight": t(emb),
        "transformer.ln_f.weight": t(
            params["transformer"]["final_norm"]["scale"]),
        "transformer.ln_f.bias": t(
            params["transformer"]["final_norm"]["bias"]),
        "lm_head.weight": t(emb),          # falcon ties head to embeddings
    }
    layers = params["transformer"]["layers"]
    for i in range(L):
        g = lambda *path: _f32(_index(layers, path, i))
        p = f"transformer.h.{i}."
        # grouped qkv with per-(q|k)-head rotary de-interleave, v untouched
        w = np.ascontiguousarray(
            g("attention", "query_key_value", "kernel").T)
        hid = w.shape[-1]
        w = w.reshape(ng, qpg + 2, d, hid)
        for grp in range(ng):
            for h in range(qpg + 1):
                w[grp, h] = rotary_interleaved_to_hf(
                    w[grp, h].reshape(d, hid), d).reshape(d, hid)
        sd[p + "self_attention.query_key_value.weight"] = t(
            w.reshape(ng * (qpg + 2) * d, hid))
        sd[p + "self_attention.dense.weight"] = t(
            np.ascontiguousarray(g("attention", "dense", "kernel").T))
        sd[p + "mlp.dense_h_to_4h.weight"] = t(
            np.ascontiguousarray(g("mlp", "dense_h_to_4h", "kernel").T))
        sd[p + "mlp.dense_4h_to_h.weight"] = t(
            np.ascontiguousarray(g("mlp", "dense_4h_to_h", "kernel").T))
        if new_arch:
            sd[p + "ln_attn.weight"] = t(g("input_norm", "scale"))
            sd[p + "ln_attn.bias"] = t(g("input_norm", "bias"))
            sd[p + "ln_mlp.weight"] = t(g("mlp_norm", "scale"))
            sd[p + "ln_mlp.bias"] = t(g("mlp_norm", "bias"))
        else:
            sd[p + "input_layernorm.weight"] = t(g("input_norm", "scale"))
            sd[p + "input_layernorm.bias"] = t(g("input_norm", "bias"))
    return sd


def mixtral_state_dict(params, config, fused: bool = False):
    """param tree -> HF MixtralForCausalLM state dict (the inverse of
    ``hf_to_megatron.convert_mixtral``): the trunk shared with the llama
    family, the MoE MLP back to the router's ``gate.weight`` and the
    experts, per expert ``w1``/``w3``/``w2`` under ``block_sparse_moe.``
    or, with ``fused`` (transformers 5.x), one ``gate_up_proj`` [E, 2f, h]
    and one ``down_proj`` [E, h, f] under ``mlp.``."""
    E = config["num_experts"]

    def moe_writer(sd, p, g, t):
        moe = p + ("mlp." if fused else "block_sparse_moe.")
        sd[moe + "gate.weight"] = t(
            np.ascontiguousarray(g("mlp", "router", "kernel").T))
        w_in = g("mlp", "experts", "w_in")      # [E, h, 2f]
        w_out = g("mlp", "experts", "w_out")    # [E, f, h]
        if fused:
            # each expert's matrix transposed by torch's copy, which runs
            # on all the host's threads (numpy's strided copy on one)
            sd[moe + "experts.gate_up_proj"] = torch.from_numpy(
                w_in).transpose(1, 2).contiguous()
            sd[moe + "experts.down_proj"] = torch.from_numpy(
                w_out).transpose(1, 2).contiguous()
            return
        for e in range(E):
            gate, up = unpack_glu_ffn(w_in[e])
            sd[f"{moe}experts.{e}.w1.weight"] = t(gate)
            sd[f"{moe}experts.{e}.w3.weight"] = t(up)
            sd[f"{moe}experts.{e}.w2.weight"] = t(
                np.ascontiguousarray(w_out[e].T))

    return llama_family_state_dict(params, config, mlp_writer=moe_writer)


def fused_experts(hf_model) -> bool:
    """Whether the HF model holds each layer's experts fused
    (transformers 5.x) rather than one module per expert."""
    return any(k.endswith("experts.gate_up_proj")
               for k in hf_model.state_dict())


def _index(tree, path, i):
    for k in path:
        tree = tree[k]
    return tree[i]


def _rope_scaling_dict(config: dict):
    """framework rope fields -> HF ``rope_scaling`` (or None): the
    llama3 NTK-by-parts tuple wins, else a non-1.0 linear factor."""
    l3 = config.get("rope_llama3_scaling")
    if l3:
        return {
            "rope_type": "llama3", "factor": l3[0],
            "low_freq_factor": l3[1], "high_freq_factor": l3[2],
            "original_max_position_embeddings": int(l3[3]),
        }
    if config.get("rope_scaling_factor", 1.0) != 1.0:
        return {"rope_type": "linear",
                "factor": config["rope_scaling_factor"]}
    return None


def rope_kwargs(config_cls, theta: float, scaling) -> dict:
    """The rope settings as ``config_cls`` takes them: one
    ``rope_parameters`` dict (transformers 5.x), else ``rope_theta`` and
    ``rope_scaling``."""
    if "rope_parameters" in inspect.signature(config_cls.__init__).parameters:
        return {"rope_parameters": {"rope_type": "default", **(scaling or {}),
                                    "rope_theta": theta}}
    if scaling is None:
        return {"rope_theta": theta}
    return {"rope_theta": theta, "rope_scaling": scaling}


def hf_config_for(model_name: str, config: dict):
    rope_scaling = _rope_scaling_dict(config)
    if model_name in ("llama", "llama2", "llama3", "codellama"):
        from transformers import LlamaConfig

        return LlamaConfig(
            vocab_size=config["padded_vocab_size"],
            hidden_size=config["hidden_size"],
            intermediate_size=config["ffn_hidden_size"],
            num_hidden_layers=config["num_layers"],
            num_attention_heads=config["num_attention_heads"],
            num_key_value_heads=config.get("num_attention_heads_kv"),
            max_position_embeddings=config["max_position_embeddings"],
            rms_norm_eps=config.get("layernorm_epsilon", 1e-5),
            tie_word_embeddings=False,
            **rope_kwargs(LlamaConfig, config.get("rope_theta", 10000.0),
                           rope_scaling),
        )
    if model_name == "mistral":
        from transformers import MistralConfig

        return MistralConfig(
            vocab_size=config["padded_vocab_size"],
            hidden_size=config["hidden_size"],
            intermediate_size=config["ffn_hidden_size"],
            num_hidden_layers=config["num_layers"],
            num_attention_heads=config["num_attention_heads"],
            num_key_value_heads=config.get("num_attention_heads_kv"),
            max_position_embeddings=config["max_position_embeddings"],
            rms_norm_eps=config.get("layernorm_epsilon", 1e-5),
            sliding_window=config.get("sliding_window_size", 4096),
            tie_word_embeddings=False,
            **rope_kwargs(MistralConfig,
                           config.get("rope_theta", 10000.0), rope_scaling),
        )
    if model_name == "mixtral":
        from transformers import MixtralConfig

        return MixtralConfig(
            vocab_size=config["padded_vocab_size"],
            hidden_size=config["hidden_size"],
            intermediate_size=config["ffn_hidden_size"],
            num_hidden_layers=config["num_layers"],
            num_attention_heads=config["num_attention_heads"],
            num_key_value_heads=config.get("num_attention_heads_kv"),
            max_position_embeddings=config["max_position_embeddings"],
            rms_norm_eps=config.get("layernorm_epsilon", 1e-5),
            sliding_window=config.get("sliding_window_size"),
            num_local_experts=config["num_experts"],
            num_experts_per_tok=config.get("moe_top_k", 2),
            tie_word_embeddings=False,
            **rope_kwargs(MixtralConfig, config.get("rope_theta", 1e6),
                           rope_scaling),
        )
    if model_name == "falcon":
        from transformers import FalconConfig

        ng = config.get("num_attention_heads_kv") \
            or config["num_attention_heads"]
        new_arch = bool(config.get("parallel_layernorm"))
        return FalconConfig(
            vocab_size=config["padded_vocab_size"],
            hidden_size=config["hidden_size"],
            num_hidden_layers=config["num_layers"],
            num_attention_heads=config["num_attention_heads"],
            num_kv_heads=ng,
            new_decoder_architecture=new_arch,
            multi_query=(ng == 1 and not new_arch),
            parallel_attn=bool(config.get("parallel_attn", True)),
            bias=bool(config.get("add_bias_linear", False)),
            layer_norm_epsilon=config.get("layernorm_epsilon", 1e-5),
            tie_word_embeddings=True,
        )
    if model_name == "gemma":
        from transformers import GemmaConfig

        return GemmaConfig(
            vocab_size=config["padded_vocab_size"],
            hidden_size=config["hidden_size"],
            intermediate_size=config["ffn_hidden_size"],
            num_hidden_layers=config["num_layers"],
            num_attention_heads=config["num_attention_heads"],
            num_key_value_heads=config.get("num_attention_heads_kv"),
            head_dim=config.get("kv_channels"),
            max_position_embeddings=config["max_position_embeddings"],
            rms_norm_eps=config.get("layernorm_epsilon", 1e-6),
            hidden_act="gelu_pytorch_tanh",
            tie_word_embeddings=True,
            **rope_kwargs(GemmaConfig, config.get("rope_theta", 10000.0),
                           None),
        )
    if model_name == "qwen2":
        from transformers import Qwen2Config

        return Qwen2Config(
            vocab_size=config["padded_vocab_size"],
            hidden_size=config["hidden_size"],
            intermediate_size=config["ffn_hidden_size"],
            num_hidden_layers=config["num_layers"],
            num_attention_heads=config["num_attention_heads"],
            num_key_value_heads=config.get("num_attention_heads_kv"),
            max_position_embeddings=config["max_position_embeddings"],
            rms_norm_eps=config.get("layernorm_epsilon", 1e-6),
            use_sliding_window=config.get("sliding_window_size") is not None,
            sliding_window=config.get("sliding_window_size"),
            tie_word_embeddings=bool(config.get("tie_embed_logits", False)),
            **rope_kwargs(Qwen2Config, config.get("rope_theta", 1e6),
                           rope_scaling),
        )
    raise NotImplementedError(f"HF export for {model_name!r}")


WRITERS = {"falcon": falcon_state_dict, "mixtral": mixtral_state_dict,
           "gemma": gemma_state_dict}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--input_dir", "--input-dir", dest="input_dir",
                   required=True)
    p.add_argument("--output_dir", "--output-dir", dest="output_dir",
                   required=True)
    p.add_argument("--model", default=None,
                   help="override model family (else read from ckpt args)")
    return p


def empty_model(hf_cfg):
    """The HF model with its parameters on the meta device: no memory and
    no random init, since the exported weights replace every parameter
    (``load_state_dict(..., assign=True)``).  It is built under
    ``torch.device("meta")``, which holds for this thread alone; the
    modules that then hold meta buffers (the rotary ``inv_freq``, which
    is not saved) are built again on the host from their config."""
    from transformers import AutoModelForCausalLM

    with torch.device("meta"):
        hf = AutoModelForCausalLM.from_config(hf_cfg)
    for name, module in list(hf.named_modules()):
        if any(b.is_meta for b in module.buffers(recurse=False)):
            parent, _, child = name.rpartition(".")
            hf.get_submodule(parent).register_module(
                child, type(module)(config=module.config))
    return hf


def main(argv: Optional[Sequence[str]] = None) -> None:
    t0 = time.perf_counter()
    from megatron_llm_torch import checkpointing

    args = build_parser().parse_args(argv)
    params, _, meta = checkpointing.load_checkpoint(
        args.input_dir, finetune=True, device="cpu")
    if params is None:
        # release checkpoint
        params, _, meta = checkpointing.load_checkpoint(
            args.input_dir, release=True, finetune=True, device="cpu")
    config = meta["args"]
    model_name = args.model or config.get("model_name", "llama2")
    t1 = time.perf_counter()

    hf_cfg = hf_config_for(model_name, config)
    hf = empty_model(hf_cfg)
    if model_name == "mixtral":
        sd = mixtral_state_dict(params, config, fused=fused_experts(hf))
    else:
        sd = WRITERS.get(model_name, llama_family_state_dict)(params, config)
    del params
    t2 = time.perf_counter()
    missing, unexpected = hf.load_state_dict(sd, strict=False, assign=True)
    hf.tie_weights()
    left = [n for n, p in [*hf.named_parameters(), *hf.named_buffers()]
            if p.is_meta]
    if left or unexpected:
        raise ValueError(f"the {model_name} state dict does not fill "
                         f"{type(hf).__name__}: missing {left}, unexpected "
                         f"{unexpected}")
    if missing:
        print(f" note: tied, not written: {missing}")
    hf.save_pretrained(args.output_dir, safe_serialization=True)
    print(f" exported {args.input_dir} -> {args.output_dir}: read "
          f"{t1 - t0:.2f} s, convert {t2 - t1:.2f} s, write "
          f"{time.perf_counter() - t2:.2f} s", flush=True)


if __name__ == "__main__":
    main()
