#!/usr/bin/env python
"""HuggingFace -> port checkpoint conversion (the twin of the repo's
``weights_conversion/hf_to_megatron.py``).

Reference: ``weights_conversion/hf_to_megatron.py`` — loads the HF model,
permutes the rotary QKV interleaving, packs the GQA layout, and writes a
TP=PP=1 ``release`` checkpoint with args (:259-449).

The output is the port's checkpoint (``megatron_llm_torch/checkpointing.py``:
the JAX package's layout and ``meta.json``, one ``torch.save`` payload),
written with ``checkpointing.save_checkpoint(..., release=True)``; the
param tree is the one ``megatron_llm_torch/weights.py`` documents, torch
tensors in the ``--dtype`` asked for.  The layout transforms are the JAX
converter's numpy permutations, so both converters give the same bits.

Two differences from the JAX converter, both in what is read from the HF
config: the rope settings are read in both spellings of ``transformers``
(``rope_theta`` / ``rope_scaling`` attributes, and the 5.x
``rope_parameters`` dict; ``rope_settings``), and Falcon's KV head count
follows HF's own rule (one KV head for a ``multi_query`` model of the
original architecture, whose config still carries ``num_kv_heads`` equal
to the query heads).

Usage:
    python -m megatron_llm_torch.weights_conversion.hf_to_megatron llama2 \\
        --model_path /path/to/hf-model --out /ckpts/llama2-7b --dtype bf16
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from megatron_llm_torch.weights_conversion.util import (
    pack_glu_ffn,
    pack_qkv,
    pack_qkv_bias,
    rotary_hf_to_interleaved,
    rotary_hf_to_interleaved_bias,
)

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16,
          "fp16": torch.float16}


def _tensor(a: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def stack_layer_tree(layers, dtype):
    """Per-layer param dicts of numpy arrays (identical structure) -> one
    stacked tree of tensors in ``dtype`` with a leading [num_layers] axis
    on every leaf."""

    def rec(template, *path):
        if isinstance(template, dict):
            return {k: rec(v, *path, k) for k, v in template.items()}

        def get(lp, keys):
            for kk in keys:
                lp = lp[kk]
            return lp
        return _tensor(np.stack([get(l, path) for l in layers]), dtype)

    return rec(layers[0])


def _np(t):
    # .copy() is load-bearing: .float() on an fp32 tensor is a no-op view,
    # so without it the numpy array aliases the live HF parameter and the
    # in-place rotary permutation would corrupt the source model.
    return t.detach().to("cpu").float().numpy().copy()


def _np_transposed(t):
    """Each [.., a, b] matrix of ``t`` as a contiguous fp32 [.., b, a]
    numpy copy (torch's copy runs on all the host's threads, numpy's
    strided one on one)."""
    return t.detach().to("cpu").float().transpose(-1, -2).contiguous(
    ).numpy()


def rope_settings(hf_cfg, default_theta: float = 10000.0):
    """(theta, scaling dict or None) of an HF config, in either spelling:
    ``rope_theta`` / ``rope_scaling`` attributes (transformers 4.x), or
    one ``rope_parameters`` dict holding ``rope_theta`` and the scaling
    fields under ``rope_type`` (5.x).  A ``default`` rope type is no
    scaling."""
    rp = getattr(hf_cfg, "rope_parameters", None)
    if isinstance(rp, dict) and rp:
        theta = rp.get("rope_theta")
        if theta is None:
            theta = getattr(hf_cfg, "rope_theta", None)
        scaling = {k: v for k, v in rp.items() if k != "rope_theta"}
    else:
        theta = getattr(hf_cfg, "rope_theta", None)
        scaling = getattr(hf_cfg, "rope_scaling", None)
    if scaling and (scaling.get("rope_type") or scaling.get("type")) in (
            None, "default"):
        scaling = None
    return float(default_theta if theta is None else theta), scaling or None


def _dense_glu_mlp(sd, p):
    """HF llama/mistral mlp.{gate,up,down}_proj -> dense GLU mlp subtree."""
    return {
        "dense_h_to_4h": {
            "kernel": pack_glu_ffn(
                _np(sd[p + "mlp.gate_proj.weight"]),
                _np(sd[p + "mlp.up_proj.weight"]),
            )
        },
        "dense_4h_to_h": {
            "kernel": np.ascontiguousarray(
                _np(sd[p + "mlp.down_proj.weight"]).T)
        },
    }


def convert_llama_family(hf_model, dtype=torch.float32, *, layer_mlp=None,
                         qkv_bias=False, norm_add_one=False):
    """LlamaForCausalLM / MistralForCausalLM -> param tree + config dict.

    reference: hf_to_megatron.py:117-258 (llama), :185-258 (mistral).
    ``layer_mlp(sd, prefix)``: per-layer mlp-subtree converter hook —
    defaults to the dense GLU mlp.
    ``qkv_bias``: pack the per-projection biases too (Qwen2).
    ``norm_add_one``: store RMSNorm scales as ``1 + hf_weight`` (Gemma's
    zero-centered convention folded into the weights — identical math).
    """
    hf_cfg = hf_model.config
    nh = hf_cfg.num_attention_heads
    ng = getattr(hf_cfg, "num_key_value_heads", nh)
    # gemma decouples head_dim from hidden/heads
    d = getattr(hf_cfg, "head_dim", None) or hf_cfg.hidden_size // nh
    norm = (lambda w: w + 1.0) if norm_add_one else (lambda w: w)
    sd = dict(hf_model.state_dict())
    layer_mlp = layer_mlp or _dense_glu_mlp

    layers = []
    for i in range(hf_cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        q = rotary_hf_to_interleaved(_np(sd[p + "self_attn.q_proj.weight"]), d)
        k = rotary_hf_to_interleaved(_np(sd[p + "self_attn.k_proj.weight"]), d)
        v = _np(sd[p + "self_attn.v_proj.weight"])
        qkv = {"kernel": pack_qkv(q, k, v, nh, ng, d)}
        if qkv_bias:
            qb = rotary_hf_to_interleaved_bias(
                _np(sd[p + "self_attn.q_proj.bias"]), d)
            kb = rotary_hf_to_interleaved_bias(
                _np(sd[p + "self_attn.k_proj.bias"]), d)
            vb = _np(sd[p + "self_attn.v_proj.bias"])
            qkv["bias"] = pack_qkv_bias(qb, kb, vb, nh, ng, d)
        layers.append({
            "input_norm": {
                "scale": norm(_np(sd[p + "input_layernorm.weight"]))
            },
            "attention": {
                "query_key_value": qkv,
                "dense": {
                    "kernel": np.ascontiguousarray(
                        _np(sd[p + "self_attn.o_proj.weight"]).T)
                },
            },
            "post_attention_norm": {
                "scale": norm(_np(sd[p + "post_attention_layernorm.weight"]))
            },
            "mlp": layer_mlp(sd, p),
        })

    layer_tree = stack_layer_tree(layers, dtype)
    tied = bool(getattr(hf_cfg, "tie_word_embeddings", False))
    params = {
        "embedding": {
            "word": {"embedding": _tensor(
                _np(sd["model.embed_tokens.weight"]), dtype)}
        },
        "transformer": {
            "layers": layer_tree,
            "final_norm": {"scale": _tensor(
                norm(_np(sd["model.norm.weight"])), dtype)},
        },
    }
    if not tied:
        # tied HF models (Qwen2-0.5B/1.5B, small llamas) share the head
        # with the embedding — the tree must match the tied fresh-init
        # structure (no lm_head leaf) or checkpoints won't line up
        params["lm_head"] = {"weight": _tensor(
            _np(sd["lm_head.weight"]), dtype)}
    theta, rs = rope_settings(hf_cfg)
    config = {
        "num_layers": hf_cfg.num_hidden_layers,
        "hidden_size": hf_cfg.hidden_size,
        "num_attention_heads": nh,
        "num_attention_heads_kv": ng,
        "kv_channels": d,
        "ffn_hidden_size": hf_cfg.intermediate_size,
        "padded_vocab_size": hf_cfg.vocab_size,
        "seq_length": getattr(hf_cfg, "max_position_embeddings", 4096),
        "max_position_embeddings": getattr(hf_cfg, "max_position_embeddings",
                                           4096),
        "position_embedding_type": "rotary",
        "glu_activation": "swiglu",
        "normalization": "rmsnorm",
        "add_bias_linear": False,
        "tie_embed_logits": tied,
        "layernorm_epsilon": hf_cfg.rms_norm_eps,
        "rope_theta": theta,
        "sliding_window_size": getattr(hf_cfg, "sliding_window", None),
        "add_qkv_bias": qkv_bias,
        "hidden_dropout": 0.0,
        "attention_dropout": 0.0,
    }
    # HF rope scaling: {'rope_type': 'llama3', ...} (Llama-3.1+) or
    # {'rope_type'/'type': 'linear', 'factor': f}
    if rs:
        kind = rs.get("rope_type") or rs.get("type")
        if kind == "llama3":
            config["rope_llama3_scaling"] = (
                float(rs.get("factor", 8.0)),
                float(rs.get("low_freq_factor", 1.0)),
                float(rs.get("high_freq_factor", 4.0)),
                int(rs.get("original_max_position_embeddings", 8192)),
            )
        elif kind == "linear":
            config["rope_scaling_factor"] = float(rs.get("factor", 1.0))
        else:
            # yarn/dynamic/longrope/...: converting with plain rope would
            # silently diverge from HF — fail loud instead
            raise NotImplementedError(
                f"unsupported HF rope_scaling type {kind!r} "
                f"(supported: llama3, linear)")
    return params, config


def convert_gemma(hf_model, dtype=torch.float32):
    """GemmaForCausalLM -> param tree + config dict: llama-family path
    with the ``1 + w`` RMSNorm convention folded into the stored scales,
    GeGLU activation, decoupled head_dim, tied head, and the
    sqrt(hidden) embedding multiplier recorded in the config."""
    params, config = convert_llama_family(hf_model, dtype,
                                          norm_add_one=True)
    config["glu_activation"] = "geglu"
    config["embedding_multiplier"] = math.sqrt(config["hidden_size"])
    return params, config


def convert_gpt_neox(hf_model, dtype=torch.float32):
    """GPTNeoXForCausalLM (Pythia) -> param tree + config dict.

    HF packs QKV rows per head as [nh, 3, d] — identical to the grouped
    layout at ng == nh — so only the rotate-half -> interleaved
    permutation of each head's ROTARY dims (rotary_pct of d) is needed,
    applied to the q and k sub-blocks of weights and biases."""
    hf_cfg = hf_model.config
    if not getattr(hf_cfg, "use_parallel_residual", True):
        raise NotImplementedError(
            "GPT-NeoX with use_parallel_residual=False maps to the "
            "sequential layer layout; convert is only wired for the "
            "parallel-residual (Pythia) form")
    act = getattr(hf_cfg, "hidden_act", "gelu")
    if act == "gelu":
        gelu_variant = "exact"
    elif act in ("gelu_new", "gelu_fast", "gelu_pytorch_tanh"):
        gelu_variant = "tanh"
    else:
        raise NotImplementedError(f"gpt-neox hidden_act {act!r}")
    nh = hf_cfg.num_attention_heads
    h = hf_cfg.hidden_size
    d = h // nh
    rotary_pct = getattr(hf_cfg, "rotary_pct", None)
    if rotary_pct is None:
        # transformers 5.x: partial_rotary_factor, in rope_parameters
        rp = getattr(hf_cfg, "rope_parameters", None) or {}
        rotary_pct = rp.get("partial_rotary_factor",
                            getattr(hf_cfg, "partial_rotary_factor", 1.0))
    rot_d = int(d * rotary_pct)
    rot_d -= rot_d % 2
    sd = dict(hf_model.state_dict())

    def permute_qkv(w):
        """w [3*h(, hid)] in [nh, 3, d] row layout: permute the first
        rot_d dims of the q and k sub-blocks."""
        vec = w.ndim == 1
        if vec:
            w = w[:, None]
        x = w.reshape(nh, 3, d, w.shape[1]).copy()
        for j in (0, 1):                      # q and k, not v
            blk = x[:, j, :rot_d].reshape(nh * rot_d, w.shape[1])
            x[:, j, :rot_d] = rotary_hf_to_interleaved(
                blk, rot_d).reshape(nh, rot_d, w.shape[1])
        out = x.reshape(3 * h, w.shape[1])
        return out[:, 0] if vec else out

    layers = []
    for i in range(hf_cfg.num_hidden_layers):
        p = f"gpt_neox.layers.{i}."
        qkv_w = permute_qkv(_np(sd[p + "attention.query_key_value.weight"]))
        qkv_b = permute_qkv(_np(sd[p + "attention.query_key_value.bias"]))
        layers.append({
            "input_norm": {
                "scale": _np(sd[p + "input_layernorm.weight"]),
                "bias": _np(sd[p + "input_layernorm.bias"]),
            },
            "mlp_norm": {
                "scale": _np(sd[p + "post_attention_layernorm.weight"]),
                "bias": _np(sd[p + "post_attention_layernorm.bias"]),
            },
            "attention": {
                "query_key_value": {
                    "kernel": np.ascontiguousarray(qkv_w.T),
                    "bias": qkv_b,
                },
                "dense": {
                    "kernel": np.ascontiguousarray(
                        _np(sd[p + "attention.dense.weight"]).T),
                    "bias": _np(sd[p + "attention.dense.bias"]),
                },
            },
            "mlp": {
                "dense_h_to_4h": {
                    "kernel": np.ascontiguousarray(
                        _np(sd[p + "mlp.dense_h_to_4h.weight"]).T),
                    "bias": _np(sd[p + "mlp.dense_h_to_4h.bias"]),
                },
                "dense_4h_to_h": {
                    "kernel": np.ascontiguousarray(
                        _np(sd[p + "mlp.dense_4h_to_h.weight"]).T),
                    "bias": _np(sd[p + "mlp.dense_4h_to_h.bias"]),
                },
            },
        })

    params = {
        "embedding": {"word": {"embedding": _tensor(
            _np(sd["gpt_neox.embed_in.weight"]), dtype)}},
        "transformer": {
            "layers": stack_layer_tree(layers, dtype),
            "final_norm": {
                "scale": _tensor(
                    _np(sd["gpt_neox.final_layer_norm.weight"]), dtype),
                "bias": _tensor(
                    _np(sd["gpt_neox.final_layer_norm.bias"]), dtype),
            },
        },
        "lm_head": {"weight": _tensor(_np(sd["embed_out.weight"]), dtype)},
    }
    # transformers renamed rotary_emb_base -> rope_theta across versions
    # (and 5.x keeps it in rope_parameters); chain the lookups so no
    # spelling silently falls back to 10000
    base = getattr(hf_cfg, "rotary_emb_base", None)
    config = {
        "num_layers": hf_cfg.num_hidden_layers,
        "hidden_size": h,
        "num_attention_heads": nh,
        "ffn_hidden_size": hf_cfg.intermediate_size,
        "padded_vocab_size": hf_cfg.vocab_size,
        "seq_length": hf_cfg.max_position_embeddings,
        "max_position_embeddings": hf_cfg.max_position_embeddings,
        "position_embedding_type": "rotary",
        "glu_activation": None,
        "gelu_variant": gelu_variant,
        "normalization": "layernorm",
        "add_bias_linear": True,
        "parallel_attn": bool(hf_cfg.use_parallel_residual),
        "parallel_layernorm": bool(hf_cfg.use_parallel_residual),
        "tie_embed_logits": False,
        "rotary_percent": rotary_pct,
        "rope_theta": base or rope_settings(hf_cfg)[0],
        "layernorm_epsilon": hf_cfg.layer_norm_eps,
        "hidden_dropout": 0.0,
        "attention_dropout": 0.0,
    }
    return params, config


def convert_qwen2(hf_model, dtype=torch.float32):
    """Qwen2ForCausalLM -> param tree + config dict: the llama-family
    path with QKV biases packed (util.pack_qkv_bias).  Qwen2Config
    carries a sliding_window value even when use_sliding_window is False
    (the default) — honor the switch."""
    hf_cfg = hf_model.config
    if getattr(hf_cfg, "use_sliding_window", False) and \
            getattr(hf_cfg, "max_window_layers", 0) < hf_cfg.num_hidden_layers:
        raise NotImplementedError(
            "Qwen2 per-layer sliding windows (max_window_layers < "
            "num_hidden_layers) are not supported — a global window would "
            "silently change the lower layers' attention")
    params, config = convert_llama_family(hf_model, dtype, qkv_bias=True)
    if not getattr(hf_cfg, "use_sliding_window", False):
        config["sliding_window_size"] = None
    return params, config


def convert_mixtral(hf_model, dtype=torch.float32):
    """MixtralForCausalLM -> param tree + config dict.

    The trunk (embeddings, norms, GQA attention, lm_head) converts exactly
    like the llama family; the MoE block maps to the layout of
    ``models/moe.py``, from either layout of ``transformers``:

    * 4.x, ``block_sparse_moe.``: ``gate.weight`` [E, h] -> router kernel
      [h, E]; per expert ``w1`` (gate) and ``w3`` (up), both [f, h] ->
      w_in [E, h, 2f] (the GLU halves of ``pack_glu_ffn``); per expert
      ``w2`` [h, f] -> w_out [E, f, h];
    * 5.x, ``mlp.``: ``gate.weight`` as above; ``experts.gate_up_proj``
      [E, 2f, h] (gate rows, then up rows) -> w_in, each expert's matrix
      transposed; ``experts.down_proj`` [E, h, f] -> w_out, likewise.

    The capacity factor recorded is E / top_k, at which every expert can
    hold a whole row: the converted model is dropless, as HF's is.
    """
    hf_cfg = hf_model.config
    E = hf_cfg.num_local_experts

    def moe_mlp(sd, p):
        if p + "mlp.experts.gate_up_proj" in sd:
            moe = p + "mlp."
            w_in = _np_transposed(sd[moe + "experts.gate_up_proj"])
            w_out = _np_transposed(sd[moe + "experts.down_proj"])
        else:
            moe = p + "block_sparse_moe."
            w_in = np.stack([
                pack_glu_ffn(_np(sd[f"{moe}experts.{e}.w1.weight"]),
                             _np(sd[f"{moe}experts.{e}.w3.weight"]))
                for e in range(E)])
            w_out = np.stack([_np(sd[f"{moe}experts.{e}.w2.weight"]).T
                              for e in range(E)])
        return {
            "router": {"kernel": np.ascontiguousarray(
                _np(sd[moe + "gate.weight"]).T)},
            "experts": {"w_in": np.ascontiguousarray(w_in),
                        "w_out": np.ascontiguousarray(w_out)},
        }

    params, config = convert_llama_family(hf_model, dtype, layer_mlp=moe_mlp)
    top_k = hf_cfg.num_experts_per_tok
    config.update({
        "num_experts": E,
        "moe_top_k": top_k,
        # HF routes every token (dropless); E / top_k gives each expert
        # room for a whole row, so converted models reproduce HF's logits.
        # Training may lower it (1.25 is the default for MoE from scratch)
        "moe_capacity_factor": float(E) / top_k,
    })
    return params, config


def falcon_kv_heads(hf_cfg) -> int:
    """KV heads of an HF Falcon config, by HF's own rule
    (``FalconAttention``): ``num_kv_heads`` for the new decoder
    architecture or a model without ``multi_query``, else one."""
    nh = hf_cfg.num_attention_heads
    if getattr(hf_cfg, "new_decoder_architecture", False) or \
            not getattr(hf_cfg, "multi_query", False):
        return getattr(hf_cfg, "num_kv_heads", None) or nh
    return 1


def convert_falcon(hf_model, dtype=torch.float32):
    """FalconForCausalLM -> param tree (reference: hf_to_megatron.py:60-116).

    Falcon HF already packs QKV in grouped layout
    [ng*(qpg+2)*d, hidden]; only the rotary permutation (per (q|k) head
    inside each group) is needed."""
    hf_cfg = hf_model.config
    nh = hf_cfg.num_attention_heads
    ng = falcon_kv_heads(hf_cfg)
    d = hf_cfg.hidden_size // nh
    qpg = nh // ng
    sd = dict(hf_model.state_dict())

    layers = []
    for i in range(hf_cfg.num_hidden_layers):
        p = f"transformer.h.{i}."
        qkv = _np(sd[p + "self_attention.query_key_value.weight"])
        # per-(q|k) head rotary permutation, leave v rows alone
        w = qkv.reshape(ng, qpg + 2, d, -1)
        hid = w.shape[-1]
        for g in range(ng):
            for h in range(qpg + 1):   # q heads + k
                w[g, h] = rotary_hf_to_interleaved(
                    w[g, h].reshape(d, hid), d
                ).reshape(d, hid)
        qkv = w.reshape(ng * (qpg + 2) * d, hid)

        entry = {
            "attention": {
                "query_key_value": {
                    "kernel": np.ascontiguousarray(qkv.T)},
                "dense": {"kernel": np.ascontiguousarray(
                    _np(sd[p + "self_attention.dense.weight"]).T)},
            },
            "mlp": {
                "dense_h_to_4h": {"kernel": np.ascontiguousarray(
                    _np(sd[p + "mlp.dense_h_to_4h.weight"]).T)},
                "dense_4h_to_h": {"kernel": np.ascontiguousarray(
                    _np(sd[p + "mlp.dense_4h_to_h.weight"]).T)},
            },
        }
        if getattr(hf_cfg, "new_decoder_architecture", False):
            entry["input_norm"] = {
                "scale": _np(sd[p + "ln_attn.weight"]),
                "bias": _np(sd[p + "ln_attn.bias"]),
            }
            entry["mlp_norm"] = {
                "scale": _np(sd[p + "ln_mlp.weight"]),
                "bias": _np(sd[p + "ln_mlp.bias"]),
            }
        else:
            entry["input_norm"] = {
                "scale": _np(sd[p + "input_layernorm.weight"]),
                "bias": _np(sd[p + "input_layernorm.bias"]),
            }
        layers.append(entry)

    params = {
        "embedding": {"word": {"embedding": _tensor(
            _np(sd["transformer.word_embeddings.weight"]), dtype)}},
        "transformer": {
            "layers": stack_layer_tree(layers, dtype),
            "final_norm": {
                "scale": _tensor(_np(sd["transformer.ln_f.weight"]), dtype),
                "bias": _tensor(_np(sd["transformer.ln_f.bias"]), dtype),
            },
        },
    }
    config = {
        "num_layers": hf_cfg.num_hidden_layers,
        "hidden_size": hf_cfg.hidden_size,
        "num_attention_heads": nh,
        "num_attention_heads_kv": ng,
        "ffn_hidden_size": 4 * hf_cfg.hidden_size,
        "padded_vocab_size": hf_cfg.vocab_size,
        "position_embedding_type": "rotary",
        "normalization": "layernorm",
        "parallel_attn": True,
        "parallel_layernorm": bool(
            getattr(hf_cfg, "new_decoder_architecture", False)),
        "gelu_variant": "exact",
        "add_bias_linear": False,
        "tie_embed_logits": True,
        "hidden_dropout": 0.0,
        "attention_dropout": 0.0,
    }
    return params, config


CONVERTERS = {
    "llama": convert_llama_family,
    "llama2": convert_llama_family,
    "llama3": convert_llama_family,
    "codellama": convert_llama_family,
    "mistral": convert_llama_family,
    "mixtral": convert_mixtral,
    "qwen2": convert_qwen2,
    "gemma": convert_gemma,
    "gpt_neox": convert_gpt_neox,
    "pythia": convert_gpt_neox,
    "falcon": convert_falcon,
}


class MetaLlamaShim:
    """Duck-types the (config, state_dict) surface the converters read, fed
    from merged Meta shards (reference: hf_to_megatron downloads/merges Meta
    weights via utils/merge_llama.py before converting)."""

    # Meta params.json has no max_seq_len (it's a runtime arg in Meta's
    # code); trained context depends on the release
    MODEL_CONTEXT = {"llama": 2048, "llama2": 4096, "codellama": 16384}

    def __init__(self, model_dir: str, model: str = "llama2"):
        import json
        import os
        from types import SimpleNamespace

        from megatron_llm_torch.weights_conversion.merge_llama import (
            merge_llama,
            meta_to_hf_names,
        )

        with open(os.path.join(model_dir, "params.json")) as f:
            meta_cfg = json.load(f)
        n_heads = meta_cfg["n_heads"]
        n_kv = meta_cfg.get("n_kv_heads", n_heads)
        merged = merge_llama(model_dir)
        sd = meta_to_hf_names(merged, n_heads, n_kv)
        self._sd = {k: torch.from_numpy(v) for k, v in sd.items()}
        hidden = meta_cfg["dim"]
        vocab = sd["model.embed_tokens.weight"].shape[0]
        ffn = sd["model.layers.0.mlp.gate_proj.weight"].shape[0]
        self.config = SimpleNamespace(
            num_attention_heads=n_heads,
            num_key_value_heads=n_kv,
            num_hidden_layers=meta_cfg["n_layers"],
            hidden_size=hidden,
            intermediate_size=ffn,
            vocab_size=vocab,
            rms_norm_eps=meta_cfg.get("norm_eps", 1e-5),
            max_position_embeddings=meta_cfg.get(
                "max_seq_len", self.MODEL_CONTEXT.get(model, 4096)),
            rope_theta=meta_cfg.get("rope_theta", 10000.0),
        )

    def state_dict(self):
        return self._sd


def load_hf_model(path: str):
    """``AutoModelForCausalLM.from_pretrained`` in fp32 on the CPU."""
    from transformers import AutoModelForCausalLM

    # transformers 4.56+ takes dtype= (5.x dropped torch_dtype=)
    return AutoModelForCausalLM.from_pretrained(
        path, dtype=torch.float32, trust_remote_code=False)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("model", choices=sorted(CONVERTERS))
    p.add_argument("--model-path", "--model_path", dest="model_path",
                   required=True,
                   help="HF local path, or a Meta llama release dir "
                        "(consolidated.*.pth + params.json) with "
                        "--meta_weights")
    p.add_argument("--meta_weights", action="store_true",
                   help="treat --model_path as Meta-format llama shards")
    p.add_argument("--out", required=True)
    p.add_argument("--dtype", default="fp32", choices=sorted(DTYPES))
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    from megatron_llm_torch import checkpointing

    args = build_parser().parse_args(argv)
    t0 = time.perf_counter()
    if args.meta_weights:
        assert args.model in ("llama", "llama2", "codellama"), \
            "--meta_weights only applies to the llama family"
        hf = MetaLlamaShim(args.model_path, args.model)
    else:
        hf = load_hf_model(args.model_path)
    t1 = time.perf_counter()
    params, config = CONVERTERS[args.model](hf, DTYPES[args.dtype])
    del hf
    config["model_name"] = args.model
    t2 = time.perf_counter()
    checkpointing.save_checkpoint(
        args.out, 0, params, args=config, release=True
    )
    print(f" converted {args.model_path} -> {args.out} (release "
          f"checkpoint, {args.dtype}): read {t1 - t0:.2f} s, convert "
          f"{t2 - t1:.2f} s, write {time.perf_counter() - t2:.2f} s",
          flush=True)


if __name__ == "__main__":
    main()
