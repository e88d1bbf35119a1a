"""Merge Meta-distributed Llama shards (consolidated.XX.pth) into one
unsharded state dict.

Reference: ``weights_conversion/utils/merge_llama.py`` — Meta ships TP-style
shards; each parameter concatenates along a per-key axis (column-parallel
weights along 0, row-parallel along -1, norms replicated).  The merged dict
feeds ``hf_to_megatron.py`` (or is exported to HF format first).

Tensors are loaded with ``torch.load(map_location='cpu')`` and merged in
numpy (a copy of the repo's ``weights_conversion/merge_llama.py`` with
its imports changed).
"""

from __future__ import annotations

import glob
import os
from typing import Dict

import numpy as np

# which axis each Meta parameter concatenates along across shards
# (None = replicated, take shard 0)
MERGE_DIM = {
    "wq": 0, "wk": 0, "wv": 0, "wo": -1,
    "w1": 0, "w2": -1, "w3": 0,
    "output": 0,
    "tok_embeddings": -1,
    "attention_norm": None, "ffn_norm": None, "norm": None,
    "rope": None,
}


def _short_name(param_name: str) -> str:
    # e.g. layers.3.attention.wq.weight -> wq
    parts = param_name.split(".")
    return parts[-2] if len(parts) >= 2 else parts[0]


def merge_llama(model_dir: str, dtype=np.float32) -> Dict[str, np.ndarray]:
    """Returns {meta param name: merged array} from consolidated.*.pth."""
    import torch

    shards = sorted(glob.glob(os.path.join(model_dir, "consolidated.*.pth")))
    if not shards:
        raise FileNotFoundError(
            f"no consolidated.*.pth shards under {model_dir!r}")
    merged: Dict[str, list] = {}
    for path in shards:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        for name, tensor in sd.items():
            arr = tensor.to(torch.float32).numpy().astype(dtype)
            merged.setdefault(name, []).append(arr)
        del sd
    out = {}
    for name in list(merged):
        parts = merged.pop(name)  # free shard parts as we go (70B ~ 280GB)
        dim = MERGE_DIM.get(_short_name(name))
        if dim is None or name.endswith("inv_freq") or len(parts) == 1:
            out[name] = parts[0]
        else:
            out[name] = np.concatenate(parts, axis=dim)
    return out


def meta_to_hf_names(merged: Dict[str, np.ndarray],
                     n_heads: int, n_kv_heads: int) -> Dict[str, np.ndarray]:
    """Rename Meta keys to the HF LlamaForCausalLM convention — AND convert
    wq/wk from Meta's interleaved rotary layout to HF's half-split layout —
    so the merged dict can flow through hf_to_megatron's llama converter
    (which applies rotary_hf_to_interleaved assuming HF-layout input)."""
    from megatron_llm_torch.weights_conversion.util import (
        rotary_interleaved_to_hf,
    )

    out = {}
    mapping = {
        "tok_embeddings.weight": "model.embed_tokens.weight",
        "norm.weight": "model.norm.weight",
        "output.weight": "lm_head.weight",
    }
    per_layer = {
        "attention.wq.weight": "self_attn.q_proj.weight",
        "attention.wk.weight": "self_attn.k_proj.weight",
        "attention.wv.weight": "self_attn.v_proj.weight",
        "attention.wo.weight": "self_attn.o_proj.weight",
        "feed_forward.w1.weight": "mlp.gate_proj.weight",
        "feed_forward.w2.weight": "mlp.down_proj.weight",
        "feed_forward.w3.weight": "mlp.up_proj.weight",
        "attention_norm.weight": "input_layernorm.weight",
        "ffn_norm.weight": "post_attention_layernorm.weight",
    }
    for name, arr in merged.items():
        if name.endswith("rope.freqs") or name.endswith("inv_freq"):
            continue
        if name in mapping:
            out[mapping[name]] = arr
            continue
        if name.startswith("layers."):
            _, idx, rest = name.split(".", 2)
            if rest in per_layer:
                if rest.endswith(("wq.weight", "wk.weight")):
                    nh = n_heads if "wq" in rest else n_kv_heads
                    head_dim = arr.shape[0] // nh
                    arr = rotary_interleaved_to_hf(arr, head_dim)
                out[f"model.layers.{idx}.{per_layer[rest]}"] = arr
                continue
        raise KeyError(f"unrecognized Meta parameter {name!r}")
    return out
