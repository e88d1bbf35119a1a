"""Carry params between the JAX package and the port.

Both packages use one param tree: ``embedding.word.embedding`` [V, H],
``transformer.layers`` with a leading ``[num_layers]`` axis on every leaf
(``input_norm``, ``attention.query_key_value`` / ``attention.dense``,
``mlp.dense_h_to_4h`` / ``mlp.dense_4h_to_h``, ``post_attention_norm``),
``transformer.final_norm`` and ``lm_head.weight``; linear kernels are
``[in, out]``.  So the conversion is a leaf-wise copy of numpy arrays
(``jax.device_get`` of the JAX tree gives them) into tensors, with the
tree's shape checked against the config.  ``params_to_numpy`` is the
inverse, for comparing the two packages' params after training steps.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from megatron_llm_torch.config import TransformerConfig

_LAYER_KEYS = ("input_norm", "attention", "mlp", "post_attention_norm")


def _to_tensor(arr: Any, dtype: Optional[torch.dtype], device) -> torch.Tensor:
    a = np.ascontiguousarray(arr)
    if not a.flags.writeable:       # arrays exported by jax are read-only
        a = a.copy()
    if a.dtype.name == "bfloat16":
        # numpy has no native bf16: reinterpret the 16-bit payload
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def _convert(node, dtype, device):
    if isinstance(node, dict):
        return {k: _convert(v, dtype, device) for k, v in node.items()}
    return _to_tensor(node, dtype, device)


def params_from_jax(tree: Dict[str, Any], cfg: TransformerConfig,
                    dtype: Optional[torch.dtype] = None,
                    device="cuda") -> Dict[str, Any]:
    """The JAX package's param tree (numpy leaves) -> the port's (tensor
    leaves on ``device``, cast to ``dtype`` when given)."""
    missing = [k for k in ("embedding", "transformer") if k not in tree]
    if missing:
        raise KeyError(f"param tree lacks {missing}")
    layers = tree["transformer"]["layers"]
    absent = [k for k in _LAYER_KEYS if k not in layers]
    if absent:
        raise KeyError(f"transformer.layers lacks {absent}")
    L = cfg.num_layers
    qkv = np.asarray(layers["attention"]["query_key_value"]["kernel"])
    want = (L, cfg.hidden_size,
            cfg.num_query_groups
            * (cfg.num_attention_heads // cfg.num_query_groups + 2)
            * cfg.head_dim)
    if qkv.shape != want:
        raise ValueError(f"query_key_value kernel {qkv.shape} does not "
                         f"match the config's {want}")
    if not cfg.tie_embed_logits and "lm_head" not in tree:
        raise KeyError("untied config but the tree has no lm_head")
    return _convert(tree, dtype, device)


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The port's param tree (or any tree of tensors, such as optimizer
    moments) -> numpy leaves on the host.  bf16 leaves widen to float32
    exactly (numpy has no bf16); other dtypes are kept."""
    def conv(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return {k: params_to_numpy(v) if isinstance(v, dict) else conv(v)
            for k, v in tree.items()}
