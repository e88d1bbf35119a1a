"""Carry params between the JAX package and the port.

Both packages use one param tree: ``embedding.word.embedding`` [V, H],
``transformer.layers`` with a leading ``[num_layers]`` axis on every leaf
(``input_norm``, ``attention.query_key_value`` / ``attention.dense``,
``mlp.dense_h_to_4h`` / ``mlp.dense_4h_to_h``, or for a mixture of
experts ``mlp.router.kernel`` [H, E] with ``mlp.experts.w_in`` [E, H,
(2x)F] and ``mlp.experts.w_out`` [E, F, H], ``post_attention_norm``
unless attention and MLP run in parallel, ``mlp_norm`` under
``parallel_layernorm``), ``transformer.final_norm``,
``embedding.position.embedding`` when positions are learned, and
``lm_head.weight`` when the head is untied; linear kernels are
``[in, out]`` and LayerNorm leaves carry a ``bias``.  So the conversion
is a leaf-wise copy of numpy arrays (``jax.device_get`` of the JAX tree
gives them) into tensors, with the tree's shape checked against the
config.  The encoder models' trees carry the same way: BERT adds
``embedding.tokentype``, ``lm_head`` {dense, layernorm, bias},
``pooler`` and ``binary_head`` (or a ``classification_head``); T5 has
``encoder`` and ``decoder`` stacks (the decoder's layers add
``inter_attention`` {query, key_value, dense} and
``post_inter_attention_norm``) and ``lm_head.bias``; the biencoder holds
a language model tree under ``query`` and ``context`` (or ``shared``),
each with an optional ``projection``.  ``params_to_numpy`` is the
inverse, for comparing the two packages' params after training steps.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from megatron_llm_torch.config import PositionEmbeddingType, TransformerConfig


def _layer_norm_keys(cfg: TransformerConfig) -> tuple:
    """The norms a layer of this config holds (the JAX package's
    ``init_layer_params``)."""
    keys = ["input_norm"]
    if not cfg.parallel_attn:
        keys.append("post_attention_norm")
    if cfg.parallel_layernorm:
        keys.append("mlp_norm")
    return tuple(keys)


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
    if isinstance(node, torch.Tensor):
        return node.to(device=device, dtype=dtype or node.dtype)
    return _to_tensor(node, dtype, device)


def params_from_jax(tree: Dict[str, Any], cfg: TransformerConfig,
                    dtype: Optional[torch.dtype] = None,
                    device="cuda", tp_rank: int = 0,
                    tp_size: int = 1) -> Dict[str, Any]:
    """The JAX package's param tree (numpy leaves) -> the port's (tensor
    leaves on ``device``, cast to ``dtype`` when given).  The tree is one
    of the JAX package's models': a language model (GPT families, and
    BERT with ``lm_head`` {dense, layernorm, bias}, ``pooler`` and
    ``binary_head``, or the classification head), T5 (``encoder``,
    ``decoder`` with ``inter_attention``, ``lm_head.bias``) or the
    biencoder ({query, context} or {shared} towers, each with an optional
    ``projection``); its shapes are checked against the config.  With
    ``tp_size`` above 1 (a language model's tree) the result is rank
    ``tp_rank``'s slices (``parallel/sharding.py``), cut on the host
    before they move to ``device``."""
    if "encoder" in tree:
        _check_t5(tree, cfg)
    elif set(tree) & {"query", "context", "shared"}:
        if set(tree) not in ({"query"}, {"context"}, {"query", "context"},
                             {"shared"}):
            raise KeyError(f"biencoder tree has {sorted(tree)}: the "
                           f"towers are query and/or context, or shared")
        for name, tower in tree.items():
            _check_language_model(
                {k: v for k, v in tower.items() if k != "projection"}, cfg,
                name)
            if "projection" in tower:
                _check_linear(tower["projection"], f"{name}.projection",
                              cfg.hidden_size, None)
    else:
        _check_language_model(tree, cfg)
        if tp_size > 1:
            from megatron_llm_torch.parallel.sharding import (
                language_model_param_specs,
                shard_params,
            )

            host = _convert(tree, None, "cpu")
            local = shard_params(host, language_model_param_specs(host),
                                 tp_rank, tp_size, cfg)
            return _convert(local, dtype, device)
    if tp_size > 1:
        raise NotImplementedError(
            "only a language model's tree loads at tp > 1 (BERT, T5 and "
            "the biencoder at tp are ROADMAP item 15)")
    return _convert(tree, dtype, device)


def _check_linear(node, name: str, din: int, dout: Optional[int]) -> None:
    if set(node) != {"kernel", "bias"}:
        raise KeyError(f"{name} has {sorted(node)}, needs kernel and bias")
    k = np.shape(node["kernel"])
    if k[0] != din or (dout is not None and k[1] != dout):
        raise ValueError(f"{name}.kernel {k} does not match the config's "
                         f"({din}, {dout if dout is not None else '*'})")


def _check_norms(nodes: Dict[str, Any], cfg: TransformerConfig) -> None:
    want = {"scale", "bias"} if cfg.normalization == "layernorm" \
        else {"scale"}
    for name, node in nodes.items():
        if set(node) != want:
            raise KeyError(f"{name} has {sorted(node)}, "
                           f"{cfg.normalization} needs {sorted(want)}")


def _check_stack(stack: Dict[str, Any], cfg: TransformerConfig, name: str,
                 decoder: bool = False) -> None:
    """A stacked transformer (``layers`` with a leading [L] axis and
    ``final_norm``); a decoder's layers add ``inter_attention`` and
    ``post_inter_attention_norm``."""
    layers = stack["layers"]
    norm_keys = _layer_norm_keys(cfg)
    if decoder:
        norm_keys += ("post_inter_attention_norm",)
    want_keys = set(norm_keys) | {"attention", "mlp"}
    if decoder:
        want_keys.add("inter_attention")
    if set(layers) != want_keys:
        raise KeyError(
            f"{name}.layers has {sorted(layers)}, the config "
            f"(parallel_attn={cfg.parallel_attn}, parallel_layernorm="
            f"{cfg.parallel_layernorm}{', decoder' if decoder else ''}) "
            f"needs {sorted(want_keys)}")
    norms = {f"{name}.layers.{k}": layers[k] for k in norm_keys}
    norms[f"{name}.final_norm"] = stack["final_norm"]
    _check_norms(norms, cfg)
    L = cfg.num_layers
    qkv = np.asarray(layers["attention"]["query_key_value"]["kernel"])
    want = (L, cfg.hidden_size,
            cfg.num_query_groups
            * (cfg.num_attention_heads // cfg.num_query_groups + 2)
            * cfg.head_dim)
    if qkv.shape != want:
        raise ValueError(f"query_key_value kernel {qkv.shape} does not "
                         f"match the config's {want}")
    if decoder:
        ia = layers["inter_attention"]
        nh_d = cfg.num_attention_heads * cfg.head_dim
        for leaf, shape in (("query", (L, cfg.hidden_size, nh_d)),
                            ("key_value", (L, cfg.hidden_size, 2 * nh_d)),
                            ("dense", (L, nh_d, cfg.hidden_size))):
            got = tuple(np.shape(ia[leaf]["kernel"]))
            if got != shape:
                raise ValueError(f"{name}.layers.inter_attention.{leaf} "
                                 f"{got} does not match the config's "
                                 f"{shape}")
    _check_mlp(layers["mlp"], cfg)


def _check_embedding(emb: Dict[str, Any], cfg: TransformerConfig,
                     learned: bool) -> None:
    if learned != ("position" in emb):
        raise KeyError(
            f"position_embedding_type={cfg.position_embedding_type.value} "
            f"but the tree has {sorted(emb)} embeddings")
    if learned:
        pos = np.asarray(emb["position"]["embedding"])
        want_pos = (cfg.max_position_embeddings, cfg.hidden_size)
        if pos.shape != want_pos:
            raise ValueError(f"position embedding {pos.shape} does not "
                             f"match the config's {want_pos}")
    if (cfg.num_tokentypes > 0) != ("tokentype" in emb):
        raise KeyError(f"num_tokentypes={cfg.num_tokentypes} but the tree "
                       f"has {sorted(emb)} embeddings")
    if cfg.num_tokentypes > 0:
        tt = np.shape(emb["tokentype"]["embedding"])
        if tt != (cfg.num_tokentypes, cfg.hidden_size):
            raise ValueError(f"tokentype embedding {tt} does not match the "
                             f"config's ({cfg.num_tokentypes}, "
                             f"{cfg.hidden_size})")


def _check_language_model(tree: Dict[str, Any], cfg: TransformerConfig,
                          name: str = "") -> None:
    """A language model's tree, with BERT's and the classifier's heads
    where it has them."""
    where = f"{name} " if name else ""
    missing = [k for k in ("embedding", "transformer") if k not in tree]
    if missing:
        raise KeyError(f"{where}param tree lacks {missing}")
    _check_stack(tree["transformer"], cfg, "transformer")
    _check_embedding(tree["embedding"], cfg,
                     cfg.position_embedding_type
                     == PositionEmbeddingType.learned_absolute)
    head = tree.get("lm_head")
    if head is not None and "dense" in head:
        # BERT's MLM transform and its logits bias (the head is tied)
        if set(head) != {"dense", "layernorm", "bias"}:
            raise KeyError(f"lm_head has {sorted(head)}, BERT's needs "
                           f"bias, dense and layernorm")
        _check_linear(head["dense"], "lm_head.dense", cfg.hidden_size,
                      cfg.hidden_size)
        if np.shape(head["bias"]) != (cfg.padded_vocab_size,):
            raise ValueError(f"lm_head.bias {np.shape(head['bias'])} does "
                             f"not match the vocabulary "
                             f"({cfg.padded_vocab_size},)")
    elif not cfg.tie_embed_logits and head is None:
        raise KeyError("untied config but the tree has no lm_head")
    if ("pooler" in tree) != ("binary_head" in tree
                              or "classification_head" in tree):
        raise KeyError(f"pooler and the binary or classification head go "
                       f"together; the tree has {sorted(tree)}")
    for key, dout in (("pooler", cfg.hidden_size), ("binary_head", 2),
                      ("classification_head", None)):
        if key in tree:
            _check_linear(tree[key], key, cfg.hidden_size, dout)


def _check_t5(tree: Dict[str, Any], cfg: TransformerConfig) -> None:
    want = {"embedding", "encoder", "decoder", "lm_head"}
    if set(tree) != want:
        raise KeyError(f"T5 tree has {sorted(tree)}, needs {sorted(want)}")
    _check_embedding(tree["embedding"], cfg, True)
    _check_stack(tree["encoder"], cfg, "encoder")
    _check_stack(tree["decoder"], cfg, "decoder", decoder=True)
    if np.shape(tree["lm_head"].get("bias")) != (cfg.padded_vocab_size,):
        raise ValueError("T5 lm_head.bias does not match the vocabulary "
                         f"({cfg.padded_vocab_size},)")


def _check_mlp(mlp: Dict[str, Any], cfg: TransformerConfig) -> None:
    """The stacked MLP subtree holds the dense MLP's leaves, or the
    mixture of experts' at the config's shapes."""
    L, H, Fd = cfg.num_layers, cfg.hidden_size, cfg.ffn_hidden_size
    mult = 2 if cfg.glu_activation else 1
    if cfg.num_experts > 1:
        E = cfg.num_experts
        want = {("router", "kernel"): (L, H, E),
                ("experts", "w_in"): (L, E, H, mult * Fd),
                ("experts", "w_out"): (L, E, Fd, H)}
    else:
        want = {("dense_h_to_4h", "kernel"): (L, H, mult * Fd),
                ("dense_4h_to_h", "kernel"): (L, Fd, H)}
    groups = {path[0] for path in want}
    if set(mlp) != groups:
        raise KeyError(f"transformer.layers.mlp has {sorted(mlp)}, the "
                       f"config (num_experts={cfg.num_experts}) needs "
                       f"{sorted(groups)}")
    for (group, leaf), shape in want.items():
        got = tuple(np.shape(mlp[group].get(leaf)))
        if got != shape:
            raise ValueError(f"mlp.{group}.{leaf} {got} does not match "
                             f"the config's {shape}")


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
