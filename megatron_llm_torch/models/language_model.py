"""Embedding + transformer + LM head (the counterpart of
``megatron_llm_tpu/models/language_model.py``, with its param tree)."""

from __future__ import annotations

from typing import Optional

import torch

from megatron_llm_torch.config import PositionEmbeddingType, TransformerConfig
from megatron_llm_torch.models.transformer import (
    init_stack_params,
    rotary_freqs,
    transformer_stack,
)
from megatron_llm_torch.parallel.layers import (
    init_embedding_params,
    init_method_for,
    parallel_lm_logits,
    vocab_parallel_embedding,
)


def init_language_model_params(generator: torch.Generator,
                               cfg: TransformerConfig, dtype=None,
                               device=None):
    """Param tree::

        {'embedding': {'word': {'embedding': [V, H]}},
         'transformer': {'layers': {... stacked [L, ...]},
                         'final_norm': {...}},
         'lm_head': {'weight': [V, H]}}   (when not tie_embed_logits)

    drawn from ``generator`` on ``device``.
    """
    dtype = dtype or cfg.params_torch_dtype
    init = init_method_for(cfg)
    params = {
        "embedding": {"word": init_embedding_params(
            generator, cfg.padded_vocab_size, cfg.hidden_size,
            init_method=init, dtype=dtype, device=device)},
        "transformer": init_stack_params(generator, cfg, dtype, device),
    }
    if not cfg.tie_embed_logits:
        params["lm_head"] = {"weight": init(
            generator, (cfg.padded_vocab_size, cfg.hidden_size), dtype,
            device)}
    return params


def embedding_forward(tokens: torch.Tensor, position_ids, params,
                      cfg: TransformerConfig) -> torch.Tensor:
    """Word embedding (rotary models add no position embedding)."""
    h = vocab_parallel_embedding(tokens, params["word"],
                                 compute_dtype=cfg.compute_torch_dtype)
    if cfg.embedding_multiplier is not None:
        h = h * cfg.embedding_multiplier
    return h


def lm_head_weight(params) -> torch.Tensor:
    """[V, H] logits weight: the untied head, else the word embedding."""
    if "lm_head" in params:
        return params["lm_head"]["weight"]
    return params["embedding"]["word"]["embedding"]


@torch.no_grad()
def language_model_forward(params, tokens: torch.Tensor,
                           position_ids: Optional[torch.Tensor],
                           attention_mask: Optional[torch.Tensor],
                           cfg: TransformerConfig, *,
                           compute_logits: bool = True, kv_caches=None,
                           freqs=None):
    """Full LM forward -> logits [b, s, V] (or the final hidden states
    when ``compute_logits=False``); with ``kv_caches`` returns
    ``(out, new_caches)``."""
    h = embedding_forward(tokens, position_ids, params["embedding"], cfg)
    if freqs is None:
        freqs = rotary_freqs(cfg, device=h.device)
    out = transformer_stack(h, params["transformer"], cfg, freqs=freqs,
                            attention_mask=attention_mask,
                            position_ids=position_ids, kv_caches=kv_caches)
    h, new_caches = out if kv_caches is not None else (out, None)
    if compute_logits:
        h = parallel_lm_logits(h, lm_head_weight(params),
                               compute_dtype=cfg.compute_torch_dtype)
    if kv_caches is not None:
        return h, new_caches
    return h


def unsupported_features(cfg: TransformerConfig) -> list:
    """Names of the config features this slice has not ported."""
    out = []
    if cfg.position_embedding_type != PositionEmbeddingType.rotary:
        out.append("learned absolute position embeddings")
    if cfg.normalization != "rmsnorm":
        out.append(f"{cfg.normalization} normalization")
    if cfg.parallel_attn or cfg.parallel_layernorm:
        out.append("parallel attention")
    if cfg.use_post_ln:
        out.append("post-LN")
    if cfg.num_experts > 1:
        out.append("mixture of experts")
    if cfg.num_tokentypes > 0:
        out.append("tokentype embeddings")
    return out
