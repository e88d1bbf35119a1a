"""Embedding + transformer + LM head (the counterpart of
``megatron_llm_tpu/models/language_model.py``, with its param tree), and
the model's FLOP count per token for MFU accounting."""

from __future__ import annotations

from typing import Optional

import torch

from megatron_llm_torch import random as mrandom
from megatron_llm_torch.config import PositionEmbeddingType, TransformerConfig
from megatron_llm_torch.models.transformer import (
    _dropout,
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

        {'embedding': {'word': {'embedding': [V, H]},
                       'position': {'embedding': [P, H]}},  (when learned)
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
    if cfg.position_embedding_type == PositionEmbeddingType.learned_absolute:
        params["embedding"]["position"] = init_embedding_params(
            generator, cfg.max_position_embeddings, cfg.hidden_size,
            init_method=init, dtype=dtype, device=device)
    if not cfg.tie_embed_logits:
        params["lm_head"] = {"weight": init(
            generator, (cfg.padded_vocab_size, cfg.hidden_size), dtype,
            device)}
    return params


def embedding_forward(tokens: torch.Tensor, position_ids, params,
                      cfg: TransformerConfig, *,
                      rng_key: Optional[int] = None,
                      train: bool = False) -> torch.Tensor:
    """Word embedding, scaled by ``embedding_multiplier`` when set (the
    tied head reads the raw table), plus the learned absolute position
    embedding when the params carry one (rotary models do not), then the
    hidden dropout in training with a key."""
    h = vocab_parallel_embedding(tokens, params["word"],
                                 compute_dtype=cfg.compute_torch_dtype)
    if cfg.embedding_multiplier is not None:
        # the multiplier is rounded to h's dtype first, as the JAX package
        # rounds it: a Python float would multiply in fp32
        h = h * torch.tensor(cfg.embedding_multiplier, dtype=h.dtype,
                             device=h.device)
    if "position" in params:
        if position_ids is None:
            position_ids = torch.arange(tokens.shape[1],
                                        device=tokens.device)[None, :]
        h = h + vocab_parallel_embedding(
            position_ids, params["position"],
            compute_dtype=cfg.compute_torch_dtype)
    return _dropout(h, cfg.hidden_dropout, rng_key, train)


def lm_head_weight(params) -> torch.Tensor:
    """[V, H] logits weight: the untied head, else the word embedding."""
    if "lm_head" in params:
        return params["lm_head"]["weight"]
    return params["embedding"]["word"]["embedding"]


def language_model_forward(params, tokens: torch.Tensor,
                           position_ids: Optional[torch.Tensor],
                           attention_mask: Optional[torch.Tensor],
                           cfg: TransformerConfig, *,
                           rng_key: Optional[int] = None,
                           train: bool = False,
                           compute_logits: bool = True, kv_caches=None,
                           freqs=None):
    """Full LM forward -> logits [b, s, V] (or the final hidden states
    when ``compute_logits=False``); with ``kv_caches`` returns
    ``(out, new_caches)``.  ``rng_key`` (an integer key,
    ``megatron_llm_torch/random.py``) is split into the embedding's and
    the stack's dropout keys.  Differentiable; inference callers run it
    under ``torch.no_grad()``."""
    train = train and kv_caches is None
    k_embed, k_stack = (mrandom.split(rng_key) if rng_key is not None
                        else (None, None))
    h = embedding_forward(tokens, position_ids, params["embedding"], cfg,
                          rng_key=k_embed, train=train)
    if freqs is None:
        freqs = rotary_freqs(cfg, device=h.device)
    out = transformer_stack(h, params["transformer"], cfg, freqs=freqs,
                            attention_mask=attention_mask,
                            position_ids=position_ids, kv_caches=kv_caches,
                            rng_key=k_stack, train=train)
    h, new_caches = out if kv_caches is not None else (out, None)
    if compute_logits:
        h = parallel_lm_logits(h, lm_head_weight(params),
                               compute_dtype=cfg.compute_torch_dtype)
    if kv_caches is not None:
        return h, new_caches
    return h


def flops_per_token(cfg: TransformerConfig,
                    seq_len: Optional[int] = None) -> float:
    """Per-token forward+backward FLOPs for MFU accounting: the 6ND
    approximation plus the attention term (the JAX package's estimate)."""
    s = seq_len or cfg.seq_length
    h = cfg.hidden_size
    L = cfg.num_layers
    ffn = cfg.ffn_hidden_size
    ng = cfg.num_query_groups
    nh = cfg.num_attention_heads
    d = cfg.head_dim
    mult = 2 if cfg.glu_activation else 1
    qkv = h * (nh + 2 * ng) * d
    proj = nh * d * h
    mlp_p = h * ffn * mult + ffn * h      # dense MLP (MoE is not ported)
    dense = L * (qkv + proj + mlp_p)
    emb = cfg.padded_vocab_size * h
    # fwd = 2 flops/param/token, bwd = 4, attention = 2*2*s*nh*d per layer
    attn = L * 2 * 2 * s * nh * d
    return 6.0 * (dense + emb) + 3.0 * attn


def unsupported_features(cfg: TransformerConfig) -> list:
    """Names of the config features this slice has not ported."""
    out = []
    if cfg.num_experts > 1:
        out.append("mixture of experts")
    if cfg.num_tokentypes > 0:
        out.append("tokentype embeddings")
    return out
