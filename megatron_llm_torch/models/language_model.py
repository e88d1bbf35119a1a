"""Embedding + transformer + LM head (the counterpart of
``megatron_llm_tpu/models/language_model.py``, with its param tree), and
the model's FLOP count per token for MFU accounting.

At tp > 1 a rank holds its slice of the tree (``parallel/sharding.py``'s
spec tables): the init draws every full leaf in the one-device order and
keeps this rank's slice, so that a seed gives the same model at every
tp; at pp > 1 it keeps the stage's rows of the layer stack.  The word embedding and the head are vocab-parallel, the logits stay
this rank's vocabulary shard, and under sequence parallelism the
embedding's output (and its dropout mask, and the position embedding's
rows) is this rank's sequence shard."""

from __future__ import annotations

from typing import Optional

import torch

from megatron_llm_torch import random as mrandom
from megatron_llm_torch import topology
from megatron_llm_torch.config import PositionEmbeddingType, TransformerConfig
from megatron_llm_torch.models.transformer import (
    _dropout,
    _sequence_local,
    init_stack_params,
    rotary_freqs,
    sequence_parallel_on,
    sequence_shard,
    transformer_stack,
)
from megatron_llm_torch.parallel.layers import (
    init_embedding_params,
    init_method_for,
    parallel_lm_logits,
    vocab_parallel_embedding,
)
from megatron_llm_torch.parallel.sharding import (
    _norm_spec,
    tp_sharder,
    transformer_layer_specs,
)


def make_generator(seed, device) -> torch.Generator:
    """``seed`` itself when it is a generator, else a generator on
    ``device`` seeded with it."""
    if isinstance(seed, torch.Generator):
        return seed
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def num_params(params) -> int:
    """Elements of a (nested dict) param tree."""
    total = 0
    stack = [params]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        else:
            total += node.numel()
    return total


def init_language_model_params(generator: torch.Generator,
                               cfg: TransformerConfig, dtype=None,
                               device=None, shard=None, rows=None):
    """Param tree::

        {'embedding': {'word': {'embedding': [V, H]},
                       'position': {'embedding': [P, H]},  (when learned)
                       'tokentype': {'embedding': [T, H]}},
                                        (when num_tokentypes > 0)
         'transformer': {'layers': {... stacked [L, ...]},
                         'final_norm': {...}},
         'lm_head': {'weight': [V, H]}}   (when not tie_embed_logits)

    drawn from ``generator`` on ``device``.  ``shard(subtree,
    spec_subtree)`` (``sharding.tp_sharder``), when given, keeps each
    leaf's tensor-parallel slice as soon as the full leaf is drawn (one
    layer at a time for the stack), so the peak is one full layer above
    the shards.  ``rows`` keeps a pipeline stage's layers of the stack
    (``init_stack_params``).
    """
    dtype = dtype or cfg.params_torch_dtype
    init = init_method_for(cfg)
    keep = shard or (lambda tree, specs: tree)
    params = {
        "embedding": {"word": keep(init_embedding_params(
            generator, cfg.padded_vocab_size, cfg.hidden_size,
            init_method=init, dtype=dtype, device=device),
            {"embedding": ("vocab", None)})},
        "transformer": init_stack_params(
            generator, cfg, dtype, device,
            shard_layer=None if shard is None else (
                lambda lp: shard(lp, transformer_layer_specs(
                    lp, stacked=False))), rows=rows),
    }
    if shard is not None:
        params["transformer"]["final_norm"] = keep(
            params["transformer"]["final_norm"],
            _norm_spec(params["transformer"]["final_norm"], False))
    if cfg.position_embedding_type == PositionEmbeddingType.learned_absolute:
        params["embedding"]["position"] = keep(init_embedding_params(
            generator, cfg.max_position_embeddings, cfg.hidden_size,
            init_method=init, dtype=dtype, device=device),
            {"embedding": (None, None)})
    if cfg.num_tokentypes > 0:
        # segment embeddings (BERT's sentence A / B)
        params["embedding"]["tokentype"] = keep(init_embedding_params(
            generator, cfg.num_tokentypes, cfg.hidden_size,
            init_method=init, dtype=dtype, device=device),
            {"embedding": (None, None)})
    if not cfg.tie_embed_logits:
        params["lm_head"] = keep({"weight": init(
            generator, (cfg.padded_vocab_size, cfg.hidden_size), dtype,
            device)}, {"weight": ("vocab", None)})
    return params


def init_params_at_tp(generator, cfg: TransformerConfig, dtype=None,
                      device=None):
    """``init_language_model_params`` for this rank: its slices at tp > 1
    (the one-device draws, each leaf cut as it comes) and at pp > 1 its
    stage's rows of the layer stack (``parallel/pipeline.py``), the
    whole tree on one device."""
    rows = None
    pp = topology.get_pipeline_model_parallel_world_size()
    if pp > 1:
        from megatron_llm_torch.parallel.pipeline import stage_layer_rows

        rows = stage_layer_rows(
            cfg.num_layers, pp,
            topology.get_virtual_pipeline_model_parallel_world_size(),
            topology.get_pipeline_model_parallel_rank())
    return init_language_model_params(generator, cfg, dtype, device,
                                      shard=tp_sharder(cfg), rows=rows)


def embedding_forward(tokens: torch.Tensor, position_ids, params,
                      cfg: TransformerConfig, *,
                      tokentype_ids: Optional[torch.Tensor] = None,
                      rng_key: Optional[int] = None,
                      train: bool = False) -> torch.Tensor:
    """Word embedding, scaled by ``embedding_multiplier`` when set (the
    tied head reads the raw table), plus the learned absolute position
    embedding when the params carry one (rotary models do not), plus the
    tokentype embedding of ``tokentype_ids`` when both are there, then
    the hidden dropout in training with a key."""
    sp = sequence_parallel_on(cfg)
    h = vocab_parallel_embedding(tokens, params["word"],
                                 compute_dtype=cfg.compute_torch_dtype,
                                 sequence_parallel=sp)
    if cfg.embedding_multiplier is not None:
        # the multiplier is rounded to h's dtype first, as the JAX package
        # rounds it: a Python float would multiply in fp32
        h = h * torch.tensor(cfg.embedding_multiplier, dtype=h.dtype,
                             device=h.device)
    if "position" in params:
        if position_ids is None:
            position_ids = torch.arange(tokens.shape[1],
                                        device=tokens.device)[None, :]
        if sp:
            # this rank's positions; the table's grad from them alone is
            # summed over the ranks by the train step
            position_ids = position_ids.narrow(
                *sequence_shard(position_ids.shape[1]))
        # the table is replicated: a plain lookup at any tp
        h = h + _cast_table(params["position"], cfg)[position_ids]
    if "tokentype" in params and tokentype_ids is not None:
        if topology.get_tensor_model_parallel_world_size() > 1:
            raise NotImplementedError(
                "tokentype embeddings (BERT, T5) at tp > 1 are not ported "
                "(ROADMAP item 15)")
        h = h + vocab_parallel_embedding(
            tokentype_ids, params["tokentype"],
            compute_dtype=cfg.compute_torch_dtype)
    return _dropout(h, cfg.hidden_dropout, rng_key, train,
                    local=_sequence_local(h, cfg))


def _cast_table(p, cfg) -> torch.Tensor:
    return p["embedding"].to(cfg.compute_torch_dtype)


def lm_head_weight(params) -> torch.Tensor:
    """[V, H] logits weight: the untied head, else the word embedding."""
    if "lm_head" in params:
        return params["lm_head"]["weight"]
    return params["embedding"]["word"]["embedding"]


def language_model_forward(params, tokens: torch.Tensor,
                           position_ids: Optional[torch.Tensor],
                           attention_mask: Optional[torch.Tensor],
                           cfg: TransformerConfig, *,
                           tokentype_ids: Optional[torch.Tensor] = None,
                           rng_key: Optional[int] = None,
                           train: bool = False,
                           compute_logits: bool = True, kv_caches=None,
                           freqs=None):
    """Full LM forward -> logits [b, s, V] (or the final hidden states
    when ``compute_logits=False``); with ``kv_caches`` returns
    ``(out, new_caches)``, and for a mixture of experts without them
    ``(out, moe_aux)`` (the layers' routing aux ``[lb, z]``, summed).
    ``rng_key`` (an integer key, ``megatron_llm_torch/random.py``) is
    split into the embedding's and the stack's dropout keys.  Differentiable; inference callers run it
    under ``torch.no_grad()``."""
    if kv_caches is not None:
        topology.refuse_at_tp("serving (a KV cache; the JAX engine has no "
                              "mesh)")
    train = train and kv_caches is None
    k_embed, k_stack = (mrandom.split(rng_key) if rng_key is not None
                        else (None, None))
    h = embedding_forward(tokens, position_ids, params["embedding"], cfg,
                          tokentype_ids=tokentype_ids, rng_key=k_embed,
                          train=train)
    if freqs is None:
        freqs = rotary_freqs(cfg, device=h.device)
    out = transformer_stack(h, params["transformer"], cfg, freqs=freqs,
                            attention_mask=attention_mask,
                            position_ids=position_ids, kv_caches=kv_caches,
                            rng_key=k_stack, train=train)
    moe_aux = None
    if kv_caches is not None:
        h, new_caches = out
    elif cfg.num_experts > 1:
        h, moe_aux = out
    else:
        h = out
    if compute_logits:
        h = parallel_lm_logits(h, lm_head_weight(params),
                               compute_dtype=cfg.compute_torch_dtype,
                               sequence_parallel=sequence_parallel_on(cfg))
    if kv_caches is not None:
        return h, new_caches
    return (h, moe_aux) if moe_aux is not None else h


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
    mlp_p = h * ffn * mult + ffn * h
    if cfg.num_experts > 1:
        # MoE: top_k experts touched per token + the router matmul
        mlp_p = cfg.moe_top_k * mlp_p + h * cfg.num_experts
    dense = L * (qkv + proj + mlp_p)
    emb = cfg.padded_vocab_size * h
    # fwd = 2 flops/param/token, bwd = 4, attention = 2*2*s*nh*d per layer
    attn = L * 2 * 2 * s * nh * d
    return 6.0 * (dense + emb) + 3.0 * attn


def unsupported_features(cfg: TransformerConfig) -> list:
    """Names of the config features the port has not ported (none of the
    model's own since tokentype embeddings came; the parallel degrees are
    refused by ``ParallelConfig``)."""
    return []
