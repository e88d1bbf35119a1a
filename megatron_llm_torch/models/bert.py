"""BERT: masked LM plus the sentence-order binary head (the counterpart of
``megatron_llm_tpu/models/bert.py``, with its param tree).

The bidirectional padding mask goes through ``core_attention``
(``use_flash_attn=False``); the MLM head reuses the tied word embedding
plus a logits bias; its own LayerNorm is the plain one, as in the JAX
package, while the stack's norms take the LayerNorm kernels.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from megatron_llm_torch import topology
from megatron_llm_torch.config import PositionEmbeddingType, TransformerConfig
from megatron_llm_torch.models.language_model import (
    flops_per_token,
    init_language_model_params,
    language_model_forward,
    make_generator,
    num_params,
)
from megatron_llm_torch.ops.cross_entropy import (
    dense_cross_entropy,
    vocab_parallel_cross_entropy,
)
from megatron_llm_torch.ops.layernorm import apply_norm, init_norm_params
from megatron_llm_torch.parallel.layers import (
    column_parallel_linear,
    init_linear_params,
    init_method_normal,
    parallel_lm_logits,
)

# the architecture BERT forces; entry points keep these out of the
# generic CLI config
BERT_ARCH_FLAGS = dict(
    position_embedding_type=PositionEmbeddingType.learned_absolute,
    normalization="layernorm",
    glu_activation=None,
    add_bias_linear=True,
    tie_embed_logits=True,
    num_tokentypes=2,
    use_flash_attn=False,  # the padding mask goes through core attention
)


def bert_config(**overrides) -> TransformerConfig:
    """Learned absolute positions, gelu MLP, biases, padding attention
    mask, tied embeddings, 2 token types."""
    defaults = dict(BERT_ARCH_FLAGS)
    defaults.update(overrides)
    return TransformerConfig(**defaults)


def bert_extended_attention_mask(attention_mask: torch.Tensor
                                 ) -> torch.Tensor:
    """[b, s] 1 = real-token mask -> [b, 1, s, s] bool, True = masked."""
    b1s = attention_mask[:, None, :]
    bs1 = attention_mask[:, :, None]
    return (b1s * bs1)[:, None] < 0.5


def bert_position_ids(tokens: torch.Tensor) -> torch.Tensor:
    s = tokens.shape[1]
    return torch.arange(s, device=tokens.device)[None, :].expand(
        tokens.shape)


def init_bert_lm_head_params(generator, cfg: TransformerConfig, dtype,
                             device=None):
    """The MLM transform: dense h -> h, gelu, LayerNorm, and the logits
    bias [V]."""
    return {
        "dense": init_linear_params(
            generator, cfg.hidden_size, cfg.hidden_size, bias=True,
            init_method=init_method_normal(cfg.init_method_std),
            dtype=dtype, device=device),
        "layernorm": init_norm_params(cfg.hidden_size, "layernorm", dtype,
                                      device),
        "bias": torch.zeros((cfg.padded_vocab_size,), dtype=dtype,
                            device=device),
    }


def bert_lm_head(hidden: torch.Tensor, params, word_embedding: torch.Tensor,
                 cfg: TransformerConfig) -> torch.Tensor:
    # the heads' products run in the hidden states' dtype, as in the JAX
    # package
    h = column_parallel_linear(hidden, params["dense"],
                               compute_dtype=hidden.dtype)
    h = torch.nn.functional.gelu(h, approximate="none")
    # the plain LayerNorm, as the JAX package's head takes it
    h = apply_norm(h, params["layernorm"], "layernorm",
                   eps=cfg.layernorm_epsilon, fp32_compute=cfg.norm_in_fp32)
    logits = parallel_lm_logits(h, word_embedding,
                                compute_dtype=cfg.compute_torch_dtype)
    return logits + params["bias"].to(logits.dtype)


def init_pooler_params(generator, cfg: TransformerConfig, dtype,
                       device=None):
    return init_linear_params(
        generator, cfg.hidden_size, cfg.hidden_size, bias=True,
        init_method=init_method_normal(cfg.init_method_std), dtype=dtype,
        device=device)


def pooler(hidden: torch.Tensor, params) -> torch.Tensor:
    """dense + tanh over the first ([CLS]) position."""
    first = hidden[:, 0, :]
    return torch.tanh(column_parallel_linear(first, params,
                                             compute_dtype=first.dtype))


class BertModel:
    """BERT with the MLM head and, unless ``add_binary_head=False``, the
    pooler and the sentence-order head."""

    def __init__(self, cfg: TransformerConfig, add_binary_head: bool = True,
                 device=None):
        if cfg.num_experts > 1:
            raise NotImplementedError(
                "MoE (num_experts > 1) is only wired for the decoder-only "
                "GPT family")
        topology.refuse_at_tp("BERT")
        self.cfg = cfg
        self.add_binary_head = add_binary_head
        self.device = torch.device(device if device is not None else "cuda")

    def init(self, seed: Union[int, torch.Generator, None] = 0,
             device=None) -> dict:
        """Random params from ``seed`` in ``cfg.params_dtype`` (``seed``
        None with ``device="meta"``: the tree's shapes alone)."""
        device = device or self.device
        gen = None if seed is None else make_generator(seed, device)
        dtype = self.cfg.params_torch_dtype
        params = init_language_model_params(gen, self.cfg, device=device)
        params["lm_head"] = init_bert_lm_head_params(gen, self.cfg, dtype,
                                                     device)
        if self.add_binary_head:
            params["pooler"] = init_pooler_params(gen, self.cfg, dtype,
                                                  device)
            params["binary_head"] = init_linear_params(
                gen, self.cfg.hidden_size, 2, bias=True,
                init_method=init_method_normal(self.cfg.init_method_std),
                dtype=dtype, device=device)
        return params

    def template(self) -> dict:
        return self.init(None, device="meta")

    def num_params(self, params) -> int:
        return num_params(params)

    def flops_per_token(self, seq_len=None) -> float:
        return flops_per_token(self.cfg, seq_len)

    def __call__(self, params, tokens: torch.Tensor,
                 position_ids: Optional[torch.Tensor] = None,
                 attention_mask: Optional[torch.Tensor] = None,
                 labels: Optional[torch.Tensor] = None, *,
                 tokentype_ids: Optional[torch.Tensor] = None,
                 sentence_order: Optional[torch.Tensor] = None,
                 rng_key: Optional[int] = None, train: bool = False):
        """``attention_mask``: the [b, s] pad mask (1 = keep).  Returns
        (per-token MLM loss [b, s], per-example SOP loss [b] or None)
        with ``labels``, else (lm_logits, binary_logits or None)."""
        cfg = self.cfg
        if attention_mask is None:
            attention_mask = torch.ones(tokens.shape, dtype=torch.int32,
                                        device=tokens.device)
        ext_mask = bert_extended_attention_mask(attention_mask)
        if position_ids is None:
            position_ids = bert_position_ids(tokens)
        hidden = language_model_forward(
            params, tokens, position_ids, ext_mask, cfg,
            tokentype_ids=tokentype_ids, rng_key=rng_key, train=train,
            compute_logits=False)
        lm_logits = bert_lm_head(hidden, params["lm_head"],
                                 params["embedding"]["word"]["embedding"],
                                 cfg)
        binary_logits = None
        if self.add_binary_head and "pooler" in params:
            pooled = pooler(hidden, params["pooler"])
            binary_logits = column_parallel_linear(
                pooled, params["binary_head"], compute_dtype=pooled.dtype)
        if labels is None:
            return lm_logits, binary_logits
        lm_loss = vocab_parallel_cross_entropy(lm_logits.float(), labels)
        if binary_logits is None:
            return lm_loss, None
        if sentence_order is None:
            raise ValueError(
                "BertModel with add_binary_head=True needs sentence_order "
                "in the batch when computing the loss (pass "
                "add_binary_head=False to train MLM-only)")
        return lm_loss, dense_cross_entropy(binary_logits, sentence_order)
