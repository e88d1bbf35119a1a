"""Gemma (v1) wrapper (the counterpart of
``megatron_llm_tpu/models/gemma.py``): a Llama-like decoder with GeGLU
(tanh gelu), a tied head, a head_dim decoupled from hidden / heads
(``kv_channels``), and the word-embedding output scaled by
sqrt(hidden_size) while the head reads the raw table
(``embedding_multiplier``).  Its ``x_hat * (1 + w)`` RMSNorm is folded
into weight conversion: the stored scale is ``1 + w``."""

from __future__ import annotations

import math

from megatron_llm_torch.config import PositionEmbeddingType, TransformerConfig
from megatron_llm_torch.models.gpt import GPTModel


class GemmaModel(GPTModel):
    def __init__(self, cfg: TransformerConfig, device=None):
        if cfg.position_embedding_type != PositionEmbeddingType.rotary:
            raise ValueError("gemma requires rotary position embeddings")
        if cfg.glu_activation != "geglu":
            raise ValueError("gemma requires GeGLU")
        if cfg.normalization != "rmsnorm":
            raise ValueError("gemma requires RMSNorm")
        if cfg.add_bias_linear:
            raise ValueError("gemma has no linear biases")
        if not cfg.tie_embed_logits:
            raise ValueError("gemma ties embeddings with the head")
        if cfg.embedding_multiplier is None:
            raise ValueError("gemma scales embeddings by sqrt(hidden_size)")
        super().__init__(cfg, device=device)


def gemma_config(size: str = "2B", **overrides) -> TransformerConfig:
    """Gemma-1 shapes (the same table as the JAX package)."""
    shapes = {
        "tiny": dict(num_layers=2, hidden_size=64, num_attention_heads=4,
                     num_attention_heads_kv=1, kv_channels=32,
                     ffn_hidden_size=176, padded_vocab_size=256),
        "2B": dict(num_layers=18, hidden_size=2048, num_attention_heads=8,
                   num_attention_heads_kv=1, kv_channels=256,
                   ffn_hidden_size=16384, padded_vocab_size=256000),
        "7B": dict(num_layers=28, hidden_size=3072, num_attention_heads=16,
                   num_attention_heads_kv=16, kv_channels=256,
                   ffn_hidden_size=24576, padded_vocab_size=256000),
    }
    base = dict(
        position_embedding_type=PositionEmbeddingType.rotary,
        normalization="rmsnorm",
        glu_activation="geglu",
        add_bias_linear=False,
        tie_embed_logits=True,
        rope_theta=10000.0,
        layernorm_epsilon=1e-6,
        seq_length=4096,
        max_position_embeddings=8192,
        hidden_dropout=0.0,
        attention_dropout=0.0,
    )
    base.update(shapes[size])
    base.update(overrides)
    base.setdefault("embedding_multiplier",
                    math.sqrt(base["hidden_size"]))
    return TransformerConfig(**base)
