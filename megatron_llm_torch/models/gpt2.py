"""GPT-2 style configs (the counterpart of
``megatron_llm_tpu/models/gpt2.py``): learned absolute positions,
LayerNorm, tanh gelu, biases, tied embeddings.  The model class is
``GPTModel``."""

from __future__ import annotations

from megatron_llm_torch.config import PositionEmbeddingType, TransformerConfig


def gpt2_config(size: str = "125M", **overrides) -> TransformerConfig:
    shapes = {
        "tiny": dict(num_layers=2, hidden_size=128, num_attention_heads=4,
                     padded_vocab_size=50304),
        "125M": dict(num_layers=12, hidden_size=768, num_attention_heads=12,
                     padded_vocab_size=50304),
        "355M": dict(num_layers=24, hidden_size=1024, num_attention_heads=16,
                     padded_vocab_size=50304),
        "1.3B": dict(num_layers=24, hidden_size=2048, num_attention_heads=32,
                     padded_vocab_size=50304),
    }
    base = dict(
        position_embedding_type=PositionEmbeddingType.learned_absolute,
        normalization="layernorm",
        add_bias_linear=True,
        tie_embed_logits=True,
        seq_length=1024,
        max_position_embeddings=1024,
        hidden_dropout=0.1,
        attention_dropout=0.1,
    )
    base.update(shapes[size])
    base.update(overrides)
    return TransformerConfig(**base)
