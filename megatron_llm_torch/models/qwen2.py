"""Qwen2 wrapper (the counterpart of ``megatron_llm_tpu/models/qwen2.py``):
Llama-style (RoPE, RMSNorm, SwiGLU, GQA, no linear biases) with biases on
the QKV projection only (``add_qkv_bias``); the sizes below 7B tie the
head."""

from __future__ import annotations

from megatron_llm_torch.config import PositionEmbeddingType, TransformerConfig
from megatron_llm_torch.models.gpt import GPTModel


class Qwen2Model(GPTModel):
    def __init__(self, cfg: TransformerConfig, device=None):
        if cfg.position_embedding_type != PositionEmbeddingType.rotary:
            raise ValueError("qwen2 requires rotary position embeddings")
        if cfg.glu_activation != "swiglu":
            raise ValueError("qwen2 requires swiglu")
        if cfg.normalization != "rmsnorm":
            raise ValueError("qwen2 requires RMSNorm")
        if cfg.add_bias_linear:
            raise ValueError("qwen2 has no linear biases outside QKV")
        if not cfg.add_qkv_bias:
            raise ValueError("qwen2 requires QKV biases")
        if cfg.parallel_attn:
            raise ValueError("qwen2 uses sequential attn/mlp")
        if cfg.use_post_ln:
            raise ValueError("qwen2 is pre-LN")
        super().__init__(cfg, device=device)


def qwen2_config(size: str = "7B", **overrides) -> TransformerConfig:
    """Qwen2 shapes (the same table as the JAX package)."""
    shapes = {
        "tiny": dict(num_layers=2, hidden_size=128, num_attention_heads=4,
                     num_attention_heads_kv=2, ffn_hidden_size=352,
                     padded_vocab_size=32000, tie_embed_logits=False),
        "0.5B": dict(num_layers=24, hidden_size=896, num_attention_heads=14,
                     num_attention_heads_kv=2, ffn_hidden_size=4864,
                     padded_vocab_size=151936, tie_embed_logits=True),
        "1.5B": dict(num_layers=28, hidden_size=1536,
                     num_attention_heads=12, num_attention_heads_kv=2,
                     ffn_hidden_size=8960, padded_vocab_size=151936,
                     tie_embed_logits=True),
        "7B": dict(num_layers=28, hidden_size=3584, num_attention_heads=28,
                   num_attention_heads_kv=4, ffn_hidden_size=18944,
                   padded_vocab_size=152064, tie_embed_logits=False),
    }
    base = dict(
        position_embedding_type=PositionEmbeddingType.rotary,
        normalization="rmsnorm",
        glu_activation="swiglu",
        add_bias_linear=False,
        add_qkv_bias=True,
        rope_theta=1e6,
        layernorm_epsilon=1e-6,
        seq_length=4096,
        max_position_embeddings=32768,
        hidden_dropout=0.0,
        attention_dropout=0.0,
    )
    base.update(shapes[size])
    base.update(overrides)
    return TransformerConfig(**base)
