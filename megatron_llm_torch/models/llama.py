"""Llama 1/2 wrapper: a GPTModel that asserts the architecture flags
(the counterpart of ``megatron_llm_tpu/models/llama.py``)."""

from __future__ import annotations

from megatron_llm_torch.config import PositionEmbeddingType, TransformerConfig
from megatron_llm_torch.models.gpt import GPTModel


class LlamaModel(GPTModel):
    def __init__(self, cfg: TransformerConfig, device=None):
        if cfg.position_embedding_type != PositionEmbeddingType.rotary:
            raise ValueError("llama requires rotary position embeddings")
        if cfg.glu_activation != "swiglu":
            raise ValueError("llama requires swiglu")
        if cfg.normalization != "rmsnorm":
            raise ValueError("llama requires RMSNorm")
        if cfg.add_bias_linear:
            raise ValueError("llama has no linear biases")
        if cfg.tie_embed_logits:
            raise ValueError("llama does not tie embeddings with logits")
        if cfg.parallel_attn:
            raise ValueError("llama uses sequential attn/mlp")
        if cfg.use_post_ln:
            raise ValueError("llama is pre-LN")
        super().__init__(cfg, device=device)


def llama_config(size: str = "7B", **overrides) -> TransformerConfig:
    """Llama-2 family shapes (the same table as the JAX package)."""
    shapes = {
        "tiny": dict(num_layers=2, hidden_size=128, num_attention_heads=4,
                     ffn_hidden_size=352, padded_vocab_size=32000),
        "7B": dict(num_layers=32, hidden_size=4096, num_attention_heads=32,
                   ffn_hidden_size=11008, padded_vocab_size=32000),
        "13B": dict(num_layers=40, hidden_size=5120, num_attention_heads=40,
                    ffn_hidden_size=13824, padded_vocab_size=32000),
        "70B": dict(num_layers=80, hidden_size=8192, num_attention_heads=64,
                    num_attention_heads_kv=8, ffn_hidden_size=28672,
                    padded_vocab_size=32000),
        "llama3-8B": dict(num_layers=32, hidden_size=4096,
                          num_attention_heads=32, num_attention_heads_kv=8,
                          ffn_hidden_size=14336, padded_vocab_size=128256,
                          rope_theta=500000.0, seq_length=8192,
                          max_position_embeddings=8192),
        "llama3-70B": dict(num_layers=80, hidden_size=8192,
                           num_attention_heads=64,
                           num_attention_heads_kv=8,
                           ffn_hidden_size=28672,
                           padded_vocab_size=128256,
                           rope_theta=500000.0, seq_length=8192,
                           max_position_embeddings=8192),
    }
    base = dict(
        position_embedding_type=PositionEmbeddingType.rotary,
        glu_activation="swiglu",
        normalization="rmsnorm",
        add_bias_linear=False,
        tie_embed_logits=False,
        layernorm_epsilon=1e-5,
        seq_length=4096,
        max_position_embeddings=4096,
        hidden_dropout=0.0,
        attention_dropout=0.0,
    )
    base.update(shapes[size])
    base.update(overrides)
    return TransformerConfig(**base)
