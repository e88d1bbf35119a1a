"""Mistral wrapper (the counterpart of
``megatron_llm_tpu/models/mistral.py``): the Llama-style flags plus a
4096-token sliding attention window."""

from __future__ import annotations

from megatron_llm_torch.config import PositionEmbeddingType, TransformerConfig
from megatron_llm_torch.models.gpt import GPTModel


class MistralModel(GPTModel):
    def __init__(self, cfg: TransformerConfig, device=None):
        if cfg.position_embedding_type != PositionEmbeddingType.rotary:
            raise ValueError("mistral requires rotary position embeddings")
        if cfg.glu_activation != "swiglu":
            raise ValueError("mistral requires swiglu")
        if cfg.normalization != "rmsnorm":
            raise ValueError("mistral requires RMSNorm")
        if cfg.add_bias_linear:
            raise ValueError("mistral has no linear biases")
        if cfg.tie_embed_logits:
            raise ValueError("mistral does not tie embeddings with logits")
        if cfg.sliding_window_size != 4096:
            raise ValueError("mistral uses a 4096 sliding attention window")
        super().__init__(cfg, device=device)


def mistral_config(size: str = "7B", **overrides) -> TransformerConfig:
    shapes = {
        "tiny": dict(num_layers=2, hidden_size=128, num_attention_heads=4,
                     num_attention_heads_kv=2, ffn_hidden_size=352,
                     padded_vocab_size=32000),
        "7B": dict(num_layers=32, hidden_size=4096, num_attention_heads=32,
                   num_attention_heads_kv=8, ffn_hidden_size=14336,
                   padded_vocab_size=32000),
    }
    base = dict(
        position_embedding_type=PositionEmbeddingType.rotary,
        glu_activation="swiglu",
        normalization="rmsnorm",
        add_bias_linear=False,
        tie_embed_logits=False,
        sliding_window_size=4096,
        rope_theta=10000.0,
        seq_length=4096,
        max_position_embeddings=32768,
        hidden_dropout=0.0,
        attention_dropout=0.0,
    )
    base.update(shapes[size])
    base.update(overrides)
    return TransformerConfig(**base)
