"""Mixtral wrapper (the counterpart of
``megatron_llm_tpu/models/mixtral.py``): the Llama-style trunk with GQA
and a top-2 routed 8-expert MLP in every layer (``models/moe.py``)."""

from __future__ import annotations

from megatron_llm_torch.config import PositionEmbeddingType, TransformerConfig
from megatron_llm_torch.models.gpt import GPTModel


class MixtralModel(GPTModel):
    def __init__(self, cfg: TransformerConfig, device=None):
        if cfg.position_embedding_type != PositionEmbeddingType.rotary:
            raise ValueError("mixtral requires rotary position embeddings")
        if cfg.glu_activation != "swiglu":
            raise ValueError("mixtral requires swiglu")
        if cfg.normalization != "rmsnorm":
            raise ValueError("mixtral requires RMSNorm")
        if cfg.add_bias_linear:
            raise ValueError("mixtral has no linear biases")
        if cfg.tie_embed_logits:
            raise ValueError("mixtral does not tie embeddings with logits")
        if cfg.num_experts <= 1:
            raise ValueError("mixtral is a sparse MoE model (num_experts > 1)")
        super().__init__(cfg, device=device)


def mixtral_config(size: str = "8x7B", **overrides) -> TransformerConfig:
    shapes = {
        "tiny": dict(num_layers=2, hidden_size=128, num_attention_heads=4,
                     num_attention_heads_kv=2, ffn_hidden_size=352,
                     padded_vocab_size=32000, num_experts=4),
        "8x7B": dict(num_layers=32, hidden_size=4096,
                     num_attention_heads=32, num_attention_heads_kv=8,
                     ffn_hidden_size=14336, padded_vocab_size=32000,
                     num_experts=8),
    }
    base = dict(
        position_embedding_type=PositionEmbeddingType.rotary,
        glu_activation="swiglu",
        normalization="rmsnorm",
        add_bias_linear=False,
        tie_embed_logits=False,
        moe_top_k=2,
        rope_theta=1e6,
        seq_length=4096,
        max_position_embeddings=32768,
        hidden_dropout=0.0,
        attention_dropout=0.0,
    )
    base.update(shapes[size])
    base.update(overrides)
    return TransformerConfig(**base)
