"""Falcon wrapper: a GPTModel that asserts the architecture flags (the
counterpart of ``megatron_llm_tpu/models/falcon.py``): rotary positions,
MQA/GQA, parallel attention + MLP (with the MLP's own LayerNorm for the
40B variant)."""

from __future__ import annotations

from megatron_llm_torch.config import PositionEmbeddingType, TransformerConfig
from megatron_llm_torch.models.gpt import GPTModel


class FalconModel(GPTModel):
    def __init__(self, cfg: TransformerConfig, device=None):
        if cfg.position_embedding_type != PositionEmbeddingType.rotary:
            raise ValueError("falcon requires rotary position embeddings")
        if not cfg.parallel_attn:
            raise ValueError("falcon uses parallel attention")
        if not (cfg.num_attention_heads_kv < cfg.num_attention_heads
                or cfg.num_attention_heads_kv == 1):
            raise ValueError("falcon uses MQA/GQA")
        super().__init__(cfg, device=device)


def falcon_config(size: str = "7B", **overrides) -> TransformerConfig:
    """Falcon shapes (the same table as the JAX package)."""
    shapes = {
        "tiny": dict(num_layers=2, hidden_size=128, num_attention_heads=4,
                     num_attention_heads_kv=1, ffn_hidden_size=512,
                     padded_vocab_size=65024, parallel_layernorm=False),
        "7B": dict(num_layers=32, hidden_size=4544, num_attention_heads=71,
                   num_attention_heads_kv=1, ffn_hidden_size=4 * 4544,
                   padded_vocab_size=65024, parallel_layernorm=False),
        "40B": dict(num_layers=60, hidden_size=8192, num_attention_heads=128,
                    num_attention_heads_kv=8, ffn_hidden_size=4 * 8192,
                    padded_vocab_size=65024, parallel_layernorm=True),
    }
    base = dict(
        position_embedding_type=PositionEmbeddingType.rotary,
        normalization="layernorm",
        gelu_variant="exact",
        parallel_attn=True,
        add_bias_linear=False,
        tie_embed_logits=True,
        seq_length=2048,
        max_position_embeddings=2048,
        hidden_dropout=0.0,
        attention_dropout=0.0,
    )
    base.update(shapes[size])
    base.update(overrides)
    return TransformerConfig(**base)
