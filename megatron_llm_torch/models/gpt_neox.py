"""GPT-NeoX / Pythia wrapper (the counterpart of
``megatron_llm_tpu/models/gpt_neox.py``): the parallel residual with the
MLP's own LayerNorm, biases on every linear, exact gelu, an untied head,
and rotary embeddings over the first quarter of each head
(``rotary_percent``)."""

from __future__ import annotations

from megatron_llm_torch.config import PositionEmbeddingType, TransformerConfig
from megatron_llm_torch.models.gpt import GPTModel


class GPTNeoXModel(GPTModel):
    def __init__(self, cfg: TransformerConfig, device=None):
        if cfg.position_embedding_type != PositionEmbeddingType.rotary:
            raise ValueError("gpt-neox requires rotary position embeddings")
        if cfg.glu_activation is not None:
            raise ValueError("gpt-neox uses a plain gelu MLP")
        if cfg.normalization != "layernorm":
            raise ValueError("gpt-neox uses LayerNorm (with biases)")
        if not cfg.add_bias_linear:
            raise ValueError("gpt-neox has biases on every linear")
        if not (cfg.parallel_attn and cfg.parallel_layernorm):
            raise ValueError("gpt-neox uses the parallel residual with its "
                             "own MLP norm")
        if cfg.tie_embed_logits:
            raise ValueError("gpt-neox unties embed_out")
        super().__init__(cfg, device=device)


def gpt_neox_config(size: str = "160m", **overrides) -> TransformerConfig:
    """Pythia suite shapes (the same table as the JAX package)."""
    shapes = {
        "tiny": dict(num_layers=2, hidden_size=64, num_attention_heads=4,
                     ffn_hidden_size=256, padded_vocab_size=256),
        "160m": dict(num_layers=12, hidden_size=768,
                     num_attention_heads=12, ffn_hidden_size=3072,
                     padded_vocab_size=50304),
        "1b": dict(num_layers=16, hidden_size=2048,
                   num_attention_heads=8, ffn_hidden_size=8192,
                   padded_vocab_size=50304),
        "6.9b": dict(num_layers=32, hidden_size=4096,
                     num_attention_heads=32, ffn_hidden_size=16384,
                     padded_vocab_size=50432),
        "12b": dict(num_layers=36, hidden_size=5120,
                    num_attention_heads=40, ffn_hidden_size=20480,
                    padded_vocab_size=50688),
    }
    base = dict(
        position_embedding_type=PositionEmbeddingType.rotary,
        normalization="layernorm",
        glu_activation=None,
        gelu_variant="exact",
        add_bias_linear=True,
        parallel_attn=True,
        parallel_layernorm=True,
        tie_embed_logits=False,
        rotary_percent=0.25,
        rope_theta=10000.0,
        layernorm_epsilon=1e-5,
        seq_length=2048,
        max_position_embeddings=2048,
        hidden_dropout=0.0,
        attention_dropout=0.0,
    )
    base.update(shapes[size])
    base.update(overrides)
    return TransformerConfig(**base)
