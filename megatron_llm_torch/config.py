"""Model configuration for the PyTorch port.

The counterpart of ``megatron_llm_tpu/config.py``'s ``TransformerConfig``,
with the fields the serving path reads, under the same names and
defaults and with the same ``__post_init__`` derivations.  Dtype names
(``"fp32"``, ``"bf16"``, ``"fp16"``) map to ``torch.dtype``s.  Training
fields (dropout, recompute, the flash-attention switch) come with the
training slice.

The fields that select features outside this slice (MoE, Falcon's
parallel attention, post-LN, learned absolute positions, tokentype
embeddings, LayerNorm) are kept so that asking for one raises
``NotImplementedError`` in the model instead of being ignored.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from enum import Enum
from typing import Optional, Tuple

import torch


class PositionEmbeddingType(str, Enum):
    rotary = "rotary"
    learned_absolute = "learned_absolute"


DTYPES = {
    "fp32": torch.float32,
    "fp16": torch.float16,
    "bf16": torch.bfloat16,
}


@dataclass(frozen=True)
class TransformerConfig:
    """Architecture hyper-parameters (field names mirror the reference
    flags in ``megatron_llm_tpu/arguments.py``)."""

    num_layers: int = 2
    hidden_size: int = 128
    num_attention_heads: int = 4
    num_attention_heads_kv: Optional[int] = None
    ffn_hidden_size: Optional[int] = None
    kv_channels: Optional[int] = None
    seq_length: int = 512
    max_position_embeddings: Optional[int] = None
    padded_vocab_size: int = 50304

    # --- embeddings / head ---
    position_embedding_type: PositionEmbeddingType = \
        PositionEmbeddingType.learned_absolute
    rope_scaling_factor: float = 1.0
    rope_theta: float = 10000.0
    # (factor, low_freq_factor, high_freq_factor, original_max_position)
    rope_llama3_scaling: Optional[Tuple[float, float, float, int]] = None
    tie_embed_logits: bool = True
    num_tokentypes: int = 0

    # --- norm / activation / structure ---
    normalization: str = "layernorm"
    layernorm_epsilon: float = 1e-5
    use_post_ln: bool = False
    glu_activation: Optional[str] = None
    gelu_variant: str = "tanh"
    add_bias_linear: bool = True
    parallel_attn: bool = False
    parallel_layernorm: bool = False
    sliding_window_size: Optional[int] = None

    # --- init ---
    init_method_std: float = 0.02
    init_method_xavier_uniform: bool = False
    use_scaled_init_method: bool = True

    # --- dtypes ---
    params_dtype: str = "fp32"
    compute_dtype: str = "fp32"
    norm_in_fp32: bool = True

    # --- attention numerics ---
    attention_softmax_in_fp32: bool = True
    # RMSNorm through the CUDA kernel (csrc/rmsnorm.cu)
    use_fused_rmsnorm: bool = True

    # --- features outside the serving slice (see module docstring) ---
    num_experts: int = 0
    add_qkv_bias: bool = False
    embedding_multiplier: Optional[float] = None
    rotary_percent: float = 1.0

    def __post_init__(self):
        if self.ffn_hidden_size is None:
            object.__setattr__(self, "ffn_hidden_size", 4 * self.hidden_size)
        if self.kv_channels is None:
            object.__setattr__(
                self, "kv_channels",
                self.hidden_size // self.num_attention_heads)
        if self.num_attention_heads_kv is None:
            object.__setattr__(self, "num_attention_heads_kv",
                               self.num_attention_heads)
        if self.max_position_embeddings is None:
            object.__setattr__(self, "max_position_embeddings",
                               self.seq_length)
        if isinstance(self.position_embedding_type, str):
            object.__setattr__(
                self, "position_embedding_type",
                PositionEmbeddingType(self.position_embedding_type))
        if self.params_dtype not in DTYPES or self.compute_dtype not in DTYPES:
            raise ValueError(
                f"dtypes must be one of {sorted(DTYPES)}, got "
                f"{self.params_dtype!r}/{self.compute_dtype!r}")

    @property
    def head_dim(self) -> int:
        return self.kv_channels

    @property
    def num_query_groups(self) -> int:
        return self.num_attention_heads_kv

    @property
    def params_torch_dtype(self) -> torch.dtype:
        return DTYPES[self.params_dtype]

    @property
    def compute_torch_dtype(self) -> torch.dtype:
        return DTYPES[self.compute_dtype]

    def replace(self, **kw) -> "TransformerConfig":
        return dataclasses.replace(self, **kw)
