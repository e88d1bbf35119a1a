"""Model, training and parallelism configuration for the PyTorch port.

The counterpart of ``megatron_llm_tpu/config.py``: ``TransformerConfig``
with the fields the serving and training paths read, ``TrainConfig``
whole, and ``ParallelConfig`` for one device, under the same names and
defaults and with the same ``__post_init__`` derivations.  Dtype names
(``"fp32"``, ``"bf16"``, ``"fp16"``) map to ``torch.dtype``s.  The
``*_from_args`` functions lower the port's CLI (``arguments.py``) into
them, for the flags this slice honours.

The fields that select features outside the ported slices (MoE, tokentype
embeddings and every parallel degree above 1) are kept so that asking for
one raises ``NotImplementedError`` instead of being ignored.
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

    # --- dropout / init ---
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    init_method_std: float = 0.02
    init_method_xavier_uniform: bool = False
    use_scaled_init_method: bool = True

    # --- dtypes ---
    params_dtype: str = "fp32"
    compute_dtype: str = "fp32"
    norm_in_fp32: bool = True

    # --- attention numerics ---
    attention_softmax_in_fp32: bool = True
    # the no-cache attention through flash attention (kernels F, G/H of
    # csrc/flash_attention.cu); off: core_attention
    use_flash_attn: bool = True
    # RMSNorm through the CUDA kernels (csrc/layernorm.cu, B and C)
    use_fused_rmsnorm: bool = True
    # LayerNorm through the CUDA kernels (csrc/layernorm.cu, D and E)
    use_fused_layernorm: bool = True
    # the LM head and the cross entropy fused over vocabulary chunks
    # (ops/cross_entropy.py), chunks of at most fused_ce_chunk_size rows
    fused_lm_cross_entropy: bool = False
    fused_ce_chunk_size: int = 8192

    # --- recompute: torch.utils.checkpoint of each layer in training ---
    # None | 'full' | 'uniform' | 'block' | 'selective'
    recompute_granularity: Optional[str] = None
    recompute_num_layers: int = 1

    # --- LIMA dropout: hidden dropout rising linearly over the layers ---
    lima_dropout: bool = False

    # --- mixture of experts: not ported (asking for it raises) ---
    num_experts: int = 0
    # --- family knobs: Qwen2's QKV-only bias, Gemma's embedding scale,
    # GPT-NeoX's partial rotary ---
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


@dataclass(frozen=True)
class ParallelConfig:
    """Mesh shape + parallelism behaviour (the JAX package's fields).
    This slice runs on one device: any parallel degree above 1, sequence
    parallelism, ZeRO-1 or virtual pipelining raises
    ``NotImplementedError`` (parallelism over ``torch.distributed`` is a
    later slice)."""

    tensor_model_parallel_size: int = 1
    pipeline_model_parallel_size: int = 1
    data_parallel_size: int = 1
    virtual_pipeline_model_parallel_size: Optional[int] = None
    sequence_parallel: bool = False
    use_distributed_optimizer: bool = False
    context_parallel_size: int = 1
    expert_model_parallel_size: int = 1
    num_slices: int = 1
    multislice_hierarchical: bool = False

    def __post_init__(self):
        sizes = {k: getattr(self, k) for k in (
            "tensor_model_parallel_size", "pipeline_model_parallel_size",
            "data_parallel_size", "context_parallel_size",
            "expert_model_parallel_size", "num_slices")}
        over = {k: v for k, v in sizes.items() if v != 1}
        flags = [k for k in ("sequence_parallel", "use_distributed_optimizer",
                             "multislice_hierarchical") if getattr(self, k)]
        if self.virtual_pipeline_model_parallel_size is not None:
            flags.append("virtual_pipeline_model_parallel_size")
        if over or flags:
            raise NotImplementedError(
                f"the port trains on one device; parallelism is a later "
                f"slice (got {over or ''}{' ' if over and flags else ''}"
                f"{flags or ''})")

    @property
    def world_size(self) -> int:
        return 1


@dataclass(frozen=True)
class TrainConfig:
    """Optimization / schedule configuration (the JAX package's, whole)."""

    micro_batch_size: int = 1
    global_batch_size: int = 1
    rampup_batch_size: Optional[Tuple[int, int, int]] = None
    train_iters: int = 0
    # optimizer
    optimizer: str = "adam"             # 'adam' | 'sgd'
    lr: float = 1e-4
    min_lr: float = 0.0
    # constant | linear | cosine | inverse-square-root
    lr_decay_style: str = "linear"
    lr_decay_iters: Optional[int] = None
    lr_warmup_iters: int = 0
    lr_warmup_fraction: Optional[float] = None
    weight_decay: float = 0.01
    start_weight_decay: Optional[float] = None
    end_weight_decay: Optional[float] = None
    weight_decay_incr_style: str = "constant"
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    sgd_momentum: float = 0.9
    # 'fp32' | 'bf16': storage dtype of the Adam moments / SGD momentum;
    # the update math runs in fp32 either way
    optimizer_state_dtype: str = "fp32"
    clip_grad: float = 1.0
    # mixed precision
    fp16: bool = False
    bf16: bool = False
    loss_scale: Optional[float] = None          # static scale; None -> dynamic
    initial_loss_scale: float = 2.0 ** 32
    min_loss_scale: float = 1.0
    loss_scale_window: int = 1000
    hysteresis: int = 2
    # misc
    seed: int = 1234
    data_parallel_random_init: bool = False

    def __post_init__(self):
        if self.optimizer_state_dtype not in ("fp32", "bf16"):
            raise ValueError(
                f"optimizer_state_dtype must be fp32|bf16, got "
                f"{self.optimizer_state_dtype!r}")


# ---------------------------------------------------------------------------
# lowering the CLI (arguments.py) into the config dataclasses
# ---------------------------------------------------------------------------

def transformer_config_from_args(args, model_name: Optional[str] = None
                                 ) -> TransformerConfig:
    return TransformerConfig(
        num_layers=args.num_layers,
        hidden_size=args.hidden_size,
        num_attention_heads=args.num_attention_heads,
        num_attention_heads_kv=args.num_attention_heads_kv,
        ffn_hidden_size=args.ffn_hidden_size,
        kv_channels=args.kv_channels,
        seq_length=args.seq_length,
        max_position_embeddings=args.max_position_embeddings,
        padded_vocab_size=args.padded_vocab_size,
        position_embedding_type=args.position_embedding_type,
        rope_scaling_factor=args.rope_scaling_factor,
        rope_theta=args.rope_theta,
        rope_llama3_scaling=(tuple(args.rope_llama3_scaling)
                             if args.rope_llama3_scaling else None),
        tie_embed_logits=args.tie_embed_logits,
        normalization="rmsnorm" if args.use_rms_norm else "layernorm",
        layernorm_epsilon=args.layernorm_epsilon,
        use_post_ln=args.use_post_ln,
        glu_activation=args.glu_activation,
        gelu_variant=args.gelu_variant,
        add_bias_linear=args.use_bias,
        parallel_attn=args.parallel_attn,
        parallel_layernorm=args.parallel_layernorm,
        sliding_window_size=args.sliding_window_size,
        hidden_dropout=args.hidden_dropout,
        attention_dropout=args.attention_dropout,
        lima_dropout=args.lima_dropout,
        init_method_std=args.init_method_std,
        init_method_xavier_uniform=args.init_method_xavier_uniform,
        attention_softmax_in_fp32=args.attention_softmax_in_fp32,
        params_dtype=args.params_dtype,
        compute_dtype="bf16" if args.bf16 else "fp16" if args.fp16 else "fp32",
        recompute_granularity=args.recompute_granularity,
        recompute_num_layers=args.recompute_num_layers,
        use_flash_attn=args.use_flash_attn,
        fused_lm_cross_entropy=args.fused_lm_cross_entropy,
        fused_ce_chunk_size=args.fused_ce_chunk_size,
        add_qkv_bias=args.add_qkv_bias,
        embedding_multiplier=args.embedding_multiplier,
        rotary_percent=args.rotary_percent,
    )


def train_config_from_args(args) -> TrainConfig:
    return TrainConfig(
        micro_batch_size=args.micro_batch_size,
        global_batch_size=args.global_batch_size,
        train_iters=args.train_iters or 0,
        optimizer=args.optimizer,
        lr=args.lr or 1e-4,
        min_lr=args.min_lr,
        lr_decay_style=args.lr_decay_style,
        lr_decay_iters=args.lr_decay_iters,
        lr_warmup_iters=args.lr_warmup_iters,
        weight_decay=args.weight_decay,
        start_weight_decay=args.start_weight_decay,
        end_weight_decay=args.end_weight_decay,
        weight_decay_incr_style=args.weight_decay_incr_style,
        adam_beta1=args.adam_beta1,
        adam_beta2=args.adam_beta2,
        adam_eps=args.adam_eps,
        sgd_momentum=args.sgd_momentum,
        optimizer_state_dtype=args.optimizer_state_dtype,
        clip_grad=args.clip_grad,
        fp16=args.fp16,
        bf16=args.bf16,
        seed=args.seed,
    )


def parallel_config_from_args(args) -> ParallelConfig:
    return ParallelConfig(
        tensor_model_parallel_size=args.tensor_model_parallel_size,
        pipeline_model_parallel_size=args.pipeline_model_parallel_size,
    )
