"""Model, training and parallelism configuration for the PyTorch port.

The counterpart of ``megatron_llm_tpu/config.py``: ``TransformerConfig``
with the fields the serving and training paths read, ``TrainConfig``
whole, and ``ParallelConfig`` with the tensor-parallel size and sequence
parallelism, under the same names and defaults and with the same
``__post_init__`` derivations.  Dtype names
(``"fp32"``, ``"bf16"``, ``"fp16"``) map to ``torch.dtype``s.  The
``*_from_args`` functions lower the port's CLI (``arguments.py``) into
them, for the flags this slice honours.

The fields that select features outside the ported slices (the parallel
degrees other than tp, ZeRO-1, virtual pipelining) are kept so that
asking for one raises ``NotImplementedError`` instead of being ignored.
``TransformerConfig.sequence_parallel`` carries ``--sequence_parallel``
to the model (the JAX package passes it to the model's call).  The MoE
fields are the JAX package's; ``moe_expert_axis`` is validated and has no
effect on one device.
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

    # --- tensor parallelism: the residual stream, norms and hidden
    # dropouts on this rank's sequence shard (at tp > 1 only) ---
    sequence_parallel: bool = False

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

    # --- mixture of experts (models/moe.py): experts replace the dense
    # MLP in every layer when num_experts > 1 ---
    num_experts: int = 0                 # 0/1 = dense MLP
    moe_top_k: int = 2                   # experts per token
    moe_capacity_factor: float = 1.25    # per-expert buffer slack
    moe_min_capacity: int = 4            # capacity floor (decode s=1)
    moe_aux_loss_coeff: float = 1e-2     # load-balance loss weight
    moe_z_loss_coeff: float = 0.0        # router logit z-loss weight
    # the expert dim's placement over a mesh: auto | expert | replicated
    # (validated; one device holds every expert)
    moe_expert_axis: str = "auto"
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
        if self.num_experts > 1:
            if self.add_bias_linear:
                raise ValueError("MoE experts do not support linear biases "
                                 "(set add_bias_linear=False)")
            if not (1 <= self.moe_top_k <= self.num_experts):
                raise ValueError(
                    f"moe_top_k ({self.moe_top_k}) must be in "
                    f"[1, num_experts={self.num_experts}]")
            if self.moe_expert_axis not in ("auto", "expert", "replicated"):
                raise ValueError(
                    f"moe_expert_axis must be auto|expert|replicated, got "
                    f"{self.moe_expert_axis!r}")

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


# the parallel features this slice does not run: field -> (feature, the
# one value it takes) (ROADMAP item 15)
_UNPORTED_PARALLEL = {
    "pipeline_model_parallel_size": ("pipeline parallelism", 1),
    "context_parallel_size": ("context parallelism", 1),
    "expert_model_parallel_size": ("the expert axis", 1),
    "num_slices": ("multislice training", 1),
    "multislice_hierarchical": ("multislice training", False),
    "virtual_pipeline_model_parallel_size": ("the interleaved pipeline",
                                             None),
}


@dataclass(frozen=True)
class ParallelConfig:
    """Mesh shape + parallelism behaviour (the JAX package's fields).
    Tensor and data parallelism run over ``torch.distributed``
    (``topology.py``), with sequence parallelism at tp > 1 and ZeRO-1
    (``use_distributed_optimizer``) at dp > 1; every other parallel
    degree above 1 and virtual pipelining raise ``NotImplementedError``
    naming the feature (later slices of ROADMAP item 15)."""

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
        if self.tensor_model_parallel_size < 1:
            raise ValueError(f"tensor_model_parallel_size must be >= 1, "
                             f"got {self.tensor_model_parallel_size}")
        for name, (feature, ok) in _UNPORTED_PARALLEL.items():
            value = getattr(self, name)
            if value != ok:
                raise NotImplementedError(
                    f"{feature} ({name}={value}) is not ported yet: this "
                    f"slice runs tensor, sequence and data parallelism "
                    f"only (ROADMAP item 15)")

    @property
    def world_size(self) -> int:
        """The process group's size (1 without one)."""
        import torch.distributed as dist

        return (dist.get_world_size() if dist.is_available()
                and dist.is_initialized() else 1)


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
        sequence_parallel=bool(getattr(args, "sequence_parallel", False)),
        recompute_num_layers=args.recompute_num_layers,
        use_flash_attn=args.use_flash_attn,
        fused_lm_cross_entropy=args.fused_lm_cross_entropy,
        fused_ce_chunk_size=args.fused_ce_chunk_size,
        add_qkv_bias=args.add_qkv_bias,
        embedding_multiplier=args.embedding_multiplier,
        rotary_percent=args.rotary_percent,
        num_experts=args.num_experts,
        moe_top_k=args.moe_top_k,
        moe_capacity_factor=args.moe_capacity_factor,
        moe_min_capacity=args.moe_min_capacity,
        moe_aux_loss_coeff=args.moe_aux_loss_coeff,
        moe_z_loss_coeff=args.moe_z_loss_coeff,
    )


def transformer_config_from_dict(fields: dict, **overrides
                                 ) -> TransformerConfig:
    """A ``TransformerConfig`` from a dict of its fields: a converter's
    config or a checkpoint's recorded args (``meta.json``, where tuples
    came back as lists).  Keys that are not fields (``model_name``, the
    parallel sizes) are left out."""
    names = {f.name for f in dataclasses.fields(TransformerConfig)}
    kw = {k: v for k, v in {**fields, **overrides}.items() if k in names}
    if kw.get("rope_llama3_scaling"):
        kw["rope_llama3_scaling"] = tuple(kw["rope_llama3_scaling"])
    return TransformerConfig(**kw)


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
        loss_scale=args.loss_scale,
        initial_loss_scale=args.initial_loss_scale,
        min_loss_scale=args.min_loss_scale,
        loss_scale_window=args.loss_scale_window,
        hysteresis=args.hysteresis,
        seed=args.seed,
        data_parallel_random_init=args.data_parallel_random_init,
    )


def parallel_config_from_args(args) -> ParallelConfig:
    return ParallelConfig(
        tensor_model_parallel_size=args.tensor_model_parallel_size,
        pipeline_model_parallel_size=args.pipeline_model_parallel_size,
        data_parallel_size=getattr(args, "data_parallel_size", 1),
        virtual_pipeline_model_parallel_size=(
            args.num_layers_per_virtual_pipeline_stage),
        sequence_parallel=args.sequence_parallel,
        use_distributed_optimizer=args.use_distributed_optimizer,
        context_parallel_size=args.context_parallel_size,
        expert_model_parallel_size=args.expert_model_parallel_size,
        num_slices=args.num_slices,
    )
