"""Command-line flags of the port's trainer: the subset of
``megatron_llm_tpu/arguments.py`` that the single-device training slice
honours, under the same names and defaults, and the derivations of its
``validate_args`` that they need.

Flags of features outside the slice that a user may well pass (data,
``--load``/``--save``, parallel sizes, ``--fp16``) are accepted so that
asking for one raises ``NotImplementedError`` in ``finetune.py`` or the
config; the rest of the JAX package's flags are not defined here, and
argparse refuses them.  ``--device`` picks the torch device (``cuda``
unless the caller asks for ``cpu``).
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional, Sequence


def build_parser(extra_args_provider: Optional[Callable] = None
                 ) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Megatron-LLM training in PyTorch on one GPU",
        allow_abbrev=False)
    g = p.add_argument_group("network size")
    g.add_argument("--num_layers", type=int, default=None)
    g.add_argument("--hidden_size", type=int, default=None)
    g.add_argument("--ffn_hidden_size", type=int, default=None)
    g.add_argument("--num_attention_heads", type=int, default=None)
    g.add_argument("--num_attention_heads_kv", type=int, default=None)
    g.add_argument("--kv_channels", type=int, default=None)
    g.add_argument("--seq_length", type=int, default=None)
    g.add_argument("--max_position_embeddings", type=int, default=None)
    g.add_argument("--make_vocab_size_divisible_by", type=int, default=128)
    g.add_argument("--padded_vocab_size", type=int, default=None)
    g.add_argument("--position_embedding_type", type=str,
                   default="learned_absolute",
                   choices=["learned_absolute", "rotary"])
    g.add_argument("--rope_scaling_factor", type=float, default=1.0)
    g.add_argument("--rope_theta", type=float, default=10000.0)
    g.add_argument("--layernorm_epsilon", type=float, default=1e-5)
    g.add_argument("--use_rms_norm", action="store_true")
    g.add_argument("--glu_activation", type=str, default=None,
                   choices=[None, "liglu", "geglu", "reglu", "swiglu"])
    g.add_argument("--no_bias", action="store_false", dest="use_bias")
    g.add_argument("--use_bias", action="store_true", dest="use_bias")
    g.add_argument("--sliding_window_size", type=int, default=None)
    g.add_argument("--no_tie_embed_logits", action="store_false",
                   dest="tie_embed_logits")

    g = p.add_argument_group("regularization")
    g.add_argument("--attention_dropout", type=float, default=0.1)
    g.add_argument("--hidden_dropout", type=float, default=0.1)
    g.add_argument("--weight_decay", type=float, default=0.01)
    g.add_argument("--start_weight_decay", type=float, default=None)
    g.add_argument("--end_weight_decay", type=float, default=None)
    g.add_argument("--weight_decay_incr_style", default="constant",
                   choices=["constant", "linear", "cosine"])
    g.add_argument("--clip_grad", type=float, default=1.0)
    g.add_argument("--adam_beta1", type=float, default=0.9)
    g.add_argument("--adam_beta2", type=float, default=0.999)
    g.add_argument("--adam_eps", type=float, default=1e-8)
    g.add_argument("--sgd_momentum", type=float, default=0.9)
    g.add_argument("--optimizer_state_dtype", default="fp32",
                   choices=["fp32", "bf16"])

    g = p.add_argument_group("training")
    g.add_argument("--micro_batch_size", type=int, default=1)
    g.add_argument("--global_batch_size", type=int, default=None)
    g.add_argument("--train_iters", type=int, default=None)
    g.add_argument("--exit_interval", type=int, default=None)
    g.add_argument("--optimizer", default="adam", choices=["adam", "sgd"])
    g.add_argument("--recompute_granularity", default=None,
                   choices=[None, "full", "uniform", "block", "selective"])
    g.add_argument("--skip_iters", type=int, nargs="*", default=[])
    g.add_argument("--use_flash_attn", action="store_true", default=True)
    g.add_argument("--no_flash_attn", action="store_false",
                   dest="use_flash_attn")

    g = p.add_argument_group("initialization")
    g.add_argument("--seed", type=int, default=1234)
    g.add_argument("--init_method_std", type=float, default=0.02)

    g = p.add_argument_group("learning rate")
    g.add_argument("--lr", type=float, default=None)
    g.add_argument("--lr_decay_style", default="linear",
                   choices=["constant", "linear", "cosine",
                            "inverse-square-root"])
    g.add_argument("--lr_decay_iters", type=int, default=None)
    g.add_argument("--lr_warmup_fraction", type=float, default=None)
    g.add_argument("--lr_warmup_iters", type=int, default=0)
    g.add_argument("--min_lr", type=float, default=0.0)

    g = p.add_argument_group("mixed precision")
    g.add_argument("--fp16", action="store_true")
    g.add_argument("--bf16", action="store_true")

    g = p.add_argument_group("checkpointing, data, parallelism")
    g.add_argument("--save", type=str, default=None)
    g.add_argument("--load", type=str, default=None)
    g.add_argument("--data_path", nargs="*", default=None)
    g.add_argument("--vocab_size", type=int, default=None)
    g.add_argument("--tensor_model_parallel_size", type=int, default=1)
    g.add_argument("--pipeline_model_parallel_size", type=int, default=1)
    g.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device to train on ('cpu' for tests)")

    g = p.add_argument_group("logging")
    g.add_argument("--log_interval", type=int, default=100)

    if extra_args_provider is not None:
        p = extra_args_provider(p)
    return p


def validate_args(args):
    """The JAX package's derivations for the flags above (one device)."""
    if args.fp16 and args.bf16:
        raise ValueError("--fp16 and --bf16 are exclusive")
    args.params_dtype = ("fp16" if args.fp16 else "bf16" if args.bf16
                         else "fp32")
    args.data_parallel_size = 1
    if args.global_batch_size is None:
        args.global_batch_size = args.micro_batch_size
    if args.global_batch_size % args.micro_batch_size:
        raise ValueError(f"global batch ({args.global_batch_size}) not "
                         f"divisible by micro batch "
                         f"({args.micro_batch_size})")
    if args.ffn_hidden_size is None and args.hidden_size is not None:
        args.ffn_hidden_size = 4 * args.hidden_size
    if args.kv_channels is None and args.hidden_size is not None:
        args.kv_channels = args.hidden_size // args.num_attention_heads
    if args.max_position_embeddings is None:
        args.max_position_embeddings = args.seq_length
    if args.num_attention_heads_kv is None:
        args.num_attention_heads_kv = args.num_attention_heads
    if args.lr_decay_iters is None and args.train_iters:
        args.lr_decay_iters = args.train_iters
    if args.lr_warmup_fraction is not None:
        args.lr_warmup_iters = int(
            args.lr_warmup_fraction * (args.lr_decay_iters or 0))
    if args.padded_vocab_size is None and args.vocab_size is not None:
        mult = (args.make_vocab_size_divisible_by
                * args.tensor_model_parallel_size)
        args.padded_vocab_size = -(-args.vocab_size // mult) * mult
    return args


def parse_args(argv: Optional[Sequence[str]] = None,
               extra_args_provider: Optional[Callable] = None):
    args = build_parser(extra_args_provider).parse_args(argv)
    return validate_args(args)
