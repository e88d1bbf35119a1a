"""Command-line flags of the port's trainer: the subset of
``megatron_llm_tpu/arguments.py`` that the single-device training slice
honours, under the same names and defaults, and the derivations of its
``validate_args`` that they need.

The checkpoint, evaluation, data, tokenizer, dropout, recompute and fused
cross-entropy flags have the JAX parser's names and defaults, and
``apply_fused_ce_policy`` is the JAX package's (re-fired by
``build_tokenizer`` once the padded vocabulary is known).  Flags of
features outside the port that a user may well pass (parallel sizes,
``--fp16``, ``--async_save``) are accepted so that asking for one raises
``NotImplementedError`` in ``finetune.py`` or the config;
``--bias_dropout_fusion`` is accepted and ignored, as the JAX parser
accepts it.  The rest of the JAX package's flags are not defined here,
and argparse refuses them.  ``--device`` picks the torch device
(``cuda`` unless the caller asks for ``cpu``).
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
    g.add_argument("--rope_llama3_scaling", type=float, nargs=4,
                   default=None,
                   metavar=("FACTOR", "LOW_FREQ", "HIGH_FREQ", "ORIG_MAX"),
                   help="Llama-3.1 NTK-by-parts rope remap: factor "
                        "low_freq_factor high_freq_factor "
                        "original_max_position (e.g. 8 1 4 8192)")
    g.add_argument("--layernorm_epsilon", type=float, default=1e-5)
    g.add_argument("--use_rms_norm", action="store_true")
    g.add_argument("--use_post_ln", action="store_true")
    g.add_argument("--glu_activation", type=str, default=None,
                   choices=[None, "liglu", "geglu", "reglu", "swiglu"])
    g.add_argument("--no_bias", action="store_false", dest="use_bias")
    g.add_argument("--use_bias", action="store_true", dest="use_bias")
    g.add_argument("--apply_residual_connection_post_layernorm",
                   action="store_true", dest="use_post_ln")
    g.add_argument("--parallel_attn", action="store_true")
    g.add_argument("--parallel_layernorm", action="store_true")
    g.add_argument("--sliding_window_size", type=int, default=None)
    g.add_argument("--add_qkv_bias", action="store_true",
                   help="bias on the QKV projection only (Qwen2-style)")
    g.add_argument("--embedding_multiplier", type=float, default=None,
                   help="scale embedding output (Gemma: sqrt(hidden))")
    g.add_argument("--rotary_percent", type=float, default=1.0,
                   help="fraction of head dims that rotate "
                        "(GPT-NeoX/Pythia rotary_pct)")
    g.add_argument("--gelu_variant", default="tanh",
                   choices=["tanh", "exact"],
                   help="non-GLU MLP gelu: tanh-approximate (GPT-2) or "
                        "exact erf (Falcon/NeoX)")
    g.add_argument("--no_tie_embed_logits", action="store_false",
                   dest="tie_embed_logits")

    g = p.add_argument_group("regularization")
    g.add_argument("--attention_dropout", type=float, default=0.1)
    g.add_argument("--hidden_dropout", type=float, default=0.1)
    g.add_argument("--lima_dropout", action="store_true")
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
    g.add_argument("--exit_duration_in_mins", type=int, default=None)
    g.add_argument("--optimizer", default="adam", choices=["adam", "sgd"])
    g.add_argument("--recompute_granularity", default=None,
                   choices=[None, "full", "uniform", "block", "selective"])
    g.add_argument("--recompute_num_layers", type=int, default=1)
    # --recompute_activations is the selective granularity,
    # --recompute_method picks the full-layer schedule (validate_args)
    g.add_argument("--recompute_activations", action="store_true")
    g.add_argument("--recompute_method", default=None,
                   choices=[None, "uniform", "block"])
    g.add_argument("--eval_only", action="store_true")
    g.add_argument("--skip_iters", type=int, nargs="*", default=[])
    g.add_argument("--dataloader_type", default="single",
                   choices=["single", "cyclic"])
    g.add_argument("--use_flash_attn", action="store_true", default=True)
    g.add_argument("--no_flash_attn", action="store_false",
                   dest="use_flash_attn")
    # None = not given: apply_fused_ce_policy decides from the vocabulary
    g.add_argument("--fused_lm_cross_entropy", action="store_const",
                   const=True, default=None)
    g.add_argument("--no_fused_lm_cross_entropy", action="store_const",
                   const=False, dest="fused_lm_cross_entropy")
    g.add_argument("--fused_ce_chunk_size", type=int, default=8192)

    g = p.add_argument_group("initialization")
    g.add_argument("--seed", type=int, default=1234)
    g.add_argument("--init_method_std", type=float, default=0.02)
    g.add_argument("--init_method_xavier_uniform", action="store_true")

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
    g.add_argument("--attention_softmax_in_fp32", action="store_true",
                   default=True)
    g.add_argument("--no_attention_softmax_in_fp32", action="store_false",
                   dest="attention_softmax_in_fp32")

    g = p.add_argument_group("checkpointing")
    g.add_argument("--save", type=str, default=None)
    g.add_argument("--save_interval", type=int, default=None)
    g.add_argument("--async_save", action="store_true",
                   help="background checkpoint writes (not ported: "
                        "raises)")
    g.add_argument("--load", type=str, default=None)
    g.add_argument("--load_iters", type=int, default=None,
                   help="load this iteration instead of the tracker's latest")
    g.add_argument("--finetune", action="store_true")
    g.add_argument("--use_checkpoint_args", action="store_true")
    g.add_argument("--no_save_optim", action="store_true")
    g.add_argument("--no_load_optim", action="store_true")
    g.add_argument("--save_total_limit", type=int, default=0,
                   help="keep only the newest N iter_* checkpoints "
                        "(0 = keep all)")

    g = p.add_argument_group("validation")
    g.add_argument("--eval_iters", type=int, default=100)
    g.add_argument("--eval_interval", type=int, default=1000)

    g = p.add_argument_group("data")
    g.add_argument("--data_path", nargs="*", default=None)
    g.add_argument("--split", type=str, default="969,30,1")
    g.add_argument("--data_impl", default="mmap")
    g.add_argument("--num_workers", type=int, default=2,
                   help="batches the loader's background thread builds "
                        "ahead")
    g.add_argument("--tokenizer_type", type=str, default=None)
    g.add_argument("--vocab_file", type=str, default=None)
    g.add_argument("--merge_file", type=str, default=None)
    g.add_argument("--tokenizer_path", type=str, default=None)
    g.add_argument("--tokenizer_model", type=str, default=None)
    g.add_argument("--vocab_extra_ids_list", type=str, default=None)
    g.add_argument("--vocab_size", type=int, default=None)
    g.add_argument("--vocab_extra_ids", type=int, default=0)
    g.add_argument("--no_new_tokens", action="store_false", dest="new_tokens")
    g.add_argument("--variable_seq_lengths", action="store_true")
    g.add_argument("--scalar_loss_mask", type=float, default=0.0)
    g.add_argument("--data_type", default="gpt",
                   choices=["gpt", "instruction"])

    g = p.add_argument_group("parallelism")
    g.add_argument("--tensor_model_parallel_size", type=int, default=1)
    g.add_argument("--pipeline_model_parallel_size", type=int, default=1)
    g.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device to train on ('cpu' for tests)")

    g = p.add_argument_group("logging")
    g.add_argument("--log_interval", type=int, default=100)
    g.add_argument("--log_params_norm", action="store_true")
    g.add_argument("--log_num_zeros_in_grad", action="store_true")

    g = p.add_argument_group("compat (ignored)")
    g.add_argument("--bias_dropout_fusion", action="store_true")
    g.add_argument("--no_bias_dropout_fusion", action="store_false",
                   dest="bias_dropout_fusion")

    if extra_args_provider is not None:
        p = extra_args_provider(p)
    return p


def apply_fused_ce_policy(args, vocab=None):
    """Decide ``fused_lm_cross_entropy`` from the best-known vocab size
    (the JAX package's policy): off below 64k, a note at 64k-128k, on at
    128k or more with an unsharded vocabulary.  The user's explicit
    choice, resolved on the first call, always wins; otherwise a later
    call (the tokenizer's padding, a second ``validate_args`` after
    ``--use_checkpoint_args``) decides again from the larger vocab."""
    if vocab is None:
        vocab = max(getattr(args, "padded_vocab_size", 0) or 0,
                    getattr(args, "vocab_size", 0) or 0)
    if getattr(args, "fused_ce_user_explicit", None) is None:
        args.fused_ce_user_explicit = \
            getattr(args, "fused_lm_cross_entropy", None) is not None
    if args.fused_ce_user_explicit:
        return
    rank0 = getattr(args, "rank", 0) == 0
    tp = getattr(args, "tensor_model_parallel_size", 1) or 1
    if vocab >= 131072 and tp == 1:
        if not getattr(args, "fused_lm_cross_entropy", False) and rank0:
            print(" > vocab >= 128k: auto-enabling fused_lm_cross_entropy "
                  "(streams the head matmul + CE over vocab chunks; "
                  "opt out with --no_fused_lm_cross_entropy)", flush=True)
        args.fused_lm_cross_entropy = True
    else:
        args.fused_lm_cross_entropy = False
        if rank0 and vocab >= 131072:
            print(" > NOTE: vocab >= 128k but tensor-parallel vocab "
                  "sharding is active — fused_lm_cross_entropy is inert "
                  "under a sharded vocab (the vocab-parallel CE already "
                  "avoids the full logits); leaving it off", flush=True)
        elif rank0 and vocab >= 65536:
            print(" > NOTE: padded_vocab_size >= 64k — consider "
                  "--fused_lm_cross_entropy", flush=True)


def validate_args(args):
    """The JAX package's derivations for the flags above (one device)."""
    # the reference's recompute spellings
    if args.recompute_activations and args.recompute_granularity is None:
        args.recompute_granularity = "selective"
    if args.recompute_method and args.recompute_granularity in (None,
                                                                "full"):
        args.recompute_granularity = args.recompute_method
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
    apply_fused_ce_policy(args)
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
