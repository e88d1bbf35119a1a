"""Pretrain / finetune GPT-family models in PyTorch on one GPU (the twin of
the repo's ``finetune.py``).

    python -m megatron_llm_torch.finetune --model_name=llama2 \\
        --num_layers=8 --hidden_size=4096 --num_attention_heads=32 \\
        --ffn_hidden_size=11008 --seq_length=4096 --vocab_size=32000 \\
        --bf16 --micro_batch_size=1 --global_batch_size=2 \\
        --train_iters=4 --lr=1e-5 --log_interval=1

Same flags, presets and log lines as the JAX entry point, for the
families the port has: ``--model_name`` llama, llama2, llama3, codellama,
falcon, mistral, qwen2, gemma, gpt_neox, pythia or gpt (mixtral raises: the
mixture of experts is not ported), random weights drawn from ``--seed``,
and the synthetic data the JAX
entry point makes when no ``--data_path`` is given (random token ids from
``--seed``, labels rolled by one, a loss mask of ones).  ``--device cpu``
runs it on the CPU (the tests do); the default is the card.  Data
loaders, ``--load``/``--save`` and parallelism are later slices and
raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from megatron_llm_torch.arguments import parse_args
from megatron_llm_torch.config import (
    parallel_config_from_args,
    train_config_from_args,
    transformer_config_from_args,
)
from megatron_llm_torch.models import MODEL_REGISTRY
from megatron_llm_torch.training import pretrain

# the JAX entry point's families; the port has all but mixtral
FAMILIES = ("codellama", "falcon", "gemma", "gpt", "gpt_neox", "llama",
            "llama2", "llama3", "mistral", "mixtral", "pythia", "qwen2")
# the JAX entry point's presets (the root finetune.py's MODEL_DEFAULTS)
MODEL_DEFAULTS = {
    "llama": dict(position_embedding_type="rotary", glu_activation="swiglu",
                  use_rms_norm=True, use_bias=False, tie_embed_logits=False,
                  hidden_dropout=0.0, attention_dropout=0.0),
    "llama2": dict(position_embedding_type="rotary", glu_activation="swiglu",
                   use_rms_norm=True, use_bias=False, tie_embed_logits=False,
                   hidden_dropout=0.0, attention_dropout=0.0),
    "llama3": dict(position_embedding_type="rotary", glu_activation="swiglu",
                   use_rms_norm=True, use_bias=False, tie_embed_logits=False,
                   rope_theta=500000.0,
                   hidden_dropout=0.0, attention_dropout=0.0),
    "codellama": dict(position_embedding_type="rotary",
                      glu_activation="swiglu", use_rms_norm=True,
                      use_bias=False, tie_embed_logits=False, rope_theta=1e6,
                      hidden_dropout=0.0, attention_dropout=0.0),
    "falcon": dict(position_embedding_type="rotary", parallel_attn=True,
                   use_bias=False, hidden_dropout=0.0, attention_dropout=0.0),
    "mistral": dict(position_embedding_type="rotary", glu_activation="swiglu",
                    use_rms_norm=True, use_bias=False, tie_embed_logits=False,
                    sliding_window_size=4096,
                    hidden_dropout=0.0, attention_dropout=0.0),
    "qwen2": dict(position_embedding_type="rotary", glu_activation="swiglu",
                  use_rms_norm=True, use_bias=False, add_qkv_bias=True,
                  tie_embed_logits=False, rope_theta=1e6,
                  hidden_dropout=0.0, attention_dropout=0.0),
    "gemma": dict(position_embedding_type="rotary", glu_activation="geglu",
                  use_rms_norm=True, use_bias=False, layernorm_epsilon=1e-6,
                  hidden_dropout=0.0, attention_dropout=0.0),
    "gpt_neox": dict(position_embedding_type="rotary", use_bias=True,
                     parallel_attn=True, parallel_layernorm=True,
                     rotary_percent=0.25, tie_embed_logits=False,
                     gelu_variant="exact",
                     hidden_dropout=0.0, attention_dropout=0.0),
    "pythia": dict(position_embedding_type="rotary", use_bias=True,
                   parallel_attn=True, parallel_layernorm=True,
                   rotary_percent=0.25, tie_embed_logits=False,
                   gelu_variant="exact",
                   hidden_dropout=0.0, attention_dropout=0.0),
    "gpt": dict(),
}


def extra_args(parser):
    g = parser.add_argument_group("finetune")
    g.add_argument("--model_name", required=True, choices=FAMILIES)
    return parser


_INVERTED_FLAGS = {
    "use_bias": "--no_bias",
    "tie_embed_logits": "--no_tie_embed_logits",
}


def _apply_model_defaults(args, argv):
    """Model presets fill any flag the user didn't pass explicitly."""
    if args.model_name not in MODEL_DEFAULTS:
        raise NotImplementedError(
            f"--model_name {args.model_name} is not ported yet (the port "
            f"trains {', '.join(sorted(MODEL_DEFAULTS))})")
    for k, v in MODEL_DEFAULTS[args.model_name].items():
        flags = [f"--{k}"]
        if k in _INVERTED_FLAGS:
            flags.append(_INVERTED_FLAGS[k])
        explicitly_set = any(
            a == flag or a.startswith(flag + "=")
            for a in argv for flag in flags
        )
        if not explicitly_set:
            setattr(args, k, v)


def model_provider(args):
    if args.model_name == "gemma" and args.embedding_multiplier is None:
        # gemma's sqrt(hidden) embedding scale depends on the parsed
        # hidden size, so the preset table cannot carry it
        args.embedding_multiplier = math.sqrt(args.hidden_size)
    cfg = transformer_config_from_args(args, args.model_name)
    return MODEL_REGISTRY[args.model_name](cfg, device=args.device)


def build_data_iterator(args, num_micro, device="cuda"):
    """The synthetic global-batch iterator, [num_micro, mb, seq] tensors
    on ``device``: random token ids from ``--seed`` (numpy, as the JAX
    entry point draws them), labels rolled by one, a loss mask of ones.
    (The JAX entry point also returns an eval iterator; there is no eval
    data here.)"""
    if args.data_path is not None:
        raise NotImplementedError(
            "--data_path: data loaders are not ported yet; omit it to "
            "train on synthetic data")
    rng = np.random.RandomState(args.seed)
    mb = args.micro_batch_size

    def synth():
        while True:
            toks = rng.randint(0, args.padded_vocab_size,
                               (num_micro, mb, args.seq_length)
                               ).astype(np.int32)
            batch = {
                "tokens": toks,
                "labels": np.roll(toks, -1, axis=-1),
                "loss_mask": np.ones_like(toks, np.float32),
            }
            yield {k: torch.from_numpy(v).to(device)
                   for k, v in batch.items()}

    return synth()


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Parse the flags, build the model and train; returns the last
    iteration."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv, extra_args_provider=extra_args)
    _apply_model_defaults(args, argv)
    for flag, name in (("load", "--load"), ("save", "--save")):
        if getattr(args, flag):
            raise NotImplementedError(
                f"{name}: checkpointing is not ported yet")
    if args.fp16:
        raise NotImplementedError(
            "--fp16: the kernels take fp32 or bf16; use --bf16")
    if args.padded_vocab_size is None:
        raise SystemExit("need --vocab_size/--padded_vocab_size")
    pc = parallel_config_from_args(args)
    tc = train_config_from_args(args)
    model = model_provider(args)
    num_micro = args.global_batch_size // args.micro_batch_size
    params = model.init(args.seed)
    train_iter = build_data_iterator(args, num_micro, device=model.device)
    print(f" > {args.model_name}: {model.num_params(params) / 1e6:.1f}M "
          f"params ({model.cfg.num_layers} layers) on {model.device}, "
          f"{num_micro} micro-batch(es) of {args.micro_batch_size} x "
          f"{args.seq_length} tokens per iteration", flush=True)
    _, _, it = pretrain(
        model, params, tc, pc, train_iter,
        log_interval=args.log_interval,
        skip_iters=args.skip_iters,
        exit_interval=args.exit_interval,
    )
    return it


if __name__ == "__main__":
    main()
