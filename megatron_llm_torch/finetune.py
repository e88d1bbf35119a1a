"""Pretrain / finetune GPT-family models in PyTorch on one GPU (the twin of
the repo's ``finetune.py``).

    python -m megatron_llm_torch.finetune --model_name=llama2 \\
        --num_layers=8 --hidden_size=4096 --num_attention_heads=32 \\
        --ffn_hidden_size=11008 --seq_length=4096 --vocab_size=32000 \\
        --bf16 --micro_batch_size=1 --global_batch_size=2 \\
        --train_iters=4 --lr=1e-5 --log_interval=1 \\
        --data_path corpus_text_document --split 98,2,0 \\
        --eval_interval 2 --eval_iters 1 --save ckpt --save_interval 2

Same flags, presets and log lines as the JAX entry point, for the
families the port has: ``--model_name`` llama, llama2, llama3, codellama,
falcon, mistral, qwen2, gemma, gpt_neox, pythia or gpt (mixtral raises: the
mixture of experts is not ported).  ``--data_path`` trains on an mmap
corpus (``tools/preprocess_data.py`` writes one that both packages read):
packed GPT samples, split by ``--split`` into train and valid (evaluated
every ``--eval_interval``), weighted blends, or ``--data_type
instruction``; with no ``--data_path`` it trains on the synthetic data the
JAX entry point makes (random token ids from ``--seed``, labels rolled by
one, a loss mask of ones).  ``--tokenizer_type`` builds the tokenizer,
whose vocabulary sets the padded vocab.  ``--save`` / ``--save_interval``
write checkpoints in the JAX package's layout
(``megatron_llm_torch/checkpointing.py``); ``--load`` resumes the params,
then the optimizer and scheduler state and the data order (not with
``--finetune``), from the tracker's iteration or ``--load_iters``;
``--use_checkpoint_args`` takes the architecture from the checkpoint.
Dropout (``--hidden_dropout``, ``--attention_dropout``, ``--lima_dropout``;
the ``gpt`` preset keeps the parser's 0.1), ``--recompute_granularity``
and the fused LM-head cross entropy train as in the JAX entry point;
``--eval_only`` runs one evaluation and no training.  ``--device cpu``
runs it on the CPU (the tests do); the default is the card.
Parallelism, ``--fp16`` and ``--async_save`` raise
``NotImplementedError``.  ``python -m megatron_llm_torch.pretrain_gpt``
is this entry point with ``--model_name=gpt``.
"""

from __future__ import annotations

import math
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from megatron_llm_torch import checkpointing
from megatron_llm_torch.arguments import parse_args, validate_args
from megatron_llm_torch.config import (
    parallel_config_from_args,
    train_config_from_args,
    transformer_config_from_args,
)
from megatron_llm_torch.models import MODEL_REGISTRY
from megatron_llm_torch.models.language_model import (
    init_language_model_params,
)
from megatron_llm_torch.optimizer import (
    MegatronOptimizer,
    OptimizerParamScheduler,
)
from megatron_llm_torch.tokenizer import build_tokenizer
from megatron_llm_torch.training import build_train_step, pretrain

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


def build_data_iterator(args, num_micro, consumed_samples=0,
                        tokenizer=None, consumed_valid_samples=0,
                        device="cuda"):
    """(train, valid) iterators of global batches, dicts of [num_micro,
    mb, seq] tensors on ``device`` (the JAX entry point's
    ``build_data_iterator``, with ``.to(device)`` for its mesh placement):

    * no ``--data_path``: random token ids from ``--seed`` (numpy, as the
      JAX entry point draws them), labels rolled by one, a loss mask of
      ones; no valid iterator;
    * ``--data_type instruction``: ``InstructionDataset`` and its
      collator (the tokenizer's pad id); no valid iterator;
    * else packed GPT samples of ``--data_path`` (one prefix or a
      weighted blend), split by ``--split``, with a valid iterator over
      the valid split.

    ``consumed_samples`` (from the checkpoint) skips the samples a
    resumed run has already trained on, and ``consumed_valid_samples``
    those its evaluations have read (the reference derives them from the
    iteration).  The valid split holds
    ``(train_iters // eval_interval + 1) * eval_iters`` global batches,
    the reference's count, so that every evaluation of the run gets
    fresh batches (the JAX entry point sizes it for one evaluation)."""
    from megatron_llm_torch.data.data_samplers import (
        build_pretraining_data_loader,
    )

    total_dp = args.data_parallel_size
    if args.data_path is None:
        rng = np.random.RandomState(args.seed)
        mb = args.micro_batch_size * total_dp

        def synth():
            while True:
                toks = rng.randint(0, args.padded_vocab_size,
                                   (num_micro, mb, args.seq_length)
                                   ).astype(np.int32)
                yield {
                    "tokens": toks,
                    "labels": np.roll(toks, -1, axis=-1),
                    "loss_mask": np.ones_like(toks, np.float32),
                }

        host_iter, eval_iter = synth(), None
    elif args.data_type == "instruction":
        from megatron_llm_torch.data.instruction_dataset import (
            InstructionDataset,
            build_instruction_collator,
        )

        if tokenizer is None:
            raise ValueError("--data_type instruction pads with the "
                             "tokenizer's pad id: give --tokenizer_type")
        ds = InstructionDataset(
            args.data_path[0],
            num_samples=args.train_iters * args.global_batch_size,
            seed=args.seed,
        )
        collate = build_instruction_collator(
            args.seq_length, tokenizer.pad,
            variable_seq_lengths=args.variable_seq_lengths,
            scalar_loss_mask=args.scalar_loss_mask,
        )
        host_iter = iter(build_pretraining_data_loader(
            ds, consumed_samples, args.micro_batch_size, total_dp,
            num_micro, args.dataloader_type, args.seed, collate_fn=collate,
            prefetch=args.num_workers,
        ))
        eval_iter = None
    else:
        from megatron_llm_torch.data.gpt_dataset import (
            build_train_valid_test_datasets,
        )

        n_train = args.train_iters * args.global_batch_size
        n_evals = args.train_iters // max(args.eval_interval, 1) + 1
        n_eval = n_evals * args.eval_iters * args.global_batch_size
        train_ds, valid_ds, _ = build_train_valid_test_datasets(
            args.data_path, args.split,
            [n_train, n_eval, 0],
            args.seq_length, args.seed, args.data_impl,
        )
        host_iter = iter(build_pretraining_data_loader(
            train_ds, consumed_samples, args.micro_batch_size, total_dp,
            num_micro, args.dataloader_type, args.seed,
            prefetch=args.num_workers,
        ))
        eval_iter = (iter(build_pretraining_data_loader(
            valid_ds, consumed_valid_samples, args.micro_batch_size,
            total_dp,
            num_micro, args.dataloader_type, args.seed,
            prefetch=args.num_workers,
        )) if valid_ds is not None else None)

    def place(it):
        if it is None:
            return None

        def gen():
            for b in it:
                yield {k: torch.from_numpy(v).to(device)
                       for k, v in b.items()}
        return gen()

    return place(host_iter), place(eval_iter)


# checkpoint-args field -> CLI args attribute (the JAX entry point's
# _CKPT_ARG_MAP; config_to_args writes the config-field spellings)
_CKPT_ARG_MAP = {
    "num_layers": "num_layers",
    "hidden_size": "hidden_size",
    "ffn_hidden_size": "ffn_hidden_size",
    "num_attention_heads": "num_attention_heads",
    "num_attention_heads_kv": "num_attention_heads_kv",
    "kv_channels": "kv_channels",
    "seq_length": "seq_length",
    "max_position_embeddings": "max_position_embeddings",
    "padded_vocab_size": "padded_vocab_size",
    "position_embedding_type": "position_embedding_type",
    "glu_activation": "glu_activation",
    "tie_embed_logits": "tie_embed_logits",
    "add_bias_linear": "use_bias",
    "use_post_ln": "use_post_ln",
    "parallel_attn": "parallel_attn",
    "parallel_layernorm": "parallel_layernorm",
    "sliding_window_size": "sliding_window_size",
    "layernorm_epsilon": "layernorm_epsilon",
    "rope_theta": "rope_theta",
    "rope_scaling_factor": "rope_scaling_factor",
    "rope_llama3_scaling": "rope_llama3_scaling",
    # qwen2's QKV-only bias changes the param tree
    "add_qkv_bias": "add_qkv_bias",
    # gemma's embedding normalizer changes forward math, not the tree
    "embedding_multiplier": "embedding_multiplier",
    # forward-math fields for the NeoX family
    "rotary_percent": "rotary_percent",
    "gelu_variant": "gelu_variant",
}


def _apply_checkpoint_args(args):
    """--use_checkpoint_args: the architecture recorded in the checkpoint
    overrides the CLI (reference checkpointing.py:520-560).  The JAX
    entry point's MoE fields are left out: the port has no MoE."""
    ckpt_args = checkpointing.load_checkpoint_args(args.load,
                                                   args.load_iters)
    if not ckpt_args:
        print(" > WARNING: --use_checkpoint_args but the checkpoint "
              "records no args", flush=True)
        return
    for src, dst in _CKPT_ARG_MAP.items():
        # no is-not-None filter: a recorded null is a real override
        # (e.g. glu_activation=None must clear a model preset's swiglu,
        # or the restored MLP shapes mismatch the checkpoint)
        if src in ckpt_args:
            setattr(args, dst, ckpt_args[src])
    if ckpt_args.get("normalization") is not None:
        args.use_rms_norm = ckpt_args["normalization"] == "rmsnorm"
    print(" > using architecture args from the checkpoint", flush=True)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Parse the flags, build (or load) the model and train; returns the
    last iteration."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv, extra_args_provider=extra_args)
    _apply_model_defaults(args, argv)
    if args.use_checkpoint_args and args.load:
        _apply_checkpoint_args(args)
        # re-derive what validate_args computed from the CLI architecture
        validate_args(args)
    if args.fp16:
        raise NotImplementedError(
            "--fp16: the kernels take fp32 or bf16; use --bf16")
    if args.async_save:
        raise NotImplementedError(
            "--async_save: background checkpoint writes wait for the "
            "resilience slice")
    tokenizer = None
    if args.tokenizer_type is not None:
        tokenizer = build_tokenizer(args)   # sets args.padded_vocab_size
    if args.padded_vocab_size is None:
        raise SystemExit("need --vocab_size/--padded_vocab_size or a "
                         "tokenizer")
    checkpointing.configure_save(total_limit=args.save_total_limit)
    pc = parallel_config_from_args(args)
    tc = train_config_from_args(args)
    model = model_provider(args)
    num_micro = args.global_batch_size // args.micro_batch_size

    # params: fresh init or checkpoint, held to the model's tree on the
    # meta device (shapes and dtypes, no memory: the JAX entry point's
    # jax.eval_shape template)
    params, opt_state = None, None
    start_iteration = consumed_samples = 0
    if args.load:
        template = init_language_model_params(None, model.cfg,
                                              device="meta")
        params, _, meta = checkpointing.load_checkpoint(
            args.load, finetune=args.finetune, iteration=args.load_iters,
            params_template=template, device=model.device)
        if params is not None:
            start_iteration = meta["iteration"]
            print(f" loaded checkpoint at iteration {start_iteration}",
                  flush=True)
            if not args.finetune:
                # continue the data order where the checkpoint left off
                consumed_samples = int(meta.get("consumed_samples", 0) or 0)
    if params is None:
        params = model.init(args.seed)

    # the evaluations before start_iteration read these valid samples
    # (reference: training.py build_train_valid_test_data_iterators)
    valid_done = (start_iteration // max(args.eval_interval, 1)
                  * args.eval_iters * args.global_batch_size
                  if consumed_samples else 0)
    train_iter, eval_iter = build_data_iterator(
        args, num_micro, consumed_samples=consumed_samples,
        tokenizer=tokenizer, consumed_valid_samples=valid_done,
        device=model.device)
    optimizer = MegatronOptimizer(tc,
                                  params_dtype=model.cfg.params_torch_dtype)
    scheduler = OptimizerParamScheduler(
        max_lr=tc.lr, min_lr=tc.min_lr,
        lr_warmup_steps=tc.lr_warmup_iters,
        lr_decay_steps=tc.lr_decay_iters or max(tc.train_iters, 1),
        lr_decay_style=tc.lr_decay_style,
        start_wd=(tc.start_weight_decay
                  if tc.start_weight_decay is not None else tc.weight_decay),
        end_wd=(tc.end_weight_decay
                if tc.end_weight_decay is not None else tc.weight_decay),
        wd_incr_steps=max(tc.train_iters, 1),
        wd_incr_style=tc.weight_decay_incr_style,
    )
    scheduler.num_steps = start_iteration

    # second phase of a resume: the optimizer and scheduler state, held
    # to the optimizer's own state of the template (meta tensors), from
    # the same iteration as the params
    if args.load and start_iteration and not args.finetune:
        if args.no_load_optim:
            print(" --no_load_optim: fresh optimizer and scheduler state",
                  flush=True)
        else:
            _, opt_state, _ = checkpointing.load_checkpoint(
                args.load, iteration=args.load_iters, load_params=False,
                opt_state_template=optimizer.init(template),
                scheduler=scheduler, device=model.device)
            if opt_state is not None:
                print(" restored optimizer + scheduler state", flush=True)

    saved_at = []

    def save_natural(save_dir, it_, params_, opt_state_, scheduler_,
                     consumed_samples_):
        checkpointing.save_checkpoint(
            save_dir, it_, params_,
            None if args.no_save_optim else opt_state_, scheduler_,
            args=checkpointing.config_to_args(model.cfg),
            consumed_samples=consumed_samples_)
        saved_at.append(it_)

    print(f" > {args.model_name}: {model.num_params(params) / 1e6:.1f}M "
          f"params ({model.cfg.num_layers} layers) on {model.device}, "
          f"{num_micro} micro-batch(es) of {args.micro_batch_size} x "
          f"{args.seq_length} tokens per iteration", flush=True)
    if args.eval_only:
        # no training, one evaluation pass
        if eval_iter is None:
            raise SystemExit("--eval_only requires validation data")
        eval_step = build_train_step(model, optimizer, pc, num_micro,
                                     forward_only=True)
        losses = [float(eval_step(params, next(eval_iter), None))
                  for _ in range(args.eval_iters)]
        print(f" eval_only: validation loss "
              f"{sum(losses) / len(losses):.6E}", flush=True)
        return start_iteration
    params, opt_state, it = pretrain(
        model, params, tc, pc, train_iter,
        optimizer=optimizer,
        scheduler=scheduler,
        save_fn=save_natural,
        log_interval=args.log_interval,
        save_interval=args.save_interval,
        save_dir=args.save,
        eval_iterator=eval_iter,
        eval_interval=args.eval_interval if eval_iter else None,
        eval_iters=args.eval_iters,
        start_iteration=start_iteration,
        consumed_samples=consumed_samples,
        opt_state=opt_state,
        skip_iters=args.skip_iters,
        exit_interval=args.exit_interval,
        exit_duration_in_mins=args.exit_duration_in_mins,
        log_params_norm=args.log_params_norm,
        log_num_zeros_in_grad=args.log_num_zeros_in_grad,
    )
    # the final checkpoint, unless the loop has just written this one
    if args.save and saved_at[-1:] != [it]:
        # each iteration reads one global batch: [num_micro, mb x dp, seq]
        per_iter = num_micro * args.micro_batch_size * args.data_parallel_size
        save_natural(args.save, it, params, opt_state, scheduler,
                     consumed_samples + (it - start_iteration) * per_iter)
        print(f" saved final checkpoint at iteration {it}", flush=True)
    return it


if __name__ == "__main__":
    main()
