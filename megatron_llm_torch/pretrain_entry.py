"""The run that ``pretrain_bert``, ``pretrain_t5`` and ``pretrain_ict``
share (each of the JAX package's three scripts carries its own copy):
parse the flags with the script's group, build the tokenizer, the
model, the params (fresh from ``--seed`` or ``--load``, with the
optimizer and scheduler state and the data order unless
``--finetune``), then either one ``--eval_only`` pass of ``--eval_iters``
forward-only batches or ``training.pretrain`` with ``--save`` every
``--save_interval`` and at the end, with ``finetune.py``'s telemetry
flags (``--profile`` and its window, ``--structured_log_dir``,
``--status_port``).  Checkpoints are the JAX layout
(``checkpointing.py``).  Runs on the card unless ``--device cpu``."""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from megatron_llm_torch import checkpointing
from megatron_llm_torch.arguments import (
    UNPORTED_TRAINING,
    parse_args,
    refuse_unported,
)
from megatron_llm_torch.config import (
    parallel_config_from_args,
    train_config_from_args,
    transformer_config_from_args,
)
from megatron_llm_torch.global_vars import get_counters
from megatron_llm_torch.optimizer import MegatronOptimizer
from megatron_llm_torch.telemetry import build_telemetry
from megatron_llm_torch.tokenizer import build_tokenizer
from megatron_llm_torch.training import (
    build_scheduler,
    build_train_step,
    pretrain,
)
from megatron_llm_torch.tree import tree_leaves


def parse(argv: Sequence[str], extra_args: Callable):
    """(args, tokenizer or None): the flags, with the refusals of the
    trainer and ``args.padded_vocab_size`` set."""
    args = parse_args(list(argv), extra_args_provider=extra_args)
    refuse_unported(args, UNPORTED_TRAINING, extra_args)
    if args.pipeline_model_parallel_size > 1:
        # the pipeline drives decoder stacks only (the JAX engine's)
        raise NotImplementedError(
            f"BERT, T5 and ICT at pipeline-parallel size "
            f"{args.pipeline_model_parallel_size}: the pipeline drives the "
            f"GPT families' decoder stacks only, as in the JAX package")
    if args.data_parallel_size > 1:
        # their losses are not row-separable (BERT's and T5's token means
        # over the batch, ICT's in-batch negatives)
        raise NotImplementedError(
            f"BERT, T5 and ICT at data-parallel size "
            f"{args.data_parallel_size} are not ported yet (ROADMAP item "
            f"15 (g))")
    tokenizer = build_tokenizer(args) if args.tokenizer_type else None
    if args.padded_vocab_size is None:
        raise SystemExit("need --vocab_size/--padded_vocab_size or a "
                         "tokenizer")
    return args, tokenizer


def base_config(args, arch: dict):
    """The CLI's transformer config with the model's architecture
    flags forced (the JAX scripts' ``bert_config(**fields)``)."""
    return transformer_config_from_args(args).replace(**arch)


def place(host_iter, device):
    """Global batches of numpy arrays -> dicts of tensors on ``device``."""
    for b in host_iter:
        yield {k: torch.from_numpy(np.asarray(v)).to(device)
               for k, v in b.items()}


def run(args, model, build_iterator: Callable, loss_func: Callable,
        label: str) -> int:
    """Train (or evaluate) ``model`` on ``build_iterator(args, num_micro,
    consumed_samples)`` (host batches of [num_micro, mb, ...] arrays);
    returns the last iteration."""
    checkpointing.configure_save(total_limit=args.save_total_limit,
                                 retries=args.save_retries,
                                 retry_backoff=args.save_retry_backoff)
    tc = train_config_from_args(args)
    pc = parallel_config_from_args(args)
    num_micro = args.global_batch_size // args.micro_batch_size
    template = model.template()
    optimizer = MegatronOptimizer(tc,
                                  params_dtype=tree_leaves(template)[0].dtype)
    params = opt_state = None
    start_iteration = consumed = 0
    if args.load:
        params, _, meta = checkpointing.load_checkpoint(
            args.load, finetune=args.finetune, iteration=args.load_iters,
            params_template=template, device=model.device)
        if params is not None:
            start_iteration = meta["iteration"]
            consumed = int(meta.get("consumed_samples", 0) or 0)
            print(f" loaded checkpoint at iteration {start_iteration}",
                  flush=True)
    if params is None:
        params = model.init(args.seed)
    scheduler = build_scheduler(tc, start_iteration)
    if args.load and start_iteration and not args.finetune \
            and not args.no_load_optim:
        _, opt_state, _ = checkpointing.load_checkpoint(
            args.load, iteration=args.load_iters, load_params=False,
            opt_state_template=optimizer.init(template),
            scheduler=scheduler, device=model.device)
    print(f" > {label}: {model.num_params(params) / 1e6:.1f}M params on "
          f"{model.device}, {num_micro} micro-batch(es) of "
          f"{args.micro_batch_size} x {args.seq_length} tokens per "
          f"iteration", flush=True)
    batches = place(build_iterator(args, num_micro, consumed), model.device)
    if args.eval_only:
        step = build_train_step(model, optimizer, pc, num_micro, loss_func,
                                forward_only=True)
        losses = [float(step(params, next(batches), None))
                  for _ in range(args.eval_iters)]
        print(f" eval_only: loss {sum(losses) / len(losses):.6E} over "
              f"{len(losses)} batches", flush=True)
        return start_iteration

    saved_at = []

    def save(save_dir, it, params_, opt_state_, scheduler_, consumed_):
        checkpointing.save_checkpoint(
            save_dir, it, params_,
            None if args.no_save_optim else opt_state_, scheduler_,
            args=checkpointing.config_to_args(model.cfg),
            consumed_samples=consumed_, async_save=args.async_save)
        saved_at.append(it)

    # the JAX loop's telemetry flags (--profile, --structured_log_dir,
    # --status_port) and the throughput of the log line
    telemetry = build_telemetry(args, model)
    try:
        params, opt_state, it = pretrain(
            model, params, tc, pc, batches, optimizer=optimizer,
            scheduler=scheduler, loss_func=loss_func, save_fn=save,
            telemetry=telemetry,
            log_interval=args.log_interval,
            save_interval=args.save_interval, save_dir=args.save,
            start_iteration=start_iteration, consumed_samples=consumed,
            opt_state=opt_state, exit_interval=args.exit_interval,
            async_save=args.async_save)
        if args.save and saved_at[-1:] != [it]:
            save(args.save, it, params, opt_state, scheduler,
                 get_counters()["samples"])
    finally:
        telemetry.close()
        checkpointing.finalize_async_saves()
    return it
