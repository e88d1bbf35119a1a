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
falcon, mistral, mixtral (the mixture of experts, ``models/moe.py``, with
its ``--num_experts`` / ``--moe_*`` flags), qwen2, gemma, gpt_neox,
pythia or gpt.  ``--data_path`` trains on an mmap
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
``--use_checkpoint_args`` takes the architecture from the checkpoint
(its padded vocabulary wins over the tokenizer's).
Dropout (``--hidden_dropout``, ``--attention_dropout``, ``--lima_dropout``;
the ``gpt`` preset keeps the parser's 0.1), ``--recompute_granularity``
and the fused LM-head cross entropy train as in the JAX entry point;
``--eval_only`` runs one evaluation and no training.  ``--lora_rank``
(with ``--lora_alpha`` and ``--lora_targets``) trains LoRA adapters over
the frozen base (``lora.py``); its checkpoints hold the merged
base-format params and no optimizer state, and a LoRA run with
``--load`` needs ``--finetune``.  The JAX entry point's runtime flags
work as there: resilience (``--rewind_on_spike`` and the sentinel
knobs, ``--watchdog_timeout_secs``, ``--fault_inject``), the signal
handler (``--exit_signal_handler``), ``--async_save``, the layer-stats
observatory (``--log_layer_stats_interval``), telemetry
(``--structured_log_dir``, ``--status_port``, ``--profile`` with its
window, ``--flight_recorder_size``), the span tracer (``--trace_dir``,
``--trace_buffer_size``, ``--straggler_threshold``), the timer levels
(``--timing_log_level``, ``--timing_log_option``) and the metrics
writer (``--wandb_logger``, ``--tensorboard_dir`` and the
``--log_*_to_tensorboard`` flags; without ``wandb`` installed it writes
JSONL).  ``--device cpu`` runs it on the CPU (the tests do); the
default is the card.  ``--fp16`` trains fp16 parameters under the loss
scale, as ``--bf16`` trains bf16 ones.

Tensor and data parallelism run under torchrun, one process a rank;
dp is the world over tp::

    python -m torch.distributed.run --standalone --nproc_per_node 4 \
        -m megatron_llm_torch.finetune --model_name=llama2 ... \
        --tensor_model_parallel_size 2 --sequence_parallel \
        --use_distributed_optimizer --save ck --save_interval 2

``initialize.initialize_parallel`` boots the process group from
torchrun's environment (``--distributed_backend``: ``xla``, the default,
is NCCL on the card and gloo on the CPU; ``gloo`` lets ranks share one
GPU) and places each rank on ``cuda:LOCAL_RANK``.  Each rank inits the
one-device params from ``--seed`` and keeps its slices, so a seed gives
the same model at every tp; dp rank r trains on rows ``r * mb ... (r +
1) * mb - 1`` of each global micro batch, and
``--use_distributed_optimizer`` (ZeRO-1) splits the optimizer state
over dp.  ``--save`` / ``--load`` / ``--async_save`` write and read the
one layout a tp-1 run writes (rank 0 writes it; every rank cuts its
pieces from it), so a run resumes at any tp x dp, and the tp-1 server
serves it.  Rank 0 logs and writes the JSONL stream; at the end of the
run every rank prints one line with its param and optimizer-state
bytes, its peak device memory and its kernel launches.  In a world of
more than one rank LoRA raises ``NotImplementedError``, and so do the
mixture of experts at dp > 1 and pipeline and context parallelism at
any size (ROADMAP item 15).
``--profiler_port`` and the flags of the other features the port lacks
(``arguments.UNPORTED_TRAINING``) parse and raise
``NotImplementedError``.  ``python -m megatron_llm_torch.pretrain_gpt``
is this entry point with ``--model_name=gpt``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from megatron_llm_torch import checkpointing, topology
from megatron_llm_torch.arguments import (
    UNPORTED_TRAINING,
    parse_args,
    refuse_unported,
    validate_args,
)
from megatron_llm_torch.config import (
    parallel_config_from_args,
    train_config_from_args,
    transformer_config_from_args,
)
from megatron_llm_torch.dist_signal_handler import DistributedSignalHandler
from megatron_llm_torch.global_vars import get_counters
from megatron_llm_torch.initialize import initialize_parallel
from megatron_llm_torch.lora import LoraAdapter, merge_lora
from megatron_llm_torch.models import MODEL_REGISTRY
from megatron_llm_torch.models.language_model import (
    init_language_model_params,
)
from megatron_llm_torch.optimizer import MegatronOptimizer
from megatron_llm_torch.parallel import mappings
from megatron_llm_torch.parallel.sharding import plan_for
from megatron_llm_torch.resilience import build_resilience
from megatron_llm_torch.telemetry import build_telemetry
from megatron_llm_torch.timers import Timers
from megatron_llm_torch.tokenizer import build_tokenizer
from megatron_llm_torch.training import (
    build_scheduler,
    build_train_step,
    default_loss_func,
    kernel_launches,
    pretrain,
    refuse_at_dp,
)
from megatron_llm_torch.tree import tree_leaves
from megatron_llm_torch.wandb_logger import WandbTBShim

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
    # sparse-MoE mistral
    "mixtral": dict(position_embedding_type="rotary", glu_activation="swiglu",
                    use_rms_norm=True, use_bias=False, tie_embed_logits=False,
                    num_experts=8, moe_top_k=2, rope_theta=1e6,
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
    g.add_argument("--model_name", required=True,
                   choices=sorted(MODEL_DEFAULTS))
    g.add_argument("--model_type", default=None)  # compat
    # LoRA (lora.py): low-rank adapters over a frozen base; checkpoints
    # are saved merged (the base format)
    g.add_argument("--lora_rank", type=int, default=0,
                   help="enable LoRA with this rank (0 = off)")
    g.add_argument("--lora_alpha", type=float, default=None,
                   help="LoRA scaling numerator (default 2*rank)")
    g.add_argument("--lora_targets", default="query_key_value,dense",
                   help="comma-separated linear names to adapt")
    return parser


_INVERTED_FLAGS = {
    "use_bias": "--no_bias",
    "tie_embed_logits": "--no_tie_embed_logits",
}


def _apply_model_defaults(args, argv):
    """Model presets fill any flag the user didn't pass explicitly."""
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
    """(train, valid) iterators of this dp rank's rows of the global
    batches, dicts of [num_micro, mb, seq] tensors on ``device`` (the JAX
    entry point's ``build_data_iterator``, with ``data_samplers.dp_rows``
    and ``.to(device)`` for its mesh placement):

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
        dp_rows,
    )

    total_dp = args.data_parallel_size
    dp_rank = topology.get_data_parallel_rank()
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
                b = dp_rows(b, dp_rank, total_dp)
                yield {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                    device) for k, v in b.items()}
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
    # MoE architecture fields: a dense rebuild of an MoE checkpoint (or
    # the reverse) would not fit its param tree
    "num_experts": "num_experts",
    "moe_top_k": "moe_top_k",
    "moe_capacity_factor": "moe_capacity_factor",
    "moe_min_capacity": "moe_min_capacity",
    # qwen2's QKV-only bias changes the param tree
    "add_qkv_bias": "add_qkv_bias",
    # gemma's embedding normalizer changes forward math, not the tree
    "embedding_multiplier": "embedding_multiplier",
    # forward-math fields for the NeoX family
    "rotary_percent": "rotary_percent",
    "gelu_variant": "gelu_variant",
}


def checkpoint_architecture(load: str, load_iters=None) -> dict:
    """{CLI args attribute: value} of the architecture recorded in the
    checkpoint (reference checkpointing.py:520-560), or {} when it
    records none."""
    ckpt_args = checkpointing.load_checkpoint_args(load, load_iters)
    if not ckpt_args:
        print(" > WARNING: --use_checkpoint_args but the checkpoint "
              "records no args", flush=True)
        return {}
    # no is-not-None filter: a recorded null is a real override (e.g.
    # glu_activation=None must clear a model preset's swiglu, or the
    # restored MLP shapes mismatch the checkpoint)
    arch = {dst: ckpt_args[src] for src, dst in _CKPT_ARG_MAP.items()
            if src in ckpt_args}
    if ckpt_args.get("normalization") is not None:
        arch["use_rms_norm"] = ckpt_args["normalization"] == "rmsnorm"
    return arch


def _apply_checkpoint_args(args) -> dict:
    """--use_checkpoint_args: the architecture recorded in the checkpoint
    overrides the CLI; returns what it set."""
    arch = checkpoint_architecture(args.load, args.load_iters)
    for dst, value in arch.items():
        setattr(args, dst, value)
    if arch:
        print(" > using architecture args from the checkpoint", flush=True)
    return arch


# flags of features this slice runs in a world of one only (ROADMAP item
# 15 (f))
_ONE_DEVICE_ONLY = {
    "lora_rank": "LoRA (--lora_rank)",
}

# the outputs only rank 0 writes
_RANK_0_OUTPUTS = ("structured_log_dir", "tensorboard_dir", "trace_dir",
                   "status_port")


def _refuse_at_tp(args) -> None:
    sizes = [(f"tensor-parallel size {args.tensor_model_parallel_size}",
              args.tensor_model_parallel_size),
             (f"data-parallel size {args.data_parallel_size}",
              args.data_parallel_size)]
    for where, size in sizes:
        if size > 1:
            for dest, feature in _ONE_DEVICE_ONLY.items():
                if getattr(args, dest):
                    raise NotImplementedError(
                        f"{feature} at {where} is not ported yet (ROADMAP "
                        f"item 15 (f))")


def _global_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if topology.is_distributed() else 0


def rank_summary(params, opt_state=None) -> dict:
    """This rank's param and optimizer-state bytes, its peak device
    memory and its kernel launches (what the end-of-run line prints)."""
    ps = tree_leaves(params)
    dev = ps[0].device
    state = [] if opt_state is None else [
        t for tree in (opt_state.master_params, opt_state.exp_avg,
                       opt_state.exp_avg_sq) if tree is not None
        for t in tree_leaves(tree)]
    return {
        "rank": _global_rank(),
        "tp_rank": topology.get_tensor_model_parallel_rank(),
        "tp": topology.get_tensor_model_parallel_world_size(),
        "dp_rank": topology.get_data_parallel_rank(),
        "dp": topology.get_data_parallel_world_size(),
        "param_bytes": sum(p.numel() * p.element_size() for p in ps),
        "param_elements": sum(p.numel() for p in ps),
        "opt_state_bytes": sum(t.numel() * t.element_size()
                               for t in state),
        "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
        "kernel_launches": kernel_launches(),
        # the tp collectives by (backend, device, op)
        "collectives": {"/".join(k): n for k, n in mappings.calls.items()},
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Parse the flags, boot the tp ranks (under torchrun), build (or
    load) the model and train; returns the last iteration."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv, extra_args_provider=extra_args)
    _apply_model_defaults(args, argv)
    refuse_unported(args, UNPORTED_TRAINING, extra_args)
    _refuse_at_tp(args)
    initialize_parallel(args)
    if not topology.is_rank_0():
        for dest in _RANK_0_OUTPUTS:
            setattr(args, dest, None)
        args.wandb_logger = args.profile = False
    if args.lora_rank and args.load and not args.finetune:
        raise SystemExit(
            "--lora_rank with --load requires --finetune: LoRA runs start "
            "fresh from base weights (checkpoints are saved merged; there "
            "is no LoRA-shaped optimizer state to resume)")
    arch = {}
    if args.use_checkpoint_args and args.load:
        arch = _apply_checkpoint_args(args)
        # re-derive what validate_args computed from the CLI architecture
        validate_args(args)
    tokenizer = None
    if args.tokenizer_type is not None:
        tokenizer = build_tokenizer(args)   # sets args.padded_vocab_size
        if "padded_vocab_size" in arch:
            # the checkpoint's architecture wins over the tokenizer's pad
            args.padded_vocab_size = arch["padded_vocab_size"]
    if args.padded_vocab_size is None:
        raise SystemExit("need --vocab_size/--padded_vocab_size or a "
                         "tokenizer")
    checkpointing.configure_save(total_limit=args.save_total_limit,
                                 retries=args.save_retries,
                                 retry_backoff=args.save_retry_backoff)
    pc = parallel_config_from_args(args)
    tc = train_config_from_args(args)
    model = model_provider(args)
    # the features this slice does not split over dp raise before any
    # collective
    refuse_at_dp(model.cfg, default_loss_func)
    num_micro = args.global_batch_size // (args.micro_batch_size
                                           * args.data_parallel_size)
    resilience = build_resilience(args)
    # built before the checkpoint load so the startup restore lands in
    # the trace (--trace_dir opens a checkpoint_load span)
    telemetry = build_telemetry(args, model)
    summary = {}
    try:
        # ranks but 0 run without a console; each prints its summary
        with contextlib.ExitStack() as quiet:
            if not topology.is_rank_0():
                quiet.enter_context(contextlib.redirect_stdout(
                    quiet.enter_context(open(os.devnull, "w"))))
            it = _train(args, model, pc, tc, num_micro, tokenizer, arch,
                        resilience, telemetry, summary)
        if topology.is_distributed():
            print(f" > rank summary: {json.dumps(summary)}", flush=True)
        return it
    finally:
        # stop the watchdog thread and uninstall the fault hook on every
        # exit path (a signal save exits through SystemExit), then close
        # the telemetry (a crash path above may still dump the flight
        # recorder through the installed stream)
        if resilience is not None:
            resilience.close()
        telemetry.close()
        # flush a final --async_save on every exit path
        checkpointing.finalize_async_saves()


def _train(args, model, pc, tc, num_micro, tokenizer, arch, resilience,
           telemetry, summary) -> int:
    """``main`` after the model, resilience and telemetry exist."""

    # params: fresh init or checkpoint, held to the model's tree on the
    # meta device (shapes and dtypes, no memory: the JAX entry point's
    # jax.eval_shape template)
    params, opt_state = None, None
    start_iteration = consumed_samples = 0
    template = init_language_model_params(None, model.cfg, device="meta")
    # at tp x dp: the step's plan, which cuts a load and gathers a save
    plan = plan_for(template, model.cfg, args.sequence_parallel,
                    args.use_distributed_optimizer)
    if args.load:
        params, _, meta = checkpointing.load_checkpoint(
            args.load, finetune=args.finetune, iteration=args.load_iters,
            params_template=template, device=model.device, plan=plan)
        if params is not None:
            start_iteration = meta["iteration"]
            print(f" loaded checkpoint at iteration {start_iteration}",
                  flush=True)
            if not args.finetune:
                # continue the data order where the checkpoint left off
                consumed_samples = int(meta.get("consumed_samples", 0) or 0)
    if params is None:
        params = model.init(args.seed)

    # LoRA: the trained tree becomes the adapters over the frozen base
    lora_base = None
    if args.lora_rank:
        lora_base = params
        model = LoraAdapter(model, lora_base)
        params = model.init_lora(
            args.lora_rank, args.seed + 1, alpha=args.lora_alpha,
            targets=tuple(t for t in args.lora_targets.split(",") if t))
        print(f" > LoRA rank {args.lora_rank}: "
              f"{model.num_params(params) / 1e6:.2f}M adapter params "
              f"trainable, base frozen", flush=True)

    # the evaluations before start_iteration read these valid samples
    # (reference: training.py build_train_valid_test_data_iterators)
    valid_done = (start_iteration // max(args.eval_interval, 1)
                  * args.eval_iters * args.global_batch_size
                  if consumed_samples else 0)
    train_iter, eval_iter = build_data_iterator(
        args, num_micro, consumed_samples=consumed_samples,
        tokenizer=tokenizer, consumed_valid_samples=valid_done,
        device=model.device)
    # the first leaf's dtype: the params' own, or the adapters'
    optimizer = MegatronOptimizer(tc,
                                  params_dtype=tree_leaves(params)[0].dtype)
    scheduler = build_scheduler(tc, start_iteration)

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
                scheduler=scheduler, device=model.device, plan=plan)
            if opt_state is not None:
                print(" restored optimizer + scheduler state", flush=True)

    saved_at = []

    def save_natural(save_dir, it_, params_, opt_state_, scheduler_,
                     consumed_samples_):
        if lora_base is not None:
            # the merged params in the base format, which loads wherever
            # a base checkpoint does; the adapters' optimizer state does
            # not fit that tree, so none is saved
            params_, opt_state_ = merge_lora(lora_base, params_), None
        checkpointing.save_checkpoint(
            save_dir, it_, params_,
            None if args.no_save_optim else opt_state_, scheduler_,
            args=checkpointing.config_to_args(model.cfg),
            consumed_samples=consumed_samples_,
            async_save=args.async_save, plan=plan)
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
    handler = DistributedSignalHandler() if args.exit_signal_handler \
        else None
    if handler:
        handler.install()
    # metrics writer: wandb (or its JSONL offline fallback) and/or a
    # tensorboard-dir JSONL stream — one add_scalar code path either way
    writer = None
    if args.wandb_logger or args.tensorboard_dir:
        fallback = (os.path.join(args.tensorboard_dir, "metrics.jsonl")
                    if args.tensorboard_dir else "wandb_offline.jsonl")
        if args.tensorboard_dir:
            os.makedirs(args.tensorboard_dir, exist_ok=True)
        writer = WandbTBShim(
            config=checkpointing.config_to_args(model.cfg),
            project=args.wandb_project, entity=args.wandb_entity,
            name=args.wandb_name, run_id=args.wandb_id,
            api_key=args.wandb_api_key, fallback_path=fallback,
            resume="must" if args.wandb_resume else "allow",
            force_offline=not args.wandb_logger)
    try:
        params, opt_state, it = pretrain(
            model, params, tc, pc, train_iter,
            optimizer=optimizer,
            scheduler=scheduler,
            save_fn=save_natural,
            resilience=resilience,
            telemetry=telemetry,
            timers=Timers(log_level=args.timing_log_level,
                          log_option=args.timing_log_option),
            log_interval=args.log_interval,
            save_interval=args.save_interval,
            save_dir=args.save,
            eval_iterator=eval_iter,
            eval_interval=args.eval_interval if eval_iter else None,
            eval_iters=args.eval_iters,
            exit_signal_handler=handler,
            start_iteration=start_iteration,
            consumed_samples=consumed_samples,
            opt_state=opt_state,
            skip_iters=args.skip_iters,
            exit_interval=args.exit_interval,
            exit_duration_in_mins=args.exit_duration_in_mins,
            log_params_norm=args.log_params_norm,
            log_num_zeros_in_grad=args.log_num_zeros_in_grad,
            log_layer_stats_interval=args.log_layer_stats_interval,
            writer=writer,
            tensorboard_log_interval=args.tensorboard_log_interval,
            log_timers=args.log_timers_to_tensorboard,
            log_memory=args.log_memory_to_tensorboard,
            log_batch_size=args.log_batch_size_to_tensorboard,
            log_world_size=args.log_world_size_to_tensorboard,
            log_validation_ppl=args.log_validation_ppl_to_tensorboard,
            async_save=args.async_save,
            preempt_exit_code=args.preempt_exit_code or 0,
        )
    finally:
        if writer is not None:
            # the recovery and telemetry summaries, while the stream is
            # still installed
            writer.finish()
        if handler:
            handler.__exit__(None, None, None)
    summary.update(rank_summary(params, opt_state))
    # the final checkpoint, unless the loop has just written this one
    if args.save and saved_at[-1:] != [it]:
        # the samples the loop drew, rewound iterations' batches included
        save_natural(args.save, it, params, opt_state, scheduler,
                     get_counters()["samples"])
        print(f" saved final checkpoint at iteration {it}", flush=True)
    return it


if __name__ == "__main__":
    main()
