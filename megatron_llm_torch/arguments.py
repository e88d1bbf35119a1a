"""Command-line flags of the port's entry points: the JAX package's parser
(``megatron_llm_tpu/arguments.py``) group by group, under the same names,
dests and defaults, and the derivations of its ``validate_args`` that one
device needs.

Every flag of the JAX parser parses here but the few in
``JAX_FLAGS_NOT_HERE``, each with its reason.  The flags divide three
ways:

* flags the port honours (the model, training, checkpoint, data,
  tokenizer and serving flags);
* flags that are implementation details of the reference's CUDA build
  (``_add_compat_noop_args``), accepted and ignored as in the JAX
  package, and reference features the JAX package does not implement
  (``_add_unimplemented_compat_args``), accepted with a warning when one
  is set away from its default (``warn_unimplemented``);
* flags of features the port has not ported yet (the parallel degrees
  but tp, batch-size rampup, JAX's live profiler server, ...): they
  parse, and asking for one raises ``NotImplementedError`` where the
  feature is refused: the parallel sizes in ``ParallelConfig``, the rest
  through ``refuse_unported`` with the entry point's table
  (``UNPORTED_TRAINING``, ``UNPORTED_SERVING``).  The mixture of experts'
  flags (``--num_experts``, ``--moe_*``) are honoured.

``--device`` picks the torch device (``cuda`` unless the caller asks for
``cpu``).  ``validate_args`` derives dp from the world (torchrun's
``WORLD_SIZE``, or the process group's) as the JAX package derives it;
this slice runs worlds of tp ranks only (dp 1).
"""

from __future__ import annotations

import argparse
from typing import Callable, Mapping, Optional, Sequence

# dests of the JAX parser that the port's does not define, and why
JAX_FLAGS_NOT_HERE = {
    "serve_paged_kernel": "the port has no kernel on/off switch: the paged "
                          "path is keyed on the tensor's device alone",
    "serve_prefill_kernel": "as serve_paged_kernel",
}


def build_parser(extra_args_provider: Optional[Callable] = None
                 ) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Megatron-LLM in PyTorch on one GPU", allow_abbrev=False)
    _add_network_size_args(p)
    _add_regularization_args(p)
    _add_training_args(p)
    _add_initialization_args(p)
    _add_learning_rate_args(p)
    _add_checkpointing_args(p)
    _add_mixed_precision_args(p)
    _add_distributed_args(p)
    _add_validation_args(p)
    _add_data_args(p)
    _add_logging_args(p)
    _add_telemetry_args(p)
    _add_inference_args(p)
    _add_resilience_args(p)
    _add_compat_noop_args(p)
    _add_unimplemented_compat_args(p)
    if extra_args_provider is not None:
        p = extra_args_provider(p)
    return p


# ---------------------------------------------------------------------------
# groups
# ---------------------------------------------------------------------------

def _add_network_size_args(parser):
    g = parser.add_argument_group("network size")
    g.add_argument("--num_layers", type=int, default=None)
    # encoder/decoder spellings (num_layers/seq_length fall back to them)
    g.add_argument("--encoder_num_layers", type=int, default=None)
    g.add_argument("--encoder_seq_length", type=int, default=None)
    g.add_argument("--hidden_size", type=int, default=None)
    g.add_argument("--ffn_hidden_size", type=int, default=None)
    g.add_argument("--num_attention_heads", type=int, default=None)
    g.add_argument("--num_attention_heads_kv", type=int, default=None)
    g.add_argument("--kv_channels", type=int, default=None)
    # mixture of experts (models/moe.py)
    g.add_argument("--num_experts", type=int, default=0)
    g.add_argument("--moe_top_k", type=int, default=2)
    g.add_argument("--moe_capacity_factor", type=float, default=1.25)
    g.add_argument("--moe_min_capacity", type=int, default=4)
    g.add_argument("--moe_aux_loss_coeff", type=float, default=1e-2)
    g.add_argument("--moe_z_loss_coeff", type=float, default=0.0)
    g.add_argument("--seq_length", type=int, default=None)
    g.add_argument("--decoder_seq_length", type=int, default=None)
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
    g.add_argument("--init_method_xavier_uniform", action="store_true")
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


def _add_regularization_args(parser):
    g = parser.add_argument_group("regularization")
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


def _add_training_args(parser):
    g = parser.add_argument_group("training")
    g.add_argument("--micro_batch_size", type=int, default=1)
    g.add_argument("--global_batch_size", type=int, default=None)
    g.add_argument("--rampup_batch_size", nargs=3, type=int, default=None)
    g.add_argument("--train_iters", type=int, default=None)
    g.add_argument("--exit_interval", type=int, default=None)
    g.add_argument("--exit_duration_in_mins", type=int, default=None)
    g.add_argument("--exit_signal_handler", action="store_true")
    g.add_argument("--optimizer", default="adam", choices=["adam", "sgd"])
    g.add_argument("--dataloader_type", default="single",
                   choices=["single", "cyclic"])
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
    g.add_argument("--use_flash_attn", action="store_true", default=True)
    g.add_argument("--no_flash_attn", action="store_false",
                   dest="use_flash_attn")
    # None = not given: apply_fused_ce_policy decides from the vocabulary
    g.add_argument("--fused_lm_cross_entropy", action="store_const",
                   const=True, default=None)
    g.add_argument("--no_fused_lm_cross_entropy", action="store_const",
                   const=False, dest="fused_lm_cross_entropy")
    g.add_argument("--fused_ce_chunk_size", type=int, default=8192)


def _add_initialization_args(parser):
    g = parser.add_argument_group("initialization")
    g.add_argument("--seed", type=int, default=1234)
    g.add_argument("--data_parallel_random_init", action="store_true")
    g.add_argument("--init_method_std", type=float, default=0.02)


def _add_learning_rate_args(parser):
    g = parser.add_argument_group("learning rate")
    g.add_argument("--lr", type=float, default=None)
    g.add_argument("--lr_decay_style", default="linear",
                   choices=["constant", "linear", "cosine",
                            "inverse-square-root"])
    g.add_argument("--lr_decay_iters", type=int, default=None)
    g.add_argument("--lr_warmup_fraction", type=float, default=None)
    g.add_argument("--lr_warmup_iters", type=int, default=0)
    g.add_argument("--min_lr", type=float, default=0.0)


def _add_checkpointing_args(parser):
    g = parser.add_argument_group("checkpointing")
    g.add_argument("--save", type=str, default=None)
    g.add_argument("--save_interval", type=int, default=None)
    g.add_argument("--async_save", action="store_true",
                   help="background torch.save writes; the tracker file "
                        "lands only once the data is durable")
    g.add_argument("--load", type=str, default=None)
    g.add_argument("--load_iters", type=int, default=None,
                   help="load this iteration instead of the tracker's latest")
    g.add_argument("--finetune", action="store_true")
    g.add_argument("--use_checkpoint_args", action="store_true")
    # implemented here (the JAX package accepts them with a warning)
    g.add_argument("--no_save_optim", action="store_true")
    g.add_argument("--no_load_optim", action="store_true")


def _add_mixed_precision_args(parser):
    g = parser.add_argument_group("mixed precision")
    g.add_argument("--fp16", action="store_true",
                   help="fp16 parameters and compute (fp32 masters and "
                        "moments), the loss scaled by --loss_scale or "
                        "dynamically from --initial_loss_scale, steps "
                        "whose gradients overflow skipped; the server "
                        "serves fp16 weights and KV pools")
    g.add_argument("--bf16", action="store_true")
    g.add_argument("--loss_scale", type=float, default=None)
    g.add_argument("--initial_loss_scale", type=float, default=2.0 ** 32)
    g.add_argument("--min_loss_scale", type=float, default=1.0)
    g.add_argument("--loss_scale_window", type=int, default=1000)
    g.add_argument("--hysteresis", type=int, default=2)
    g.add_argument("--attention_softmax_in_fp32", action="store_true",
                   default=True)
    g.add_argument("--no_attention_softmax_in_fp32", action="store_false",
                   dest="attention_softmax_in_fp32")


def _add_distributed_args(parser):
    # tp runs over torch.distributed (topology.py); the other sizes above
    # 1 raise in ParallelConfig; --sequence_parallel is off at tp 1
    # (validate_args)
    g = parser.add_argument_group("distributed")
    g.add_argument("--tensor_model_parallel_size", type=int, default=1)
    g.add_argument("--pipeline_model_parallel_size", type=int, default=1)
    g.add_argument("--num_layers_per_virtual_pipeline_stage", type=int,
                   default=None)
    g.add_argument("--sequence_parallel", action="store_true")
    g.add_argument("--context_parallel_size", type=int, default=1)
    g.add_argument("--context_parallel_algo", default="ring",
                   choices=["ring", "ulysses", "zigzag"])
    g.add_argument("--use_distributed_optimizer", action="store_true")
    g.add_argument("--expert_model_parallel_size", type=int, default=1)
    g.add_argument("--num_slices", type=int, default=1)
    g.add_argument("--multislice_flat_reduce", action="store_true")
    g.add_argument("--preempt_exit_code", type=int, default=None)
    g.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device to run on ('cpu' for tests)")


def _add_validation_args(parser):
    g = parser.add_argument_group("validation")
    g.add_argument("--eval_iters", type=int, default=100)
    g.add_argument("--eval_interval", type=int, default=1000)


def _add_data_args(parser):
    g = parser.add_argument_group("data")
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


def _add_logging_args(parser):
    g = parser.add_argument_group("logging")
    g.add_argument("--log_interval", type=int, default=100)
    g.add_argument("--log_timers_to_tensorboard", action="store_true")
    g.add_argument("--timing_log_level", type=int, default=2,
                   choices=[0, 1, 2])
    g.add_argument("--timing_log_option", default="minmax",
                   choices=["max", "minmax", "all"])
    g.add_argument("--log_params_norm", action="store_true")
    g.add_argument("--log_num_zeros_in_grad", action="store_true")
    g.add_argument("--log_layer_stats_interval", type=int, default=0)
    g.add_argument("--log_batch_size_to_tensorboard", action="store_true")
    g.add_argument("--log_memory_to_tensorboard", action="store_true")
    g.add_argument("--log_world_size_to_tensorboard", action="store_true")
    g.add_argument("--log_validation_ppl_to_tensorboard",
                   action="store_true")
    g.add_argument("--tensorboard_log_interval", type=int, default=1)
    g.add_argument("--wandb_resume", action="store_true")
    g.add_argument("--tensorboard_dir", type=str, default=None)
    g.add_argument("--wandb_logger", action="store_true")
    g.add_argument("--wandb_project", type=str, default=None)
    g.add_argument("--wandb_entity", type=str, default=None)
    g.add_argument("--wandb_name", type=str, default=None)
    g.add_argument("--wandb_id", type=str, default=None)
    g.add_argument("--wandb_api_key", type=str, default=None)


def _add_telemetry_args(parser):
    g = parser.add_argument_group("telemetry")
    g.add_argument("--structured_log_dir", type=str, default=None,
                   help="the server's JSONL stream (request_done records)")
    g.add_argument("--flight_recorder_size", type=int, default=64)
    g.add_argument("--status_port", type=int, default=None)
    g.add_argument("--profile", action="store_true")
    g.add_argument("--profile_step_start", type=int, default=10)
    g.add_argument("--profile_step_end", type=int, default=12)
    g.add_argument("--profile_dir", type=str, default=None)
    g.add_argument("--profiler_port", type=int, default=None)
    g.add_argument("--trace_dir", type=str, default=None,
                   help="the server's span trace (Chrome trace_event JSON)")
    g.add_argument("--trace_buffer_size", type=int, default=100000)
    g.add_argument("--straggler_threshold", type=float, default=1.5)


def _add_inference_args(parser):
    g = parser.add_argument_group("inference")
    g.add_argument("--serve_max_prompts", type=int, default=128)
    g.add_argument("--serve_max_tokens", type=int, default=1024)
    g.add_argument("--log_requests", action="store_true")
    g.add_argument("--serve_engine", action="store_true",
                   help="serve through the continuous-batching engine "
                        "(beam search, logprobs and tokens_to_generate=0 "
                        "still take the legacy path); without it every "
                        "request takes the legacy generate path")
    g.add_argument("--serve_num_slots", type=int, default=8)
    g.add_argument("--serve_block_size", type=int, default=16)
    g.add_argument("--serve_num_blocks", type=int, default=0)
    g.add_argument("--serve_prefill_chunk", type=int, default=64)
    g.add_argument("--serve_max_queue_depth", type=int, default=64)
    g.add_argument("--serve_deadline_secs", type=float, default=120.0)
    g.add_argument("--serve_max_model_len", type=int, default=0)
    # speculative decoding, the host KV tier and the engine's resilience
    # (serving/engine.py, host_cache.py, resilience.py)
    g.add_argument("--serve_speculative", type=int, default=0)
    g.add_argument("--serve_draft_k", type=int, default=4)
    g.add_argument("--serve_prefix_cache", type=int, default=1)
    g.add_argument("--serve_host_cache_bytes", type=int, default=0)
    g.add_argument("--serve_watchdog_secs", type=float, default=0.0)
    g.add_argument("--serve_preemption", type=int, default=1)
    g.add_argument("--serve_restart_backoff_secs", type=float, default=0.5)
    g.add_argument("--serve_fault_inject", type=str, default="")
    # the SLO sentinel (serving/alerts.py), on by default as in the JAX
    # package
    g.add_argument("--serve_alerts", type=int, default=1)
    g.add_argument("--alert_rules", type=str, default=None)
    g.add_argument("--alert_webhook", type=str, default=None)


def _add_resilience_args(parser):
    g = parser.add_argument_group("resilience")
    g.add_argument("--rewind_on_spike", action="store_true")
    g.add_argument("--spike_factor", type=float, default=3.0)
    g.add_argument("--spike_ema_beta", type=float, default=0.98)
    g.add_argument("--rewind_patience", type=int, default=1)
    g.add_argument("--snapshot_interval", type=int, default=50)
    g.add_argument("--resilience_check_interval", type=int, default=0)
    g.add_argument("--rewind_lr_factor", type=float, default=1.0)
    g.add_argument("--max_rewinds", type=int, default=8)
    g.add_argument("--watchdog_timeout_secs", type=float, default=None)
    g.add_argument("--watchdog_no_hard_exit", action="store_true")
    g.add_argument("--save_total_limit", type=int, default=0,
                   help="keep only the newest N iter_* checkpoints "
                        "(0 = keep all)")
    g.add_argument("--save_retries", type=int, default=2,
                   help="retry a failed checkpoint save this many times "
                        "(exponential backoff)")
    g.add_argument("--save_retry_backoff", type=float, default=0.25,
                   help="initial save-retry backoff in seconds (doubles "
                        "per attempt)")
    g.add_argument("--fault_inject", type=str, default=None)


def _add_compat_noop_args(parser):
    """Reference flags that are implementation details of its CUDA build
    (fusions, DDP, fp8, ...): accepted and ignored, as the JAX package
    does, so that reference launch scripts run unchanged."""
    g = parser.add_argument_group("compat (ignored)")
    g.add_argument("--masked_softmax_fusion", action="store_true")
    g.add_argument("--no_masked_softmax_fusion", action="store_false",
                   dest="masked_softmax_fusion")
    g.add_argument("--bias_gelu_fusion", action="store_true")
    g.add_argument("--no_bias_gelu_fusion", action="store_false",
                   dest="bias_gelu_fusion")
    g.add_argument("--bias_dropout_fusion", action="store_true")
    g.add_argument("--no_bias_dropout_fusion", action="store_false",
                   dest="bias_dropout_fusion")
    g.add_argument("--gradient_accumulation_fusion", action="store_true")
    g.add_argument("--DDP_impl", default="local", choices=["local", "torch"])
    g.add_argument("--use_ring_exchange_p2p", action="store_true")
    g.add_argument("--empty_unused_memory_level", type=int, default=0)
    g.add_argument("--transformer_impl", default="local")
    g.add_argument("--fp8_e4m3", action="store_true")
    g.add_argument("--fp8_hybrid", action="store_true")
    g.add_argument("--fp8_margin", type=int, default=0)
    g.add_argument("--fp8_interval", type=int, default=1)
    g.add_argument("--fp8_amax_history_len", type=int, default=1)
    g.add_argument("--fp8_amax_compute_algo", default="most_recent")
    g.add_argument("--no_fp8_wgrad", action="store_false", dest="fp8_wgrad")
    g.add_argument("--barrier_with_L1_time", action="store_true",
                   default=True)
    g.add_argument("--no_async_tensor_model_parallel_allreduce",
                   action="store_true")
    g.add_argument("--no_contiguous_buffers_in_local_ddp",
                   action="store_false",
                   dest="use_contiguous_buffers_in_local_ddp")
    g.add_argument("--no_gradient_accumulation_fusion",
                   action="store_false", dest="gradient_accumulation_fusion")
    g.add_argument("--no_persist_layer_norm", action="store_true")
    g.add_argument("--no_scatter_gather_tensors_in_pipeline",
                   action="store_true")
    g.add_argument("--distribute_saved_activations", action="store_true")
    g.add_argument("--no_data_sharding", action="store_true")
    g.add_argument("--no_initialization", action="store_false",
                   dest="perform_initialization")
    g.add_argument("--use_cpu_initialization", action="store_true")
    g.add_argument("--standalone_embedding_stage", action="store_true")
    g.add_argument("--pipeline_model_parallel_split_rank", type=int,
                   default=None)
    g.add_argument("--adlr_autoresume", action="store_true")
    g.add_argument("--adlr_autoresume_interval", type=int, default=1000)
    # the residual stream stays in the compute dtype and the cross entropy
    # runs in fp32, as in the JAX package
    g.add_argument("--fp32_residual_connection", action="store_true")
    g.add_argument("--fp16_lm_cross_entropy", action="store_true")
    g.add_argument("--no_query_key_layer_scaling", action="store_true")
    g.add_argument("--onnx_safe", action="store_true")
    g.add_argument("--accumulate_allreduce_grads_in_fp32",
                   action="store_true", default=True)
    g.add_argument("--distributed_backend", default="xla",
                   choices=["xla", "nccl", "gloo"])
    g.add_argument("--local_rank", type=int, default=None)
    g.add_argument("--mmap_warmup", action="store_true")
    g.add_argument("--tensorboard_queue_size", type=int, default=1000)


#: dest -> parser default of every flag in _add_unimplemented_compat_args
#: (the JAX package's table less --no_save_optim and --no_load_optim,
#: which the port implements); warn_unimplemented warns when one is set
#: away from its default
_UNIMPLEMENTED_DEFAULTS = {
    "decoder_num_layers": None,
    "train_samples": None,
    "lr_decay_samples": None,
    "lr_warmup_samples": 0,
    "override_opt_param_scheduler": False,
    "use_checkpoint_opt_param_scheduler": False,
    "no_save_rng": False,
    "no_load_rng": False,
    "metrics": [],
    "train_data_path": None,
    "valid_data_path": None,
    "test_data_path": None,
    "reset_position_ids": False,
    "reset_attention_mask": False,
    "eod_mask_loss": False,
    "inference_batch_times_seqlen_threshold": 512,
    "max_tokens_to_oom": 12000,
}


def _add_unimplemented_compat_args(parser):
    """Reference features the JAX package does not implement either: the
    flags are accepted so that reference launch scripts parse unchanged,
    and setting one away from its default draws a warning
    (``warn_unimplemented``) instead of being silently ignored."""
    g = parser.add_argument_group("unimplemented (accepted with a warning)")
    g.add_argument("--decoder_num_layers", type=int, default=None)
    g.add_argument("--train_samples", type=int, default=None)
    g.add_argument("--lr_decay_samples", type=int, default=None)
    g.add_argument("--lr_warmup_samples", type=int, default=0)
    g.add_argument("--override_opt_param_scheduler", action="store_true")
    g.add_argument("--use_checkpoint_opt_param_scheduler",
                   action="store_true")
    g.add_argument("--no_save_rng", action="store_true")
    g.add_argument("--no_load_rng", action="store_true")
    g.add_argument("--metrics", nargs="*", default=[])
    g.add_argument("--train_data_path", nargs="*", default=None)
    g.add_argument("--valid_data_path", nargs="*", default=None)
    g.add_argument("--test_data_path", nargs="*", default=None)
    g.add_argument("--reset_position_ids", action="store_true")
    g.add_argument("--reset_attention_mask", action="store_true")
    g.add_argument("--eod_mask_loss", action="store_true")
    g.add_argument("--inference_batch_times_seqlen_threshold", type=int,
                   default=512)
    g.add_argument("--max_tokens_to_oom", type=int, default=12000)


# ---------------------------------------------------------------------------
# features the port has not ported yet: dest -> what it asks for
# ---------------------------------------------------------------------------

_UNPORTED_COMMON = {
    "context_parallel_algo": "context parallelism (ROADMAP item 15)",
    "multislice_flat_reduce": "multislice training (ROADMAP item 15)",
    # JAX starts jax.profiler's live-capture server here, for
    # TensorBoard's "capture profile"; PyTorch has no such server, and
    # --profile's window (a torch.profiler Chrome trace) is the port's
    # capture
    "profiler_port": "jax.profiler's live-capture server (no PyTorch "
                     "counterpart; --profile's window is the port's "
                     "capture)",
}

#: the trainer's table: the common one and the loop's missing pieces
UNPORTED_TRAINING = {
    **_UNPORTED_COMMON,
    "rampup_batch_size": "batch-size rampup",
}

#: the server's table: the common one (every serving flag is ported,
#: ``--int8_weights`` and ``--fp16`` included)
UNPORTED_SERVING = dict(_UNPORTED_COMMON)


def refuse_unported(args, table: Mapping[str, str],
                    extra_args_provider: Optional[Callable] = None) -> None:
    """Raise ``NotImplementedError`` for the first flag of ``table`` that
    is set away from its parser default."""
    defaults = build_parser(extra_args_provider)
    for dest, feature in table.items():
        if getattr(args, dest) != defaults.get_default(dest):
            raise NotImplementedError(
                f"--{dest}: {feature} is not ported yet")


def warn_unimplemented(args) -> None:
    """The JAX package's loud accept-and-ignore: unimplemented reference
    features parse (launch scripts carry over) but never silently no-op
    when set."""
    for dest in sorted(_UNIMPLEMENTED_DEFAULTS):
        default = _UNIMPLEMENTED_DEFAULTS[dest]
        if getattr(args, dest, default) != default:
            print(f" > WARNING: --{dest} is accepted for launch-script "
                  f"compatibility but NOT implemented on this stack — "
                  f"ignoring it", flush=True)


# ---------------------------------------------------------------------------
# validation / derivation
# ---------------------------------------------------------------------------

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


def _world_size() -> int:
    """torchrun's ``WORLD_SIZE``, else the process group's, else 1."""
    import os

    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def validate_args(args, world_size: Optional[int] = None):
    """The JAX package's derivations.  ``world_size`` defaults to the
    launcher's (``_world_size``); dp is world // (tp x pp x cp)."""
    warn_unimplemented(args)
    # encoder spellings fall back onto the canonical names
    if args.num_layers is None and args.encoder_num_layers is not None:
        args.num_layers = args.encoder_num_layers
    if args.encoder_num_layers is None:
        args.encoder_num_layers = args.num_layers
    if args.seq_length is None and args.encoder_seq_length is not None:
        args.seq_length = args.encoder_seq_length
    if args.encoder_seq_length is None:
        args.encoder_seq_length = args.seq_length
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
    # the parallel features this slice lacks raise by name before the
    # world is asked to hold them
    from megatron_llm_torch.config import parallel_config_from_args

    parallel_config_from_args(args)
    if world_size is None:
        world_size = _world_size()
    mp = (args.tensor_model_parallel_size * args.pipeline_model_parallel_size
          * args.context_parallel_size)
    if mp < 1 or world_size % mp:
        raise ValueError(
            f"world size ({world_size}) not divisible by tp "
            f"({args.tensor_model_parallel_size}) x pp "
            f"({args.pipeline_model_parallel_size}) x cp "
            f"({args.context_parallel_size})")
    args.world_size = world_size
    args.data_parallel_size = world_size // mp
    # the exit code after a preemption rescue save (multislice: 17); the
    # port has no multislice run (ParallelConfig refuses num_slices > 1)
    if args.preempt_exit_code is None:
        args.preempt_exit_code = 17 if args.num_slices > 1 else 0
    # the batch math runs on dp (the JAX package's total dp: dp x slices,
    # and the port has one slice)
    if args.global_batch_size is None:
        args.global_batch_size = args.micro_batch_size \
            * args.data_parallel_size
    if args.global_batch_size % (args.micro_batch_size
                                 * args.data_parallel_size):
        raise ValueError(f"global batch ({args.global_batch_size}) not "
                         f"divisible by micro batch "
                         f"({args.micro_batch_size}) x dp "
                         f"({args.data_parallel_size})")
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
    # sequence parallelism needs tp > 1 (reference: arguments.py:329-335)
    if args.sequence_parallel and args.tensor_model_parallel_size == 1:
        args.sequence_parallel = False
    if args.padded_vocab_size is None and args.vocab_size is not None:
        mult = (args.make_vocab_size_divisible_by
                * args.tensor_model_parallel_size)
        args.padded_vocab_size = -(-args.vocab_size // mult) * mult
    # a dropless capacity (factor >= E / top_k: every expert can hold a
    # whole row) is what converted models record; warn when training
    # asks for it, as the JAX package does
    if (args.num_experts or 0) > 1:
        dropless = args.num_experts / max(args.moe_top_k, 1)
        if args.moe_capacity_factor >= dropless:
            print(f" > WARNING: moe_capacity_factor "
                  f"({args.moe_capacity_factor:g}) >= num_experts/top_k "
                  f"({dropless:g}) is a DROPLESS (inference-exact) "
                  f"setting; the expert buffers grow with it at "
                  f"seq_length={args.seq_length}.  For training, "
                  f"--moe_capacity_factor 1.25 (the default) is the usual "
                  f"choice.", flush=True)
    return args


def parse_args(argv: Optional[Sequence[str]] = None,
               extra_args_provider: Optional[Callable] = None):
    args = build_parser(extra_args_provider).parse_args(argv)
    return validate_args(args)
