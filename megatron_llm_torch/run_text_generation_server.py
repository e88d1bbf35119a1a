"""Serve a GPT-family model over REST, in PyTorch on one GPU (the twin of
``tools/run_text_generation_server.py``).

    python -m megatron_llm_torch.run_text_generation_server \\
        --model_name llama2 --bf16 --load ckpt \\
        --tokenizer_type GPT2BPETokenizer --vocab_file vocab.json \\
        --merge_file merges.txt --serve_engine --port 5000

As in the JAX tool, ``--serve_engine`` serves requests through the
continuous-batching engine (beam search, logprobs and
``tokens_to_generate == 0`` still take the legacy path); without it every
request takes the legacy path, one ``generate`` call at a time.

The flags are the shared parser's (``arguments.build_parser``) plus the
server group (``extra_args``), as the JAX tool parses them through
``initialize_megatron``, so the reference launch scripts' training flags
(``--micro_batch_size``, ``--train_iters``, ``--lr``, ...) parse too.
With no size flags the model is the family's 7B-class size (Llama-2-7B,
Llama-3-8B, Falcon-7B, Mixtral-8x7B, ...: see ``FAMILIES``; the MoE
flags ``--num_experts`` and ``--moe_*`` are size flags too), its
vocabulary padded from
the tokenizer's (``build_tokenizer``).  ``--load`` serves a checkpoint of
the port's trainer or converters (its params only, from the tracker's
iteration or ``--load_iters``, held to the model's tree), as the JAX
server does; ``--use_checkpoint_args`` takes the architecture the
checkpoint records (``finetune.checkpoint_architecture``), which wins over
the size flags and the tokenizer's padded vocabulary.  With no ``--load``
it serves random weights drawn from ``--seed``.  ``--int8_weights`` stores
the linear kernels and expert banks as int8 with per-channel scales
(``quantization.py``), quantised after the load and printed as ``int8
weights: <q> MB int8 + <f> MB float``.  ``--int8_kv_cache`` keeps the KV
cache (the engine's paged pool or the legacy path's linear cache) as int8
with per-position scales.  The engine flags are the
JAX server's: ``--serve_speculative`` / ``--serve_draft_k`` (speculative
decoding), ``--serve_host_cache_bytes`` (the host KV tier),
``--serve_watchdog_secs``, ``--serve_restart_backoff_secs`` and
``--serve_fault_inject`` (the engine's resilience); ``--serve_alerts``
(on by default), ``--alert_rules`` and ``--alert_webhook`` run the SLO
sentinel, with its transitions on the ``--structured_log_dir`` stream and
its incident bundles under ``<structured_log_dir>/incidents``.  SIGTERM,
or ``PUT /drain``, drains the server and ``main()`` returns.  With
``--port 0`` the server binds a free port and writes ``PORT <n>`` on
stdout, the handshake of ``megatron_llm_torch.tools.serve_fleet``'s
replicas.  ``build_server(args, tokenizer)`` builds the model, the engine
(with ``--serve_engine``) and the server in-process (the port's tests and
``chip_smoke.py`` call it);
``main()`` parses the flags, builds the tokenizer and serves.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from megatron_llm_torch import arguments, checkpointing, telemetry, tracing
from megatron_llm_torch.arguments import (
    UNPORTED_SERVING,
    refuse_unported,
    warn_unimplemented,
)
from megatron_llm_torch.finetune import checkpoint_architecture
from megatron_llm_torch.models import (
    MODEL_REGISTRY,
    falcon_config,
    gemma_config,
    gpt2_config,
    gpt_neox_config,
    llama_config,
    mistral_config,
    mixtral_config,
    qwen2_config,
)
from megatron_llm_torch.models.language_model import (
    init_language_model_params,
)
from megatron_llm_torch.quantization import (
    quantize_linear_weights_int8,
    quantized_weight_bytes,
)
from megatron_llm_torch.serving import EngineConfig, InferenceEngine
from megatron_llm_torch.text_generation_server import (
    MegatronServer,
    build_server_alerts,
)
from megatron_llm_torch.tokenizer import build_tokenizer

# family -> (its config table, the size served with no size flags, and
# what the JAX package's finetune.MODEL_DEFAULTS adds to that size)
FAMILIES = {
    "llama": (llama_config, "7B", {}),
    "llama2": (llama_config, "7B", {}),
    "codellama": (llama_config, "7B", {"rope_theta": 1e6}),
    "llama3": (llama_config, "llama3-8B", {}),
    "mistral": (mistral_config, "7B", {}),
    "mixtral": (mixtral_config, "8x7B", {}),
    "falcon": (falcon_config, "7B", {}),
    "qwen2": (qwen2_config, "7B", {}),
    "gemma": (gemma_config, "7B", {}),
    "gpt_neox": (gpt_neox_config, "6.9b", {}),
    "pythia": (gpt_neox_config, "6.9b", {}),
    # served, so no dropout
    "gpt": (gpt2_config, "1.3B", {"hidden_dropout": 0.0,
                                  "attention_dropout": 0.0}),
}

SIZE_FLAGS = ("num_layers", "hidden_size", "ffn_hidden_size",
              "num_attention_heads", "num_attention_heads_kv",
              "kv_channels", "seq_length", "max_position_embeddings",
              "padded_vocab_size", "rope_theta", "sliding_window_size",
              "num_experts", "moe_top_k", "moe_capacity_factor",
              "moe_min_capacity")


def extra_args(parser):
    """The server group (the JAX tool's ``extra_args``).  With no size
    flag a family's 7B-class size is served, so the size flags default to
    None here (the family's config fills them); with no tokenizer flag
    the numeric one of ``--vocab_size`` ids."""
    g = parser.add_argument_group("server")
    g.add_argument("--model_name", required=True, choices=sorted(FAMILIES))
    g.add_argument("--port", type=int, default=5000)
    g.add_argument("--host", default="0.0.0.0")
    g.add_argument("--int8_weights", action="store_true",
                   help="weight-only int8 quantization of the linear "
                        "kernels at load (halves decode weight traffic)")
    g.add_argument("--int8_kv_cache", action="store_true",
                   help="store decode K/V as int8 with per-position scales")
    parser.set_defaults(tokenizer_type="NullTokenizer",
                        **{k: None for k in SIZE_FLAGS})
    return parser


def build_parser() -> argparse.ArgumentParser:
    """The shared parser (``arguments.build_parser``) with the server
    group, as the JAX tool parses through ``initialize_megatron``."""
    return arguments.build_parser(extra_args)


# CLI args attribute -> TransformerConfig field, where they differ
_ARG_TO_FIELD = {"use_bias": "add_bias_linear"}


def model_config_from_args(args, arch: Optional[dict] = None):
    """The family's config at its serving size, with the size flags given
    and then ``arch`` (``--use_checkpoint_args``: the checkpoint's
    architecture, which wins over every flag and the tokenizer's padded
    vocabulary)."""
    config_fn, size, presets = FAMILIES[args.model_name]
    overrides = dict(presets)
    overrides.update({k: getattr(args, k) for k in SIZE_FLAGS
                      if getattr(args, k) is not None})
    for dst, value in (arch or {}).items():
        if dst == "use_rms_norm":
            overrides["normalization"] = "rmsnorm" if value else "layernorm"
        elif dst == "rope_llama3_scaling":
            overrides[dst] = tuple(value) if value else None
        else:
            overrides[_ARG_TO_FIELD.get(dst, dst)] = value
    if args.bf16 or args.fp16:
        dt = "bf16" if args.bf16 else "fp16"
        overrides.update(params_dtype=dt, compute_dtype=dt)
    return config_fn(size, **overrides)


def engine_config_from_args(args) -> EngineConfig:
    return EngineConfig(
        num_slots=args.serve_num_slots,
        block_size=args.serve_block_size,
        num_blocks=args.serve_num_blocks,
        max_model_len=args.serve_max_model_len,
        prefill_chunk=args.serve_prefill_chunk,
        max_queue_depth=args.serve_max_queue_depth,
        default_deadline_secs=args.serve_deadline_secs,
        int8_kv_cache=args.int8_kv_cache,
        prefix_cache=bool(args.serve_prefix_cache),
        host_cache_bytes=args.serve_host_cache_bytes,
        speculative=bool(args.serve_speculative),
        draft_k=args.serve_draft_k,
        watchdog_secs=args.serve_watchdog_secs,
        preemption=bool(args.serve_preemption),
        fault_spec=args.serve_fault_inject,
        restart_backoff_secs=args.serve_restart_backoff_secs,
    )


def build_server(args, tokenizer) -> MegatronServer:
    """Model (the ``--load`` checkpoint's params, or random weights from
    ``--seed``; int8 under ``--int8_weights``), with ``--serve_engine`` a
    warmed and started engine, and the HTTP server in front of them, with
    the SLO sentinel when ``--serve_alerts``; ``server.engine`` is the
    engine or None.  The caller binds and runs the server, and stops it
    (``server.shutdown()``, which stops the sentinel) and the engine."""
    if args.structured_log_dir:
        telemetry.install_stream(
            telemetry.TelemetryStream(args.structured_log_dir))
    if args.trace_dir:
        tracing.install_tracing(tracing.Tracing(
            tracer=tracing.SpanTracer(), trace_dir=args.trace_dir))
    refuse_unported(args, UNPORTED_SERVING)
    warn_unimplemented(args)
    device = torch.device(args.device)
    engine_cfg = engine_config_from_args(args)
    arch = None
    if args.use_checkpoint_args and args.load:
        arch = checkpoint_architecture(args.load, args.load_iters)
        print(" > using architecture args from the checkpoint", flush=True)
    model = MODEL_REGISTRY[args.model_name](
        model_config_from_args(args, arch), device=device)
    if args.load:
        # params only, held to the model's tree (meta tensors: shapes and
        # dtypes, no memory) and cast to its dtype
        params, _, _ = checkpointing.load_checkpoint(
            args.load, finetune=True, iteration=args.load_iters,
            device=device,
            params_template=init_language_model_params(None, model.cfg,
                                                       device="meta"))
        if params is None:
            raise FileNotFoundError(f"--load {args.load}: no valid "
                                    f"checkpoint there")
    else:
        print(f" no --load given: serving random weights from seed "
              f"{args.seed}", flush=True)
        params = model.init(args.seed)
    if args.int8_weights:
        # float leaves go one by one as their int8 copies are made
        params = quantize_linear_weights_int8(params, consume=True)
        qb, fb = quantized_weight_bytes(params)
        print(f" int8 weights: {qb/1e6:.1f} MB int8 + {fb/1e6:.1f} MB float",
              flush=True)
    engine = None
    if args.serve_engine:
        engine = InferenceEngine(model, params, engine_cfg)
        print(f" * paged-attention decode path: {engine.paged_kernel}",
              flush=True)
        print(f" * paged-attention prefill path: {engine.prefill_kernel}",
              flush=True)
        spec = (f"on (draft_k={engine.draft_k})" if engine.speculative
                else "off")
        print(f" * speculative decoding: {spec}", flush=True)
        engine.warmup()
        engine.start()
    server = MegatronServer(model, params, tokenizer,
                            int8_kv_cache=args.int8_kv_cache, engine=engine,
                            log_requests=args.log_requests,
                            max_prompts=args.serve_max_prompts,
                            max_tokens=args.serve_max_tokens)
    if args.serve_alerts:
        build_server_alerts(server, engine=engine,
                            structured_log_dir=args.structured_log_dir,
                            alert_rules=args.alert_rules,
                            alert_webhook=args.alert_webhook)
    return server


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    tokenizer = build_tokenizer(args)   # sets args.padded_vocab_size
    server = build_server(args, tokenizer)
    try:
        server.run(args.host, args.port)
    finally:
        server.shutdown()
        # a drain has stopped the engine already
        if server.engine is not None and not server.draining:
            server.engine.stop()
        bundle = tracing.get_tracing()
        if bundle is not None:
            bundle.write_trace(reason="shutdown")


if __name__ == "__main__":
    main()
