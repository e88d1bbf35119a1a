"""Serve a GPT-family model over REST through the continuous-batching
engine, in PyTorch on one GPU (the twin of
``tools/run_text_generation_server.py``).

    python -m megatron_llm_torch.run_text_generation_server \\
        --model_name llama2 --bf16 --load ckpt \\
        --tokenizer_type GPT2BPETokenizer --vocab_file vocab.json \\
        --merge_file merges.txt --port 5000

With no size flags the model is the family's 7B-class size (Llama-2-7B,
Llama-3-8B, Falcon-7B, ...: see ``FAMILIES``), its vocabulary padded from
the tokenizer's (``build_tokenizer``).  ``--load`` serves a checkpoint of
the port's trainer (its params only, from the tracker's iteration, held
to the model's tree), as the JAX server does; with no ``--load`` it serves
random weights drawn from ``--seed``.  ``--int8_kv_cache`` keeps the
paged KV pool as int8 with per-position scales.  ``build_server(args,
tokenizer)`` builds the model, the engine and the server in-process (the
port's tests and ``chip_smoke.py`` call it); ``main()`` parses the flags,
builds the tokenizer and serves.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from megatron_llm_torch import checkpointing, telemetry, tracing
from megatron_llm_torch.models import (
    MODEL_REGISTRY,
    falcon_config,
    gemma_config,
    gpt2_config,
    gpt_neox_config,
    llama_config,
    mistral_config,
    qwen2_config,
)
from megatron_llm_torch.models.language_model import (
    init_language_model_params,
)
from megatron_llm_torch.serving import EngineConfig, InferenceEngine
from megatron_llm_torch.text_generation_server import MegatronServer
from megatron_llm_torch.tokenizer import build_tokenizer

# family -> (its config table, the size served with no size flags, and
# what the JAX package's finetune.MODEL_DEFAULTS adds to that size)
FAMILIES = {
    "llama": (llama_config, "7B", {}),
    "llama2": (llama_config, "7B", {}),
    "codellama": (llama_config, "7B", {"rope_theta": 1e6}),
    "llama3": (llama_config, "llama3-8B", {}),
    "mistral": (mistral_config, "7B", {}),
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
              "padded_vocab_size", "rope_theta", "sliding_window_size")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    g = p.add_argument_group("model")
    g.add_argument("--model_name", required=True,
                   choices=sorted(FAMILIES))
    g.add_argument("--num_layers", type=int, default=None)
    g.add_argument("--hidden_size", type=int, default=None)
    g.add_argument("--ffn_hidden_size", type=int, default=None)
    g.add_argument("--num_attention_heads", type=int, default=None)
    g.add_argument("--num_attention_heads_kv", type=int, default=None)
    g.add_argument("--kv_channels", type=int, default=None)
    g.add_argument("--seq_length", type=int, default=None)
    g.add_argument("--max_position_embeddings", type=int, default=None)
    g.add_argument("--padded_vocab_size", type=int, default=None)
    g.add_argument("--rope_theta", type=float, default=None)
    g.add_argument("--sliding_window_size", type=int, default=None)
    g.add_argument("--bf16", action="store_true")
    g.add_argument("--seed", type=int, default=1234)
    g.add_argument("--load", type=str, default=None)
    g.add_argument("--device", default="cuda",
                   help="torch device to serve on ('cpu' for tests)")
    g.add_argument("--tokenizer_type", type=str, default="NullTokenizer")
    g.add_argument("--vocab_file", type=str, default=None)
    g.add_argument("--merge_file", type=str, default=None)
    g.add_argument("--tokenizer_path", type=str, default=None)
    g.add_argument("--tokenizer_model", type=str, default=None)
    g.add_argument("--vocab_extra_ids", type=int, default=0)
    g.add_argument("--vocab_size", type=int, default=None)
    g.add_argument("--make_vocab_size_divisible_by", type=int, default=128)
    s = p.add_argument_group("server")
    s.add_argument("--port", type=int, default=5000)
    s.add_argument("--host", default="0.0.0.0")
    s.add_argument("--log_requests", action="store_true")
    s.add_argument("--serve_max_prompts", type=int, default=128)
    s.add_argument("--serve_max_tokens", type=int, default=1024)
    s.add_argument("--serve_num_slots", type=int, default=8)
    s.add_argument("--serve_block_size", type=int, default=16)
    s.add_argument("--serve_num_blocks", type=int, default=0)
    s.add_argument("--serve_prefill_chunk", type=int, default=64)
    s.add_argument("--serve_max_queue_depth", type=int, default=64)
    s.add_argument("--serve_deadline_secs", type=float, default=120.0)
    s.add_argument("--serve_max_model_len", type=int, default=0)
    s.add_argument("--serve_prefix_cache", type=int, default=1)
    s.add_argument("--serve_preemption", type=int, default=1)
    # later slices: accepted with the JAX package's names and defaults,
    # and the engine raises NotImplementedError when one is turned on
    s.add_argument("--serve_speculative", type=int, default=0)
    s.add_argument("--serve_host_cache_bytes", type=int, default=0)
    s.add_argument("--serve_watchdog_secs", type=float, default=0.0)
    s.add_argument("--serve_fault_inject", type=str, default="")
    s.add_argument("--int8_kv_cache", action="store_true")
    s.add_argument("--structured_log_dir", type=str, default=None)
    s.add_argument("--trace_dir", type=str, default=None)
    return p


def model_config_from_args(args):
    config_fn, size, presets = FAMILIES[args.model_name]
    overrides = dict(presets)
    overrides.update({k: getattr(args, k) for k in SIZE_FLAGS
                      if getattr(args, k) is not None})
    if args.bf16:
        overrides.update(params_dtype="bf16", compute_dtype="bf16")
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
        watchdog_secs=args.serve_watchdog_secs,
        preemption=bool(args.serve_preemption),
        fault_spec=args.serve_fault_inject,
    )


def build_server(args, tokenizer) -> MegatronServer:
    """Model (the ``--load`` checkpoint's params, or random weights from
    ``--seed``), warmed and started engine, and the HTTP server in front
    of it; ``server.engine`` is the engine.  The caller binds and runs the
    server and stops the engine."""
    if args.structured_log_dir:
        telemetry.install_stream(
            telemetry.TelemetryStream(args.structured_log_dir))
    if args.trace_dir:
        tracing.install_tracing(tracing.Tracing(
            tracer=tracing.SpanTracer(), trace_dir=args.trace_dir))
    device = torch.device(args.device)
    engine_cfg = engine_config_from_args(args)
    model = MODEL_REGISTRY[args.model_name](model_config_from_args(args),
                                            device=device)
    if args.load:
        # params only, held to the model's tree (meta tensors: shapes and
        # dtypes, no memory) and cast to its dtype
        params, _, _ = checkpointing.load_checkpoint(
            args.load, finetune=True, device=device,
            params_template=init_language_model_params(None, model.cfg,
                                                       device="meta"))
        if params is None:
            raise FileNotFoundError(f"--load {args.load}: no valid "
                                    f"checkpoint there")
    else:
        print(f" no --load given: serving random weights from seed "
              f"{args.seed}", flush=True)
        params = model.init(args.seed)
    engine = InferenceEngine(model, params, engine_cfg)
    print(f" * paged-attention decode path: {engine.paged_kernel}",
          flush=True)
    print(f" * paged-attention prefill path: {engine.prefill_kernel}",
          flush=True)
    engine.warmup()
    engine.start()
    return MegatronServer(tokenizer, engine,
                          log_requests=args.log_requests,
                          max_prompts=args.serve_max_prompts,
                          max_tokens=args.serve_max_tokens)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    tokenizer = build_tokenizer(args)   # sets args.padded_vocab_size
    server = build_server(args, tokenizer)
    try:
        server.run(args.host, args.port)
    finally:
        server.engine.stop()
        bundle = tracing.get_tracing()
        if bundle is not None:
            bundle.write_trace(reason="shutdown")


if __name__ == "__main__":
    main()
