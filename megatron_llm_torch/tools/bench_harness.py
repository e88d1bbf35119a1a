"""Shared harness for the port's perf tools (``mfu_sweep``,
``profile_step``, ``decode_bench``): the counterpart of the root
``tools/bench_harness.py``.

One place for the model/optimizer/train-step/batch construction, so the
batch contract ([num_micro, mb, seq] tokens/labels/loss_mask) and the
TrainConfig defaults cannot drift between tools.  The root harness's
``enable_compile_cache`` (a persistent XLA compile cache) has no
counterpart: PyTorch runs eagerly, and the kernels' own build cache is
``build/torch_kernels/`` (``ops/kernels/build.py``).
"""

from __future__ import annotations

import numpy as np
import torch

# the bench shape of the root tools: ~650M llama at head_dim 128 — ONE
# definition shared by the bench presets of profile_step and
# decode_bench (mfu_sweep's GROUPS spell shapes out per trial because
# shapes ARE its sweep axes)
BENCH_SHAPE = dict(L=10, h=2048, heads=16, ffn=5632)


def make_cfg(*, L=16, h=1280, heads=10, ffn=3584, seq=2048, vocab=32000,
             remat="selective", flash=True, fused_rms=True, experts=0,
             top_k=2, fused_ce=False):
    """The llama-family bf16 config every perf tool measures.  ``remat``
    "none" is no recompute; ``flash`` / ``fused_rms`` False take
    core_attention / the plain RMSNorm.  The default width's heads are
    10 of 128 (the root harness's 16 of 80 is no head dim the flash
    kernels take: 64, 128, 256)."""
    from megatron_llm_torch.models.llama import llama_config

    return llama_config(
        "tiny", num_layers=L, hidden_size=h, num_attention_heads=heads,
        ffn_hidden_size=ffn, padded_vocab_size=vocab, seq_length=seq,
        max_position_embeddings=seq, params_dtype="bf16",
        compute_dtype="bf16",
        recompute_granularity=None if remat == "none" else remat,
        use_flash_attn=flash, use_fused_rmsnorm=fused_rms,
        num_experts=experts, moe_top_k=top_k,
        fused_lm_cross_entropy=fused_ce)


def build_concrete(cfg, mb, num_micro=1, opt_state_dtype="fp32",
                   device="cuda"):
    """Initialized (model, params, opt, opt_state, step) for one config,
    on ``device``."""
    from megatron_llm_torch.config import ParallelConfig, TrainConfig
    from megatron_llm_torch.models.llama import LlamaModel
    from megatron_llm_torch.optimizer import MegatronOptimizer
    from megatron_llm_torch.training import build_train_step

    model = LlamaModel(cfg, device=device)
    params = model.init(0)
    tc = TrainConfig(micro_batch_size=mb,
                     global_batch_size=mb * num_micro, train_iters=0,
                     lr=1e-4, optimizer="adam", bf16=True, clip_grad=1.0,
                     optimizer_state_dtype=opt_state_dtype)
    opt = MegatronOptimizer(tc, params_dtype=torch.bfloat16)
    opt_state = opt.init(params)
    step = build_train_step(model, opt, ParallelConfig(), num_micro)
    return model, params, opt, opt_state, step


def make_batch(mb, seq, vocab, num_micro=1, np_seed=0, device="cuda"):
    """Synthetic [num_micro, mb, seq] batch in the train-step layout."""
    rng = np.random.RandomState(np_seed)
    toks = torch.from_numpy(
        rng.randint(0, vocab, (num_micro, mb, seq))).to(device)
    return {"tokens": toks, "labels": torch.roll(toks, -1, -1),
            "loss_mask": torch.ones(toks.shape, dtype=torch.float32,
                                    device=device)}


def sync(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
