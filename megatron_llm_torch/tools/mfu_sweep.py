"""MFU sweep harness (the counterpart of the root ``tools/mfu_sweep.py``).

Usage: python -m megatron_llm_torch.tools.mfu_sweep <group> [--trials N]
       [--device cpu]   (groups defined at the bottom)

Each trial builds a fresh llama-family bf16 model and the port's train
step, runs 2 warmup and 5 timed iterations and prints ms/iter,
tokens/s and MFU against ``telemetry.PEAK_FLOPS`` for the card's name
(``mfu=n/a`` where the table has no peak: the CPU, an unknown card).
The timing ends in a device sync.  A trial that fails (an out-of-memory
at a memory-edge shape) prints FAILED and the sweep goes on; the exit
code is then 1.

The root tool's trials of Pallas block sizes (``bq``/``bk``) and of its
one-pass against two-kernel flash backward are not here: the port's
flash kernels fix their tiles by head dim, and the backward's variant by
dtype and head dim (``ops/kernels/flash_attention.kernel_variant``).
The default width h 1280 takes 10 heads of 128 where the root tool took
16 of 80, which no flash kernel of the port takes (64, 128, 256); the
"shape" group keeps 16 of 80 on core attention.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

from megatron_llm_torch.telemetry import peak_flops_for_device
from megatron_llm_torch.tools.bench_harness import (
    build_concrete,
    make_batch,
    make_cfg,
    sync,
)


def bench_cfg(label, mb=8, remat="selective", flash=True, fused_rms=True,
              L=16, h=1280, ffn=3584, heads=10, seq=2048, iters=5,
              experts=0, top_k=2, vocab=32000, fused_ce=False,
              opt_state_dtype="fp32", device="cuda"):
    """One trial; returns {label, params, ms, tps, mfu} or None when it
    failed."""
    dev = torch.device(device)
    try:
        # model/optimizer init INSIDE the trial guard: the memory-edge
        # trials (bigvocab) can OOM at init, which must fail that one
        # trial, not abort the sweep
        cfg = make_cfg(L=L, h=h, heads=heads, ffn=ffn, seq=seq,
                       vocab=vocab, remat=remat, flash=flash,
                       fused_rms=fused_rms, experts=experts, top_k=top_k,
                       fused_ce=fused_ce)
        model, params, opt, opt_state, step = build_concrete(
            cfg, mb, opt_state_dtype=opt_state_dtype, device=dev)
        n = model.num_params(params)
        batch = make_batch(mb, seq, vocab, device=dev)
        for _ in range(2):
            params, opt_state, m = step(params, opt_state, batch, None,
                                        1e-4, 0.0)
            float(m["lm loss"])
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            params, opt_state, m = step(params, opt_state, batch, None,
                                        1e-4, 0.0)
        float(m["lm loss"])
        sync(dev)
        dt = (time.perf_counter() - t0) / iters
        tps = mb * seq / dt
        peak = peak_flops_for_device(dev)
        mfu = tps * model.flops_per_token(seq) / peak if peak else None
        mfu_s = f"{mfu:.3f}" if mfu is not None else "n/a"
        print(f"{label:44s} n={n/1e6:6.1f}M dt={dt*1000:8.1f}ms "
              f"tps={tps:9.1f} mfu={mfu_s}", flush=True)
        return {"label": label, "params": n, "ms": dt * 1e3, "tps": tps,
                "mfu": mfu}
    except Exception as e:      # one trial's failure, reported below
        print(f"{label:44s} FAILED: {type(e).__name__}: {str(e)[:120]}",
              flush=True)
        return None
    finally:
        if dev.type == "cuda":
            torch.cuda.empty_cache()


GROUPS = {
    "baseline": [
        dict(label="flash defaults mb4", mb=4),
        dict(label="flash defaults mb8", mb=8),
        dict(label="core attention mb4", mb=4, flash=False),
    ],
    "mb": [
        dict(label="flash mb2", mb=2),
        dict(label="flash mb4", mb=4),
        dict(label="flash mb8", mb=8),
        dict(label="flash mb16", mb=16),
    ],
    "remat": [
        dict(label="selective", remat="selective", mb=4),
        dict(label="full", remat="full", mb=4),
        dict(label="none", remat="none", mb=4),
    ],
    "long": [
        dict(label="seq4096 mb4 flash", seq=4096, mb=4),
        dict(label="seq8192 mb2 flash", seq=8192, mb=2),
        dict(label="seq4096 mb4 core attention", seq=4096, mb=4,
             flash=False),
    ],
    # small enough for the CPU
    "tiny": [
        dict(label="tiny L2 h128", mb=2, L=2, h=128, heads=2, ffn=352,
             seq=64, vocab=512, iters=2),
    ],
}
GROUPS["shape"] = [
    dict(label="h1280 nh16 d80 (core attention)", mb=4, heads=16,
         flash=False),
    dict(label="h1280 nh10 d128", mb=4, heads=10),
    dict(label="h2048 nh16 d128 L10 (bench)", mb=4, h=2048, heads=16,
         ffn=5632, L=10),
    dict(label="h2048 nh16 d128 L10 mb2", mb=2, h=2048, heads=16,
         ffn=5632, L=10),
]
GROUPS["shape2"] = [
    dict(label="h2048 L10 mb8", mb=8, h=2048, heads=16, ffn=5632, L=10),
    dict(label="h2048 L12 mb4", mb=4, h=2048, heads=16, ffn=5632, L=12),
    dict(label="h2560 nh20 L8 mb4", mb=4, h=2560, heads=20, ffn=6912, L=8),
]
GROUPS["tune650"] = [
    dict(label="650M (bench)", mb=4, h=2048, heads=16, ffn=5632, L=10),
    dict(label="650M remat full", mb=4, h=2048, heads=16, ffn=5632, L=10,
         remat="full"),
    dict(label="650M mb6", mb=6, h=2048, heads=16, ffn=5632, L=10),
]
GROUPS["moe"] = [
    # MoE on one card: all experts local; measures the dispatch/combine
    # overhead vs the dense MLP at matched active-FLOPs (dense ffn ==
    # top_k * moe ffn per token)
    dict(label="dense h2048 L10 ffn5632 (bench)",
         mb=4, h=2048, heads=16, ffn=5632, L=10),
    dict(label="moe E4 top2 ffn2816 (matched active)",
         mb=4, h=2048, heads=16, ffn=2816, L=10, experts=4),
    dict(label="moe E8 top2 ffn2816",
         mb=4, h=2048, heads=16, ffn=2816, L=10, experts=8),
]
GROUPS["seq4096"] = [
    dict(label="650M seq4096 mb1", mb=1, h=2048, heads=16, ffn=5632,
         L=10, seq=4096),
    dict(label="650M seq4096 mb2", mb=2, h=2048, heads=16, ffn=5632,
         L=10, seq=4096),
    dict(label="650M seq4096 mb4", mb=4, h=2048, heads=16, ffn=5632,
         L=10, seq=4096),
    dict(label="650M seq4096 mb2 full-remat", mb=2, h=2048, heads=16,
         ffn=5632, L=10, seq=4096, remat="full"),
]
# the fused chunked linear+CE's flip point: at 32k vocab the [tokens,
# vocab] fp32 logits are small, at 128k and 256k they are 4x and 8x
# bigger.  Smaller L keeps the big-vocab embedding and head beside the
# Adam state.
GROUPS["bigvocab"] = [
    dict(label="v32k  unfused (bench cfg)", mb=4, h=2048, heads=16,
         ffn=5632, L=10),
    dict(label="v32k  fused-CE", mb=4, h=2048, heads=16, ffn=5632, L=10,
         fused_ce=True),
    dict(label="v128k unfused", mb=4, h=2048, heads=16, ffn=5632, L=8,
         vocab=131072),
    dict(label="v128k fused-CE", mb=4, h=2048, heads=16, ffn=5632, L=8,
         vocab=131072, fused_ce=True),
    dict(label="v256k unfused", mb=2, h=2048, heads=16, ffn=5632, L=6,
         vocab=262144),
    dict(label="v256k fused-CE", mb=2, h=2048, heads=16, ffn=5632, L=6,
         vocab=262144, fused_ce=True),
]
# bf16 optimizer-state A/B (optimizer_state_dtype): the Adam moments are
# pure memory traffic in the step — storing them bf16 halves those bytes
GROUPS["optstate"] = [
    dict(label="650M fp32 moments (bench)", mb=4, h=2048, heads=16,
         ffn=5632, L=10),
    dict(label="650M bf16 moments", mb=4, h=2048, heads=16, ffn=5632,
         L=10, opt_state_dtype="bf16"),
    dict(label="650M seq4096 bf16 moments", mb=2, h=2048, heads=16,
         ffn=5632, L=10, seq=4096, opt_state_dtype="bf16"),
]
GROUPS["all"] = GROUPS["baseline"] + GROUPS["mb"]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("group", nargs="?", default="all",
                    help=f"one of {', '.join(GROUPS)}")
    ap.add_argument("--trials", type=int, default=None,
                    help="run only the group's first N trials")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.group not in GROUPS:
        print(f"unknown group {args.group!r}; available: "
              f"{', '.join(GROUPS)}")
        return 1
    failed = 0
    for trial in GROUPS[args.group][:args.trials]:
        failed += bench_cfg(**trial, device=args.device) is None
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
