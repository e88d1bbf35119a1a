"""Capture a ``torch.profiler`` trace of the training step (the
counterpart of the root ``tools/profile_step.py``).

The reference has no profiler integration; this tool wires one around
the port's ``build_train_step`` so "profile, iterate" is one command:

    python -m megatron_llm_torch.tools.profile_step --logdir build/trace
    python -m megatron_llm_torch.tools.profile_step --preset tiny \\
        --logdir /tmp/t --device cpu

Two untraced warmup steps (the kernels' first use loads their library),
then ``--steps`` steps inside one ``torch.profiler`` window (CPU and, on
the card, CUDA activities).  Prints the wall time of each traced step
(each ends in a host sync) and the path of the Chrome trace it writes
(Perfetto or chrome://tracing).

To profile a *real* training run (real data, the actual step cadence)
instead of this synthetic one-shot, use the in-loop capture window:
``--profile --profile_step_start N --profile_step_end M --profile_dir D``
on ``megatron_llm_torch.finetune`` or ``pretrain_gpt``
(``telemetry.ProfilerSession``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional, Sequence

import torch

from megatron_llm_torch.tools.bench_harness import (
    BENCH_SHAPE,
    build_concrete,
    make_batch,
    make_cfg,
    sync,
)

PRESETS = {
    # the bench shape: ~650M llama
    "bench": dict(**BENCH_SHAPE, seq=2048, mb=4),
    # small enough for the CPU
    "tiny": dict(L=2, h=128, heads=2, ffn=352, seq=64, mb=2),
}


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--logdir", required=True,
                    help="directory for the Chrome trace (created)")
    ap.add_argument("--preset", choices=sorted(PRESETS), default="bench")
    ap.add_argument("--steps", type=int, default=3,
                    help="traced steps (after 2 untraced warmup steps)")
    ap.add_argument("--seq", type=int, help="override preset seq length")
    ap.add_argument("--micro_batch", type=int, help="override preset mb")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    p = dict(PRESETS[args.preset])
    mb = args.micro_batch or p.pop("mb")
    p.pop("mb", None)
    if args.seq:
        p["seq"] = args.seq
    seq = p["seq"]
    vocab = 32000 if args.preset == "bench" else 512
    dev = torch.device(args.device)

    cfg = make_cfg(vocab=vocab, **p)
    model, params, opt, opt_state, step = build_concrete(cfg, mb,
                                                         device=dev)
    batch = make_batch(mb, seq, vocab, device=dev)

    print(f"profile_step: preset={args.preset} seq={seq} mb={mb} "
          f"device={dev}", flush=True)
    for _ in range(2):  # first use + warmup, untraced
        params, opt_state, m = step(params, opt_state, batch, None, 1e-4,
                                    0.0)
        float(m["lm loss"])
    print("profile_step: warmup done, tracing", flush=True)

    from torch.profiler import ProfilerActivity, profile

    os.makedirs(args.logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for i in range(args.steps):
            t0 = time.perf_counter()
            params, opt_state, m = step(params, opt_state, batch, None,
                                        1e-4, 0.0)
            float(m["lm loss"])  # host sync inside the trace window
            sync(dev)
            print(f"profile_step: step {i}: "
                  f"{(time.perf_counter() - t0) * 1000:.1f} ms", flush=True)
    # a fresh file per run: a reused logdir keeps older traces
    path = os.path.join(args.logdir,
                        f"profile_step_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    if not os.path.getsize(path):
        print("profile_step: ERROR empty trace written", flush=True)
        sys.exit(1)
    print(f"profile_step: trace written: {path}", flush=True)
    return path


if __name__ == "__main__":
    main()
