"""Decode (serving) throughput benchmark (the counterpart of the root
``tools/decode_bench.py``).

Training MFU is covered by ``mfu_sweep``; this measures the legacy
generation path (``text_generation.generation.generate_tokens``, the
KV-cache loop of the port's ``run_text_generation_server`` without
``--serve_engine``): prefill throughput and steady-state decode tokens/s
on the ~650M bench shape, greedy.

The decode rate is isolated by differencing two runs (gen N and gen 2N
tokens from the same prompts): decode_tps = b*N / (t_2N - t_N) — the
shared prefill and fixed overheads cancel, so neither needs to be
timed separately.  Prefill tokens/s comes from a run that generates one
token: b*prompt / t_1.

    python -m megatron_llm_torch.tools.decode_bench          # 650M
    python -m megatron_llm_torch.tools.decode_bench --preset tiny --device cpu

One line per trial.  ``--variants`` picks among bf16 weights, int8
weights (``int8w``), int8 weights over an int8 KV cache (``int8kv``) and
the engine's speculative prompt-lookup decoding against its greedy
decoding (``spec``).
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from megatron_llm_torch.tools.bench_harness import BENCH_SHAPE, make_cfg

PRESETS = {
    "bench": dict(**BENCH_SHAPE, vocab=32000,
                  prompt=128, gen=256, batches=(1, 8)),
    "tiny": dict(L=2, h=128, heads=2, ffn=352, vocab=512,
                 prompt=16, gen=8, batches=(2,)),
}
VARIANTS = ("bf16", "int8w", "int8kv", "spec")


def _host_sync(out):
    float(out[0].sum())   # the tokens back on the host: the work is done


def run_trial(model, params, b, prompt, gen, vocab, kv_int8=False):
    """Prints one line: decode tok/s (differenced), prefill tok/s and
    end-to-end tok/s; returns them as a dict (decode None when the
    difference is inside the run-to-run jitter)."""
    from megatron_llm_torch.text_generation.generation import (
        generate_tokens,
    )

    dev = model.device
    rng = np.random.RandomState(0)
    toks = torch.from_numpy(rng.randint(1, vocab, (b, prompt))).to(dev)
    lens = torch.full((b,), prompt, dtype=torch.int64, device=dev)

    # every run uses the SAME cache allocation (prompt + 2*gen): decode
    # masks the unused tail, so the per-step cost is identical between
    # the gen-N and gen-2N runs and the differencing below is unbiased
    cache = prompt + 2 * gen

    def timed(n_new):
        def run():
            return generate_tokens(model, params, toks, lens, None,
                                   max_new_tokens=n_new,
                                   min_prompt_len=prompt, greedy=True,
                                   cache_len=cache, int8_kv_cache=kv_int8)
        _host_sync(run())               # first use, then measure
        t0 = time.perf_counter()
        _host_sync(run())
        return time.perf_counter() - t0

    t0 = timed(1)
    t1 = timed(gen)
    t2 = timed(2 * gen)
    prefill_tps = b * prompt / t0
    e2e_tps = b * 2 * gen / t2
    tag = " kv-int8" if kv_int8 else ""
    out = {"b": b, "prompt": prompt, "gen": 2 * gen, "decode_tps": None,
           "prefill_tps": prefill_tps, "e2e_tps": e2e_tps, "t2_ms": t2 * 1e3}
    if t2 - t1 < 0.05 * t2:
        # the N extra decode steps are inside run-to-run jitter: a
        # differenced rate would be noise presented as signal
        print(f"b={b:3d} prompt={prompt} gen={2*gen}{tag}: decode   INVALID "
              f"(t2-t1 jitter) | prefill {prefill_tps:9.1f} tok/s | e2e "
              f"{e2e_tps:9.1f} tok/s (t={t2*1000:.0f} ms)", flush=True)
        return out
    out["decode_tps"] = b * gen / (t2 - t1)
    print(f"b={b:3d} prompt={prompt} gen={2*gen}{tag}: "
          f"decode {out['decode_tps']:9.1f} tok/s | prefill "
          f"{prefill_tps:9.1f} tok/s | e2e {e2e_tps:9.1f} tok/s "
          f"(t={t2*1000:.0f} ms)", flush=True)
    return out


def run_spec_trial(model, params, prompt, gen, vocab, draft_k=4):
    """The engine's greedy decoding against its speculative prompt-lookup
    decoding on a repetitive prompt (the favourable case)."""
    from megatron_llm_torch.serving import EngineConfig, InferenceEngine
    from megatron_llm_torch.serving.request import SamplingParams

    rng = np.random.RandomState(1)
    pattern = rng.randint(1, vocab, max(prompt // 4, 2))
    toks = [int(t) for t in np.tile(pattern, prompt // len(pattern) + 1)
            [:prompt]]
    sp = SamplingParams(max_new_tokens=2 * gen, temperature=0.0)

    def timed(speculative):
        eng = InferenceEngine(model, params, EngineConfig(
            num_slots=1, block_size=16,
            prefill_chunk=max(prompt, 16),
            max_model_len=prompt + 2 * gen + draft_k,
            default_deadline_secs=0.0,
            speculative=speculative, draft_k=draft_k))
        eng.warmup()
        eng.start()
        try:
            eng.submit(toks, sp).result(timeout=600)  # warm run
            t0 = time.perf_counter()
            r = eng.submit(toks, sp).result(timeout=600)
            dt = time.perf_counter() - t0
            return dt, len(r.out_tokens), eng.stats()
        finally:
            eng.stop()

    t_van, n_van, _ = timed(False)
    t_spec, n_spec, stats = timed(True)
    drafted = stats.get("drafted_tokens") or 0
    accepted = stats.get("accepted_tokens") or 0
    rate = f"{accepted / drafted:.2f}" if drafted else "-"
    print(f"b=  1 prompt={prompt} gen={2*gen} (repetitive): "
          f"greedy {n_van/t_van:9.1f} tok/s | speculative[K+1={draft_k+1}] "
          f"{n_spec/t_spec:9.1f} tok/s ({t_van/t_spec:.2f}x, "
          f"accept {rate})", flush=True)


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=sorted(PRESETS), default="bench")
    ap.add_argument("--batches", type=int, nargs="+", default=None,
                    help="batch sizes (default: the preset's)")
    ap.add_argument("--gen", type=int, default=None,
                    help="N of the N / 2N runs (default: the preset's)")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help=f"comma-separated subset of {','.join(VARIANTS)}")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    variants = [v for v in args.variants.split(",") if v]
    unknown = set(variants) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}")

    p = PRESETS[args.preset]
    prompt = p["prompt"]
    gen = args.gen or p["gen"]
    batches = args.batches or p["batches"]
    seq_budget = prompt + 2 * gen
    # decode is seq-1 steps: flash attention is a prefill-only win,
    # keep the root tool's plain attention
    cfg = make_cfg(L=p["L"], h=p["h"], heads=p["heads"], ffn=p["ffn"],
                   vocab=p["vocab"], seq=max(seq_budget, 128), flash=False)
    from megatron_llm_torch.models.llama import LlamaModel

    model = LlamaModel(cfg, device=args.device)
    params = model.init(0)
    n = model.num_params(params)
    print(f"decode_bench: {n/1e6:.0f}M params, device={model.device}",
          flush=True)
    results = []
    if "bf16" in variants:
        for b in batches:
            results.append(run_trial(model, params, b, prompt, gen,
                                     p["vocab"]))
    if "int8w" in variants or "int8kv" in variants:
        # weight-only int8: decode re-reads every dense weight per token,
        # so halving those bytes targets the decode bandwidth bound
        from megatron_llm_torch.quantization import (
            quantize_linear_weights_int8,
        )
        qparams = quantize_linear_weights_int8(params)
        if "int8w" in variants:
            print("decode_bench: int8 weight-only quantized weights",
                  flush=True)
            for b in batches:
                results.append(run_trial(model, qparams, b, prompt, gen,
                                         p["vocab"]))
        if "int8kv" in variants:
            # int8 KV cache on top of int8 weights: fully int8 decode bytes
            print("decode_bench: + int8 KV cache", flush=True)
            for b in batches:
                results.append(run_trial(model, qparams, b, prompt, gen,
                                         p["vocab"], kv_int8=True))
    if "spec" in variants:
        run_spec_trial(model, params, prompt, gen, p["vocab"])
    return results


if __name__ == "__main__":
    main()
