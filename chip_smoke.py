#!/usr/bin/env python3
"""Quickest proof that the PyTorch port starts, serves and trains on one
GPU.

    python3 chip_smoke.py

Phase 0 prints the card and builds the port's CUDA kernels from
``megatron_llm_torch/csrc``.  Phase 1 holds each of the nine kernels
against its plain PyTorch version on the card, in bf16 and fp32, times
it, its plain version and one PyTorch library call, and computes its
bound:

* A, ragged paged attention, and A', the same over int8 pools with
  per-position scales: at Llama-2-7B's serving shapes and Falcon-7B's (71
  query heads on one KV head of 64), at head_dim 256 (Gemma-2B's 8 heads
  on one KV head, Gemma-7B's 16), and at edge cases (GQA, sliding
  windows, empty context, chunks across page boundaries, a page that
  straddles the context end); every case twice with equal bits, once
  more on the other kernel variant (bf16) and once with its keys in one
  split.  They are timed as CUDA graph replays (the device's time a
  call) and as the host issues them, with sweeps of the key splits and
  of the query rows a KV group at which the tensor-core variant takes
  over;
* B and C, the RMSNorm forward and backward, and D and E, the LayerNorm
  forward and backward: at decode, prefill and training rows of 4096 and
  4544 columns and at odd shapes; B (one kernel with D) at every plan
  its rows can take, forced grids included, with and without rstd, and C
  and E (one kernel) at forced plans with their partial rows against
  their plain walk, each run again with the same bits;
* F, the flash-attention forward, and G and H, its fused and two-pass
  backward: at both models' training shapes (32 heads of 128 at 4096
  tokens; 71 heads on one KV head of 64 at 2048), at head_dim 256
  (Gemma-7B's 16 heads, Gemma-2B's 8 on one KV head), GQA, MQA, windows,
  a 1000-token sequence that takes H with a ragged last tile, and q/k/v
  that are strided views of one fused QKV tensor, as the model passes
  them; every backward twice, with equal dK/dV (also where the heads are
  split over blocks) and, for H, equal dq.  F and G are timed at
  Llama-2-7B's, Falcon-7B's and Gemma-7B's attention shapes, H at their
  sequence-1000 steps (beside SDPA's backward, eager and device, and the
  device time of each of H's passes from torch.profiler), D at Falcon's
  decode and training rows and B at Llama's decode, prefill and training
  rows (eager and as a CUDA graph replay, with their plans, beside
  ``F.layer_norm`` and ``F.rms_norm``), B's serving call site, E at
  Falcon's training rows and C at Llama's and Gemma-7B's (with each
  pass's device time), and B's and C's wrappers' host work by part.  The
  build's
  register, spill and shared memory figures of every flash kernel, and
  the registers and spills of every norm kernel instantiation, are
  printed.

Phase 2 starts the port's HTTP server through ``build_server`` with
Llama-2-7B at full width (random bf16 weights from a seed), answers
``PUT /api`` requests, and checks that every request finished, that a
repeated request gives the same tokens, that the serving kernels ran
exactly as often as the engine's dispatch counts say (and the other
family's not at all), that each repeated prefix hit the prefix cache for
exactly its full cached pages, and that an independent no-cache forward
(no kernel: plain norm and ``core_attention``) agrees with the served
tokens.  Then, on the stopped engine, it forces the copy-on-write of a
page two requests share and checks the copy, and profiles decode steps of
the full 8-slot batch (device-busy time against the step's) and prefill
chunks of 64 tokens at context 992 the same way; the paged launches must
have taken the planned kernel variants (decode "simt" for Llama's one
query row a KV group, "mma" for Falcon's 71; prefill "mma"; the fp32
checks "simt").  Phase 4 does the same with
Falcon-7B at full width over an int8 KV pool (``--int8_kv_cache``): D and
A' run, A and B do not, the copy covers the scales, and in fp32 the paged
path agrees with the no-cache path exactly over plain pools and within a
stated quantisation bound over int8 pools.

Phase 3 trains Llama-2-7B at full width, cut to 8 of its 32 layers
(bf16 params, fp32 masters and Adam moments, clip 1.0, sequence 4096,
two micro-batches of 1), through ``megatron_llm_torch.finetune.main`` on
synthetic data for 4 iterations, printing its log lines: finite losses
and grad norms, a first loss near ln 32000, and per step exactly 16
launches of F and of G, 34 of B and of C, none of H, D or E.  Then 5 steps
of ``build_train_step`` on one repeated batch must lower the loss at every
step (timed as forward+backward and optimizer by CUDA events, with
tokens/s, TFLOP/s, MFU and peak memory); one step at sequence 1000 must
take H and not G; and, in fp32 at 2 layers and sequences 1024 (G) and
1000 (H), the kernel path's loss and every param grad must agree with
the plain path's (``core_attention`` and the plain norm's autograd).
Phase 5 does the same with Falcon-7B's width at sequence 2048, 8 of 32
layers: per step 16 launches of F and of G and 18 of D and of E, none of
B or C.  Phase 6 does it with Gemma-7B's width (hidden 3072, 16 heads of
256, vocab 256000) at sequence 2048, cut to 2 layers: the head_dim 256
path.  Every training phase checks that its flash launches went through
the bf16 kernel variants (the fp32 checks through the fp32 ones).

Phase 7 writes an mmap corpus with the port's builder (2000 documents of
100-4096 random ids below 32000 from seed 1234, uint16) under build/,
and trains Llama-2-7B's width cut to 2 layers at sequence 4096 on it
through ``finetune.main`` (``--data_path``, ``--split 98,2,0``, eval every
2 iterations, a checkpoint every 2) for 4 iterations; then resumes from
iteration 2 (``--load``, ``--load_iters 2``) and runs to 4.  Every leaf
loaded (params and optimizer state) must have the device digest of the
leaf saved, the resumed iteration 3 loss must equal the uninterrupted
one bit for bit (one forward from identical params on the same
samples), iteration 4 within the bf16 tolerance (G's dq sums with fp32
atomics), the eval losses finite, and every launch count exact.  It
prints the save and load seconds and GB/s and the checkpoint's size,
and the step time and device idle share of a step fed by the real
loader beside one on a batch kept on the card.  Then the port's server
loads the iteration-4 checkpoint (``--load``) with a GPT-2 byte-level
BPE tokenizer over a 32000-id vocabulary the script writes, answers 8
text prompts over HTTP, and its greedy tokens are held to the no-cache
path on the loaded params (``_token_check``).  The directory is deleted
at the end.

Phase 8 pretrains GPT-2 345M at full width and depth (24 layers, hidden
1024, 16 heads, sequence 1024, micro-batch 4, global batch 8, the lr,
schedule, clip and weight decay of ``examples/pretrain_gpt.sh``, bf16,
hidden and attention dropout 0.1) through
``megatron_llm_torch.pretrain_gpt.main`` for 20 iterations, evaluating
10 batches every 10, on an mmap corpus the script writes (2500 documents
of random ids below 50257 from seed 1234) with a GPT-2 byte-level BPE of
50257 ids padded to 50304.  Training takes ``core_attention`` (attention
dropout) and the evaluations flash attention: F runs only in them, G
never, and D and E as the dispatches say.  One iteration each of the
same run again, with both dropouts at 0, with ``--recompute_granularity
full`` and with ``--lima_dropout``: the same seed and full recompute give
the iteration-1 loss bit for bit and the grad norm within 1e-3 (the
embedding backward's atomics), no dropout another loss.

Phase 9 trains Llama-3-8B's width (hidden 4096, 32 heads on 8 KV heads,
ffn 14336, vocab 128256, rope theta 5e5) cut to 4 of 32 layers at its own
sequence 8192 through ``finetune.main`` (micro-batch 1, global batch 2,
synthetic data, 3 iterations) five ways: the fused LM-head cross entropy
(``--fused_lm_cross_entropy``: at 128256 ids the JAX package's policy,
on from 131072, leaves it off), the defaults (unfused, with the policy's
note), fused with selective and with full recompute, and fused without
flash attention (the q-chunked attention at 8192).  Against the first:
the unfused loss within 1e-3 and its forward+backward peak memory at
least 6 GB higher; the recompute runs' iteration-1 loss bit for bit,
grad norm within 1e-3, peaks full < selective < none, F twice a layer;
the chunked run's loss within 1e-3 with no F or G.  Each variant's step
time, tokens/s, MFU and peak memory are printed.

It prints, before its last line, the card's name and power limit, one
JSON line with every kernel's numbers (``{"kernels": [...]}``), and as
its last line ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --measure [--sweep]

builds the kernels and times only B, C, D, E and H (``norm_times``,
``h_and_d_times``, ``norm_profiles``) and B's and C's wrappers' host
work by part (``b_host_breakdown``, ``c_host_breakdown``), through the
wrappers' public entry points; ``--sweep`` adds B, C, D and E under
other plans and D's wrapper's host work.  It prints one JSON line and no
result.  Any failed check exits non-zero without that line; so does a
run without a CUDA device or outside a checkout of the repo.  Long logs
go to ``chiprun_out/``.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")

# the norms' training rows of phases 8 and 9 (GPT-2 345M: 4 x 1024 tokens
# of 1024; Llama-3-8B's width: 8192 tokens of 4096), checked in phase 1
# with the flash cases of those phases on inputs drawn from their own
# generator (``_phase8_9_gen``), so that the earlier cases keep theirs
PHASE8_9_ROWS = ((4096, 1024), (8192, 4096))


def _phase8_9_gen():
    import torch

    return torch.Generator(device="cuda").manual_seed(89)

# tolerances (max-abs, kernel vs plain version on identical inputs): the
# bf16 tolerance of tests/test_pallas_kernels.py, and fp32 at 1e-4
TOL = {"bf16": 2e-2, "fp32": 1e-4}
# bf16 paged attention, also: each row's largest error against the plain
# version in fp32 within this share of the row's largest |value| (rows at
# context ~1000 hold values ~0.05, where 2e-2 alone says little; the
# error measured on the H100 is in PERF.md)
PAGED_ROW_REL = 1e-2
# H100 SXM published peaks (NVIDIA H100 datasheet)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

# The independent check, in two parts.  (1) In fp32, the teacher-forced
# logits of the paged path (both kernels) and of the no-cache path
# (neither) agree within FP32_LOGIT_TOL: only summation order differs.
# This is the part that would catch a wrong kernel.  (2) The served bf16
# tokens equal the bf16 no-cache argmax wherever its top-2 logit margin
# exceeds MARGIN_BOUND.  bf16 keeps ~3 significant digits at every op of
# 32 layers and the two paths round at different places (the no-cache
# scores are rounded to bf16 before the softmax), so their logits differ
# by more than rounding of one op; the script prints that spread (mean,
# 99.9th percentile and max of the teacher-forced |diff|, beside the
# logits' std) for both prompts it checks.  A flip needs the top two
# logits to move by the margin between them, so the bound sits above
# twice the typical |diff|.  At least MIN_CHECKED_FRACTION of the
# positions must clear the bound.
FP32_LOGIT_TOL = 1e-2
MARGIN_BOUND = 0.5
MIN_CHECKED_FRACTION = 0.1

# The int8 KV pool is not exact: every K and V value is rounded to one of
# 255 levels of its (position, group) absmax, a relative step of 1/254,
# at every layer, so the fp32 logits of the int8 paged path differ from
# the no-cache path by far more than the summation order that separates
# the plain pools from it.  The bound is on max |logit diff| over the
# logits' std, as the drift bound of the kernel's own test is (0.2 of the
# output's std for one attention call).  Over fp32 plain pools the same
# model is held exactly (FP32_PLAIN_POOL_TOL), so that the LayerNorm
# kernel and the parallel block are.
INT8_LOGIT_DRIFT_BOUND = 0.2
FP32_PLAIN_POOL_TOL = 2e-4
# Served int8 tokens against the bf16 no-cache argmax: held at the same
# margin bound as the plain pools (Falcon's bf16 logits of the two paths,
# quantisation included, differ by less than Llama's: 0.125 at most, so
# a flip needs a margin under 0.25), but random weights over 65024 ids
# leave few positions above it, so fewer must clear it.
INT8_MIN_CHECKED_FRACTION = 0.03

# Gradients (kernels C, E, G, H against their plain versions): max-abs error
# over the gradient's max-abs.  The sums run in another order than the
# plain version's (G adds dq with atomics, in an order that changes from
# run to run), and in bf16 the kernels round P and dS to bf16 before
# their products where the plain backward keeps fp32.
GRAD_TOL = {"bf16": 2e-2, "fp32": 1e-4}
# The training slice's independent check, fp32: kernel path against the
# plain path (core_attention, the plain norm's autograd), same params and
# tokens.  The loss to 1e-5 relative; every param grad leaf to 1e-4 of
# the leaf's max-abs (only summation order differs; a wrong kernel is off
# by the gradient's own size).
FP32_LOSS_TOL = 1e-5
FP32_GRAD_TOL = 1e-4


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


# the run's log lines also go to chip_smoke.log under OUT_DIR (main opens it)
_LOG_FILES = []


def log(msg: str) -> None:
    print(msg, flush=True)
    for f in _LOG_FILES:
        f.write(msg + "\n")
        f.flush()


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, reps: int = 10) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in one
    CUDA graph, the graph replayed ``reps`` times between CUDA events, so
    no host time lies between the launches (``time_ms`` times the calls
    as the host issues them)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * iters)
    del graph
    return ms


def bound(nbytes: float, flops: float, flop_rate: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------

def _fwd_plans(n, h, dtype, sm):
    """Plans the norm forward (B, D) can take for [n, h] rows: every
    (row_threads, vecs) that covers a row, with 1, 2, 4 or 8 rows a block
    as its threads allow, each over a grid that covers the rows at once,
    one of one, two or four blocks an SM (where the rows need more), and
    one that walks the rows three times."""
    from megatron_llm_torch.ops.kernels import norm_plan

    nvec = h // (16 // _itemsize(dtype))
    out = set()
    for v in range(1, norm_plan.MAX_VECS + 1):
        t = 32 * -(-nvec // (32 * v))
        for rows in (1, 2, 4, 8):
            if t * rows > norm_plan.max_threads(v):
                continue
            blocks = -(-n // rows)
            for grid in {blocks, min(blocks, sm), min(blocks, 2 * sm),
                         min(blocks, 4 * sm), -(-blocks // 3)}:
                out.add((t, v, rows, grid))
    return sorted(out)


def _itemsize(dtype):
    import torch

    return torch.empty((), dtype=dtype).element_size()



def _paged_case(gen, S, C, nh, g, d, bs, M, ctx, dtype):
    """Pools with every slot's pages allocated in a shuffled order, and
    unowned pages full of large garbage."""
    import torch

    P = 1 + S * M
    dev = "cuda"
    q = torch.randn(S, C, nh, d, device=dev, generator=gen).to(dtype)
    kp = (torch.randn(P, bs, g, d, device=dev, generator=gen) * 30).to(dtype)
    vp = (torch.randn(P, bs, g, d, device=dev, generator=gen) * 30).to(dtype)
    perm = torch.randperm(P - 1, device=dev, generator=gen) + 1
    bt = perm.reshape(S, M).to(torch.int32).contiguous()
    for s in range(S):
        live = -(-(ctx[s] + C) // bs)
        pages = bt[s, :live].long()
        kp[pages] = torch.randn(live, bs, g, d, device=dev,
                                generator=gen).to(dtype)
        vp[pages] = torch.randn(live, bs, g, d, device=dev,
                                generator=gen).to(dtype)
    cl = torch.tensor(ctx, dtype=torch.int32, device=dev)
    return q, kp, vp, bt, cl


def _paged_bytes_flops(S, C, nh, g, d, bs, ctx, window, itemsize,
                       quantized=False):
    """Bytes the function must move (q in, out, and each slot's live K/V
    pages of every group, read once: int8 pages with their fp32 scales
    when quantized) and its matmul operations."""
    pages = 0
    flops = 0
    for s in range(S):
        hi = ctx[s] + C - 1
        lo = 0 if window is None else max(ctx[s] - window + 1, 0)
        pages += hi // bs - lo // bs + 1
        for j in range(C):
            pos = ctx[s] + j
            keys = pos + 1 if window is None else min(pos + 1, window)
            flops += 2 * 2 * keys * nh * d
    per_key = 2 * (d + 4) if quantized else 2 * d * itemsize
    kv = pages * bs * g * per_key
    qo = 2 * S * C * nh * d * itemsize
    return kv + qo + S * 4 * 2, flops


def _run_paged(pa, q, kp, vp, bt, cl, scales, window, block_q=None,
               with_ref=True):
    """(kernel output, plain output in fp32 or None) of one paged-attention
    case through the public entries; decode when the chunk is one token.
    (The plain version rounds its fp32 result to q's dtype at its end.)"""
    ks, vs = scales
    scale = 1.0 / math.sqrt(q.shape[-1])
    ref = None
    if q.shape[1] == 1:
        out = pa.paged_attention_decode(
            q[:, 0].contiguous(), kp, vp, bt, cl, k_scales=ks, v_scales=vs,
            sliding_window=window)
        if with_ref:
            ref = pa._reference_paged_attention(q[:, 0].float(), kp, vp, bt,
                                                cl, ks, vs, scale, window)
    else:
        out = pa.paged_attention_prefill(
            q, kp, vp, bt, cl, k_scales=ks, v_scales=vs,
            sliding_window=window, block_q=block_q)
        if with_ref:
            ref = pa._reference_paged_prefill(q.float(), kp, vp, bt, cl, ks,
                                              vs, scale, window)
    return out, ref


def _paged_errors(out, ref32):
    """(max-abs error against the plain version rounded to out's dtype,
    the largest of each row's max-abs error against the fp32 plain
    version over the row's largest |value|)."""
    o = out.float().reshape(ref32.shape)
    e = (o - ref32.to(out.dtype).float()).abs().max().item()
    rel = ((o - ref32).abs().amax(-1)
           / ref32.abs().amax(-1).clamp_min(1e-6)).max().item()
    return e, rel


def _time_paged(gen, pa, S, C, ctx, nh, g, d, quantized, sweep=False):
    """Times of one paged-attention shape in bf16: the kernel, its plain
    version, SDPA over a pre-gathered (pre-dequantised, heads expanded)
    dense K/V, and the bound."""
    import torch
    import torch.nn.functional as F

    from megatron_llm_torch.quantization import absmax_quantize_int8

    bs, M = 16, 128
    q, kp, vp, bt, cl = _paged_case(gen, S, C, nh, g, d, bs, M, ctx,
                                    torch.bfloat16)
    ks = vs = None
    dense_k, dense_v = kp, vp
    if quantized:
        kp, ks = absmax_quantize_int8(kp, axis=-1)
        vp, vs = absmax_quantize_int8(vp, axis=-1)
        dense_k = (kp.float() * ks[..., None]).to(torch.bfloat16)
        dense_v = (vp.float() * vs[..., None]).to(torch.bfloat16)
    scale = 1.0 / math.sqrt(d)
    if C == 1:
        q1 = q[:, 0].contiguous()
        run = lambda: pa.paged_attention_decode(q1, kp, vp, bt, cl,
                                                k_scales=ks, v_scales=vs)
        plain = lambda: pa._reference_paged_attention(q1, kp, vp, bt, cl, ks,
                                                      vs, scale, None)
    else:
        run = lambda: pa.paged_attention_prefill(q, kp, vp, bt, cl,
                                                 k_scales=ks, v_scales=vs)
        plain = lambda: pa._reference_paged_prefill(q, kp, vp, bt, cl, ks,
                                                    vs, scale, None)
    variant, _, _, splits = _paged_plan(pa, q, kp, bt, quantized)
    # ms: a call as the host issues it, the wrapper's Python and ctypes
    # included (the yardstick of every row of the kernels line);
    # device_ms: the device's time a call (CUDA graph replay)
    out = dict(ms=time_ms(run, iters=50), device_ms=graph_ms(run),
               plain_ms=time_ms(plain, iters=10), variant=variant,
               splits=splits)
    if sweep:
        # the key splits, forced: the sweep behind key_splits (device
        # times)
        out["splits_ms"] = {
            n: graph_ms(lambda n=n: pa._ragged_call(
                q, kp, vp, bt, cl, ks, vs, scale=scale, window=None,
                splits=n))
            for n in (1, 2, 3, 4, 5, 6, 8, 12, 16)}
    # library yardstick: SDPA over a dense [S, nh, T, d] view of each
    # slot's live keys, gathered, dequantised and expanded to the query
    # heads beforehand (none of that is timed)
    T = ctx[0] + C
    qpg = nh // g
    kd = dense_k[bt.long()].reshape(S, M * bs, g, d)[:, :T].transpose(1, 2)
    vd = dense_v[bt.long()].reshape(S, M * bs, g, d)[:, :T].transpose(1, 2)
    kd = kd.repeat_interleave(qpg, dim=1).contiguous()
    vd = vd.repeat_interleave(qpg, dim=1).contiguous()
    qd = q.transpose(1, 2).contiguous()                 # [S, nh, C, d]
    kpos = torch.arange(T, device="cuda")
    qpos = ctx[0] + torch.arange(C, device="cuda")
    mask = (kpos[None, :] <= qpos[:, None])[None, None]
    sdpa = lambda: F.scaled_dot_product_attention(qd, kd, vd,
                                                  attn_mask=mask)
    out["library_ms"] = time_ms(sdpa, iters=50)
    out["library_device_ms"] = graph_ms(sdpa)
    nbytes, flops = _paged_bytes_flops(S, C, nh, g, d, bs, ctx, None, 2,
                                       quantized)
    out["bound_ms"], out["bound_by"] = bound(nbytes, flops, BF16_FLOPS)
    pools = "int8 pools" if quantized else "bf16 pools"
    out["shape"] = (f"S={S} C={C} nh={nh} g={g} d={d} bs={bs} ctx={ctx[0]} "
                    f"bf16, {pools}")
    return out


def _log_times(label, t, library):
    how = (f" ({t['variant']}" + (f", {t['splits']} splits" if "splits" in t
                                  else "") + ")" if "variant" in t else "")

    def f4(v):
        return "not measured" if v is None else f"{v:.4f} ms"

    device = (f" (device: kernel {f4(t['device_ms'])}, library "
              f"{f4(t.get('library_device_ms'))})" if "device_ms" in t
              else "")
    log(f"  {label} {t['shape']}: kernel{how} {t['ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f} ms, {library} {t['library_ms']:.4f} ms, bound "
        f"{t['bound_ms']:.5f} ms ({t['bound_by']}){device}")
    if "splits_ms" in t:
        log(f"    ms by key splits: " + ", ".join(
            f"{n}: {v:.4f}" for n, v in t["splits_ms"].items()))


def phase1(gen, results):
    import torch

    from megatron_llm_torch.ops.kernels import layernorm as ln
    from megatron_llm_torch.ops.kernels import paged_attention as pa
    from megatron_llm_torch.ops.kernels import rmsnorm as rn
    from megatron_llm_torch.quantization import absmax_quantize_int8

    dts = {"bf16": torch.bfloat16, "fp32": torch.float32}

    # -- kernel B: RMSNorm ------------------------------------------------
    # serving's decode and prefill rows, odd shapes, and the training
    # path's mb * seq rows at sequences 4096, 1000 and Llama-3's 8192
    # (phase 9): each at plan()'s
    # plan and at every other plan the norm forward can take for the rows
    # (forced grids included), each with rstd, without it (the no-grad
    # path's call) and again with it: the same bits every time
    sm = _sm_count()
    err = {"bf16": 0.0, "fp32": 0.0}
    gen89 = _phase8_9_gen()
    for tag, dt in dts.items():
        for n, h in ((8, 4096), (64, 4096), (3, 128), (17, 11008 // 2),
                     (4096, 4096), (1000, 4096), (8192, 4096)):
            gen_ = gen89 if (n, h) in PHASE8_9_ROWS else gen
            x = (torch.randn(n, h, device="cuda", generator=gen_) * 3).to(dt)
            # Llama-3's 33.5 M outputs with the scale in [0.4, 0.8], as
            # D's check keeps its outputs below 4: above it a bf16 step
            # (0.03) is more than the tolerance, and a plan whose sum of
            # squares rounds one fp32 step apart flips the output where
            # the plain fp32 value sits on a bf16 tie (0.03125 under 15
            # forced plans on the card with the scale up to 1.5; the
            # fp32 case holds the arithmetic)
            lo, width = (0.4, 0.4) if n == 8192 else (0.5, 1.0)
            s = (torch.rand(h, device="cuda", generator=gen_) * width
                 + lo).to(dt)
            y0, r0 = rn.rms_norm_fwd_plain(x, s, 1e-5)
            plans = [ln.plan(n, h, dt, sm)] + _fwd_plans(n, h, dt, sm)
            e_max = 0.0
            for p in plans:
                y, r = rn.rms_norm_fwd_kernel(x, s, 1e-5, force_plan=p)
                y2, _ = rn.rms_norm_fwd_kernel(x, s, 1e-5, rstd=False,
                                               force_plan=p)
                again = rn.rms_norm_fwd_kernel(x, s, 1e-5, force_plan=p)
                torch.cuda.synchronize()
                e = max((y.float() - y0.float()).abs().max().item(),
                        (r - r0).abs().max().item())
                check(e <= TOL[tag], f"rmsnorm {tag} n={n} h={h} plan {p}: "
                                     f"{e} > {TOL[tag]}")
                check(torch.equal(y2, y) and torch.equal(again[0], y)
                      and torch.equal(again[1], r),
                      f"rmsnorm {tag} n={n} h={h} plan {p}: the output "
                      f"changed between runs")
                e_max = max(e_max, e)
            log(f"  rmsnorm {tag} n={n} h={h}: plan() {plans[0]} and "
                f"{len(plans) - 1} forced plans, max_abs_err {e_max:.3g}, "
                f"the same bits on every rerun")
            err[tag] = max(err[tag], e_max)
    # timed with C, D, E and H in phase1_times, at the end of phase 1
    results["rmsnorm"] = dict(
        name="rmsnorm_fwd", route="cuda",
        source="megatron_llm_torch/csrc/layernorm.cu",
        replaces="megatron_llm_tpu/ops/pallas/rmsnorm.py:56",
        max_abs_err=err["bf16"], max_abs_err_fp32=err["fp32"])

    # -- kernel D: LayerNorm forward ---------------------------------------
    # Falcon-7B's decode, prefill and training rows (4544 columns: 568
    # vectors of 8 bf16, no multiple of the block's 256 threads), GPT-2's
    # 768, GPT-2 345M's training rows (phase 8: 4 x 1024 tokens of 1024),
    # odd shapes, and rows with a large mean in fp32
    err = {"bf16": 0.0, "fp32": 0.0}
    gen89 = _phase8_9_gen()
    for tag, dt in dts.items():
        for n, h, mean in ((8, 4544, 0.0), (64, 4544, 0.0), (2048, 4544, 0.0),
                           (1000, 768, 0.0), (4096, 1024, 0.0), (3, 128, 0.0),
                           (17, 1600, 0.0), (64, 4544, 30.0)):
            gen_ = gen89 if (n, h) in PHASE8_9_ROWS else gen
            # outputs below 4: above it a bf16 step is 0.03, more than
            # the tolerance, and a last-bit fp32 difference can flip one
            x = (torch.randn(n, h, device="cuda", generator=gen_) * 3
                 + mean).to(dt)
            s = (torch.rand(h, device="cuda", generator=gen_) * 0.4
                 + 0.4).to(dt)
            b = (torch.randn(h, device="cuda", generator=gen_) * 0.1).to(dt)
            y, mu, r = ln.layer_norm_fwd_kernel(x, s, b, 1e-5)
            again = ln.layer_norm_fwd_kernel(x, s, b, 1e-5)
            y0, mu0, r0 = ln.layer_norm_fwd_plain(x, s, b, 1e-5)
            torch.cuda.synchronize()
            e = max((y.float() - y0.float()).abs().max().item(),
                    (mu - mu0).abs().max().item(),
                    (r - r0).abs().max().item())
            # fp32 at the tolerance of the CPU tests, 1e-5
            tol = TOL[tag] if tag == "bf16" else 1e-5
            plan = ln.plan(n, h, dt, _sm_count())
            log(f"  layernorm {tag} n={n} h={h} mean={mean:g} (plan "
                f"{plan}): max_abs_err {e:.3g}")
            check(e <= tol, f"layernorm {tag} n={n} h={h}: {e} > {tol}")
            check(all(torch.equal(a_, b_) for a_, b_ in zip(again,
                                                            (y, mu, r))),
                  f"layernorm {tag} n={n} h={h}: the output changed "
                  f"between two runs")
            err[tag] = max(err[tag], e)
    # timed with H in h_and_d_times, at the end of phase 1
    results["layernorm"] = dict(
        name="layernorm_fwd", route="cuda",
        source="megatron_llm_torch/csrc/layernorm.cu",
        replaces="megatron_llm_tpu/ops/pallas/layernorm.py:50",
        max_abs_err=err["bf16"], max_abs_err_fp32=err["fp32"])

    phase1_paged(gen, results)


# (label, S, C, nh, g, d, bs, M, ctx, window, block_q) of the paged
# attention cases; every case runs over plain pools (A) and over int8
# pools (A')
PAGED_CASES = [
    ("Llama-2-7B decode", 8, 1, 32, 32, 128, 16, 128,
     [0, 37, 100, 513, 1000, 1200, 1500, 2000], None, None),
    ("Llama-2-7B prefill", 1, 64, 32, 32, 128, 16, 128, [1000], None, None),
    ("Llama-2-7B prefill ctx 0", 1, 64, 32, 32, 128, 16, 128, [0], None,
     None),
    ("Falcon-7B decode", 8, 1, 71, 1, 64, 16, 128,
     [0, 37, 100, 513, 1000, 1200, 1500, 2000], None, None),
    ("Falcon-7B prefill", 1, 64, 71, 1, 64, 16, 128, [1000], None, None),
    ("Falcon-7B prefill ctx 0", 1, 64, 71, 1, 64, 16, 128, [0], None,
     None),
    ("Falcon-7B prefill, a page straddling the context end", 2, 64, 71,
     1, 64, 16, 128, [9, 1003], None, None),
    ("Falcon-7B decode window 100", 4, 1, 71, 1, 64, 16, 128,
     [0, 99, 100, 1500], 100, None),
    ("GQA g8 decode", 8, 1, 32, 8, 128, 16, 128,
     [0, 5, 16, 17, 300, 700, 1100, 2000], None, None),
    ("GQA g8 prefill", 2, 64, 32, 8, 128, 16, 128, [7, 250], None, 16),
    ("Mistral window 4096 decode", 4, 1, 32, 8, 128, 16, 320,
     [0, 4095, 4100, 5000], 4096, None),
    ("window 5 prefill", 3, 64, 32, 8, 128, 16, 16, [0, 3, 40], 5, 8),
    ("window 12 decode, bs 8", 4, 1, 8, 2, 64, 8, 16,
     [0, 7, 30, 100], 12, None),
    ("d 32 window 12 prefill, bs 8", 2, 16, 8, 2, 32, 8, 16, [3, 50], 12,
     None),
    ("page-crossing chunk, ctx % bs != 0", 2, 64, 32, 32, 128, 16, 8,
     [9, 55], None, None),
    # head_dim 256: Gemma-2B (8 heads on one KV head) and Gemma-7B (16
    # heads, MHA)
    ("Gemma-2B decode", 8, 1, 8, 1, 256, 16, 128,
     [0, 37, 100, 513, 1000, 1200, 1500, 2000], None, None),
    ("Gemma-2B prefill", 2, 64, 8, 1, 256, 16, 128, [5, 1000], None, None),
    ("Gemma-7B decode", 8, 1, 16, 16, 256, 16, 128,
     [0, 37, 100, 513, 1000, 1200, 1500, 2000], None, None),
    ("Gemma-7B prefill", 2, 64, 16, 16, 256, 16, 128, [0, 1000], None,
     None),
]


def _paged_plan(pa, q, kp, bt, quantized, variant=None):
    """The wrapper's plan of a call (``variant`` forces the kernel)."""
    S, C, nh, d = q.shape
    return pa.plan(q.dtype, S, C, nh, kp.shape[2], d, kp.shape[1],
                   bt.shape[1], quantized, _sm_count(), variant)


def _sm_count():
    import torch

    from megatron_llm_torch.ops.kernels import build

    return build.sm_count(torch.device("cuda"))


def phase1_paged(gen, results):
    """A and A': every case against the plain version (the planned
    variant twice, bitwise equal; the other variant in bf16; one split),
    the timing shapes with the split sweep, and the sweep of the rows
    threshold between the two variants."""
    import torch

    from megatron_llm_torch.ops.kernels import paged_attention as pa
    from megatron_llm_torch.quantization import absmax_quantize_int8

    dts = {"bf16": torch.bfloat16, "fp32": torch.float32}
    err = {q_: {"decode": {"bf16": 0.0, "fp32": 0.0},
                "prefill": {"bf16": 0.0, "fp32": 0.0}} for q_ in (False, True)}
    row_rel = {"mma": 0.0, "simt": 0.0}     # bf16, by variant
    for (label, S, C, nh, g, d, bs, M, ctx, window, bq) in PAGED_CASES:
        for tag, dt in dts.items():
            q, kp, vp, bt, cl = _paged_case(gen, S, C, nh, g, d, bs, M, ctx,
                                            dt)
            kq, ks = absmax_quantize_int8(kp, axis=-1)
            vq, vs = absmax_quantize_int8(vp, axis=-1)
            kind = "decode" if C == 1 else "prefill"
            for quantized, pools in ((False, (kp, vp, (None, None))),
                                     (True, (kq, vq, (ks, vs)))):
                out, ref = _run_paged(pa, q, pools[0], pools[1], bt, cl,
                                      pools[2], window, bq)
                again, _ = _run_paged(pa, q, pools[0], pools[1], bt, cl,
                                      pools[2], window, bq, with_ref=False)
                torch.cuda.synchronize()
                variant, _, _, splits = _paged_plan(pa, q, pools[0], bt,
                                                    quantized)
                e, rel = _paged_errors(out, ref)
                name = "int8 paged attention" if quantized \
                    else "paged attention"
                what = f"{name} {label} {tag} ({variant}, {splits} splits)"
                check(torch.equal(out, again),
                      f"{what}: a second run gave other bits")
                # the other variant (bf16 only) and one split, forced
                others = [(variant, 1)]
                if tag == "bf16":
                    others.append(({"mma": "simt", "simt": "mma"}[variant],
                                   None))
                rels = {variant: rel}
                errs = []
                for v_, sp in others:
                    o2 = pa._ragged_call(
                        q, pools[0], pools[1], bt, cl, *pools[2],
                        scale=1.0 / math.sqrt(d), window=window,
                        variant=v_, splits=sp)
                    torch.cuda.synchronize()
                    e2, rel2 = _paged_errors(o2, ref)
                    errs.append(f"{v_} {sp or 'planned'} splits {e2:.3g}")
                    e = max(e, e2)
                    rels[v_] = max(rels.get(v_, 0.0), rel2)
                log(f"  {what}: max_abs_err {e:.3g} (forced: "
                    f"{'; '.join(errs)}); bitwise equal on a second run"
                    + ("; row-relative error " + ", ".join(
                        f"{v_} {r:.3g}" for v_, r in rels.items())
                       if tag == "bf16" else ""))
                check(math.isfinite(e) and e <= TOL[tag],
                      f"{what}: {e} > {TOL[tag]}")
                if tag == "bf16":
                    for v_, r in rels.items():
                        check(r <= PAGED_ROW_REL,
                              f"{what}: {v_} row-relative error {r} > "
                              f"{PAGED_ROW_REL}")
                        row_rel[v_] = max(row_rel[v_], r)
                err[quantized][kind][tag] = max(err[quantized][kind][tag], e)

    log(f"  paged attention bf16, largest row-relative error over every "
        f"case: mma {row_rel['mma']:.3g}, simt {row_rel['simt']:.3g} "
        f"(limit {PAGED_ROW_REL})")
    results["paged_bf16_row_relative_error"] = row_rel
    # timing, bf16: A at Llama-2-7B's serving shapes (its path), A' at
    # Falcon-7B's (its path) and at Llama-2-7B's, to be read beside A;
    # each with the sweep of the key splits
    llama = dict(nh=32, g=32, d=128)
    falcon = dict(nh=71, g=1, d=64)
    lib = "SDPA over a pre-gathered dense K/V (gather not timed)"
    lib8 = ("SDPA over a pre-gathered, pre-dequantised bf16 K/V "
            "(neither timed)")
    log("  times: 50 calls as the host issues them, between CUDA events; "
        "device: a CUDA graph of 20 calls replayed (device time a call)")
    for kind, (S, C, ctx) in (("decode", (8, 1, [1000] * 8)),
                              ("prefill", (1, 64, [1000]))):
        t = _time_paged(gen, pa, S, C, ctx, quantized=False, sweep=True,
                        **llama)
        results[f"paged_{kind}"] = dict(
            name=f"paged_attention_{kind}", route="cuda",
            source="megatron_llm_torch/csrc/paged_attention.cu",
            replaces="megatron_llm_tpu/ops/pallas/paged_attention.py:133",
            max_abs_err=err[False][kind]["bf16"],
            max_abs_err_fp32=err[False][kind]["fp32"], **t)
        _log_times(f"paged attention {kind} (A)", t, lib)
        tq = _time_paged(gen, pa, S, C, ctx, quantized=True, sweep=True,
                         **falcon)
        tq_llama = _time_paged(gen, pa, S, C, ctx, quantized=True, **llama)
        results[f"paged_{kind}_int8"] = dict(
            name=f"paged_attention_{kind}_int8", route="cuda",
            source="megatron_llm_torch/csrc/paged_attention.cu",
            replaces="megatron_llm_tpu/ops/pallas/paged_attention.py:217",
            max_abs_err=err[True][kind]["bf16"],
            max_abs_err_fp32=err[True][kind]["fp32"],
            llama_shape=tq_llama, **tq)
        _log_times(f"int8 paged attention {kind} (A')", tq, lib8)
        _log_times(f"int8 paged attention {kind} (A')", tq_llama, lib8)

    # the rows threshold: decode of 8 slots at context 1000 with 1, 2, 4,
    # 8, 16 and 32 query rows a KV group, each variant at its planned
    # splits
    sweep = {}
    for label, nh, g, d in (("MHA, qpg 1", 32, 32, 128),
                            ("GQA g16, qpg 2", 32, 16, 128),
                            ("GQA g8, qpg 4", 32, 8, 128),
                            ("Gemma-2B, qpg 8", 8, 1, 256),
                            ("GQA g2, qpg 16", 32, 2, 128),
                            ("MQA, qpg 32", 32, 1, 128)):
        q, kp, vp, bt, cl = _paged_case(gen, 8, 1, nh, g, d, 16, 128,
                                        [1000] * 8, torch.bfloat16)
        row = {}
        for v_ in ("simt", "mma"):
            splits = _paged_plan(pa, q, kp, bt, False, v_)[3]
            row[v_] = dict(splits=splits, ms=graph_ms(
                lambda v_=v_: pa._ragged_call(
                    q, kp, vp, bt, cl, None, None, scale=1.0 / math.sqrt(d),
                    window=None, variant=v_)))
        row["planned"] = _paged_plan(pa, q, kp, bt, False)[0]
        sweep[label] = row
        log(f"  rows threshold, decode S=8 ctx 1000 {label} (nh={nh} g={g} "
            f"d={d}): simt {row['simt']['ms']:.4f} ms "
            f"({row['simt']['splits']} splits), mma "
            f"{row['mma']['ms']:.4f} ms ({row['mma']['splits']} splits); "
            f"planned {row['planned']}")
    results["paged_rows_threshold_sweep"] = sweep


# ---------------------------------------------------------------------------
# phase 2: the serving slice at Llama-2-7B width
# ---------------------------------------------------------------------------

def _put(port: int, payload: dict, timeout: float = 600.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api", data=json.dumps(payload).encode(),
        method="PUT", headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def _serve_wave(port, prompts, new_tokens):
    """PUT every prompt concurrently; returns the token lists in order."""
    out = [None] * len(prompts)
    errors = []

    def client(i):
        try:
            code, body = _put(port, {
                "prompts": [" ".join(map(str, prompts[i]))],
                "tokens_to_generate": new_tokens, "temperature": 0.0})
            out[i] = (code, body)
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(f"request {i}: {type(exc).__name__}: {exc}")

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    check(not errors, "; ".join(errors))
    for i, (code, body) in enumerate(out):
        check(code == 200, f"request {i}: HTTP {code} {body}")
    return [body["tokens"][0] for _, body in out]


def _paged_logits(model, params, tokens, chunk=64, quantized=False):
    """Teacher-forced logits of ``tokens`` through the paged path with
    its kernels: chunked prefill into a fresh one-slot pool (int8 when
    ``quantized``)."""
    import torch

    from megatron_llm_torch.models.language_model import (
        language_model_forward)
    from megatron_llm_torch.text_generation.generation import (
        init_paged_kv_caches)

    cfg = model.cfg
    bs = 16
    M = -(-len(tokens) // bs) + chunk // bs
    pages = init_paged_kv_caches(cfg, 1 + M, bs, device="cuda",
                                 quantized=quantized)
    bt = torch.arange(1, M + 1, dtype=torch.int32, device="cuda")[None]
    out = []
    for start in range(0, len(tokens), chunk):
        part = tokens[start:start + chunk]
        toks = torch.zeros((1, chunk), dtype=torch.long, device="cuda")
        toks[0, :len(part)] = torch.tensor(part, device="cuda")
        caches = [dict(p, block_tables=bt,
                       context_lens=torch.tensor([start], dtype=torch.int32,
                                                 device="cuda"),
                       valid_lens=torch.tensor([len(part)],
                                               dtype=torch.int32,
                                               device="cuda"))
                  for p in pages]
        pos = start + torch.arange(chunk, device="cuda")[None]
        with torch.no_grad():
            logits, _ = language_model_forward(params, toks, pos, None, cfg,
                                               kv_caches=caches)
        out.append(logits[0, :len(part)].float())
    return torch.cat(out)


def _plain_path(cfg):
    """The config of the path that launches no kernel: plain norms and
    core_attention."""
    return cfg.replace(use_fused_rmsnorm=False, use_fused_layernorm=False,
                       use_flash_attn=False)


def _no_cache_logits(model, params, tokens, cfg=None):
    """Teacher-forced logits [T, V] of ``tokens`` through the no-cache
    forward with plain norms and core_attention (no kernel)."""
    import torch

    from megatron_llm_torch.models.language_model import (
        language_model_forward)

    inp = torch.tensor([tokens], device="cuda")
    with torch.no_grad():
        return language_model_forward(params, inp, None, None,
                                      _plain_path(cfg or model.cfg)
                                      )[0].float()


def _token_check(model, params, tokens, n_prompt, quantized, margin_bound):
    """Served tokens vs the bf16 no-cache argmax.  Returns (positions
    above the margin bound, agreements among them, positions, and the
    spread of the bf16 teacher-forced logits of the two paths)."""
    import torch

    logits = _no_cache_logits(model, params, tokens[:-1])
    paged = _paged_logits(model, params, tokens[:-1], quantized=quantized)
    diff = (paged - logits).abs().flatten()
    k999 = max(1, math.ceil(0.999 * diff.numel()))
    spread = dict(mean_abs_diff=diff.mean().item(),
                  p999_abs_diff=diff.kthvalue(k999).values.item(),
                  max_abs_diff=diff.max().item(),
                  logit_std=logits.std().item())
    gen = logits[n_prompt - 1:]                 # predicts tokens[n_prompt:]
    want = torch.tensor(tokens[n_prompt:], device="cuda")
    top2 = torch.topk(gen, 2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > margin_bound
    agree = gen.argmax(dim=-1) == want
    return (int(sure.sum()), int((agree & sure).sum()), int(want.numel()),
            spread)


def _cow_check(engine, prompts, served, n_new=4):
    """Copy-on-write on the card.  The engine shares only full pages that
    end before a request's last prompt token, so no request ever writes
    into a shared page and served traffic never needs the copy (it
    guards the swapped-in pages of the host KV tier, a later slice).  So
    this drives it directly, as tests/test_torch_engine.py does on the
    CPU: two requests adopt the same cached pages, the write barrier is
    forced on the first one's page 0, and the copy must equal its source
    bit for bit in every pool array of every layer (the int8 pages and
    their scales, where the pool is int8) while both requests still give
    their served tokens.  Runs on the stopped engine, single-stepped."""
    import torch

    from megatron_llm_torch.serving import SamplingParams
    from megatron_llm_torch.serving.request import RequestState

    st = engine._st
    reqs = [engine.submit(p, SamplingParams(max_new_tokens=n_new,
                                            temperature=0.0))
            for p in prompts]
    engine.step()                       # admits both, prefills one
    a, b = reqs
    check(a.cached_prompt_tokens > 0 and b.cached_prompt_tokens > 0,
          f"COW check: cached tokens {a.cached_prompt_tokens}, "
          f"{b.cached_prompt_tokens}")
    old = int(st.blocks.tables[a.slot, 0])
    check(old == int(st.blocks.tables[b.slot, 0]),
          "COW check: the two requests do not share page 0")
    copies = st.blocks.stats()["cow_copies"]
    engine._writable(st, a.slot, 0)
    new = int(st.blocks.tables[a.slot, 0])
    check(new != old and st.blocks.stats()["cow_copies"] == copies + 1,
          "COW check: the write barrier did not copy the shared page")
    torch.cuda.synchronize()
    for layer in st.pages:
        for name, pool in layer.items():
            check(torch.equal(pool[new], pool[old]),
                  f"COW check: {name} page {new} differs from page {old}")
    for _ in range(1000):
        if all(r.state == RequestState.DONE for r in reqs):
            break
        engine.step()
    for r, p, s in zip(reqs, prompts, served):
        check(r.tokens == s[:len(p) + n_new],
              "COW check: a request's tokens changed after the copy")
    return a.cached_prompt_tokens, b.cached_prompt_tokens, sorted(st.pages[0])


def _decode_profile(engine, prefix, vocab, tag, n_steps=8):
    """Where a decode step of the full 8-slot batch goes, on the stopped
    engine, single-stepped: 8 requests that share the cached ``prefix``
    (so each prefills one chunk) reach decode, then ``n_steps`` decode
    steps are timed on the host's clock and ``n_steps`` more run under
    torch.profiler.  Returns (unprofiled ms a step, device-busy ms a step,
    ms a step by kernel group): a device that is busy for a small share of
    the step waits for the host's eager launches."""
    import numpy as np
    import torch

    from megatron_llm_torch.serving import SamplingParams
    from megatron_llm_torch.serving.request import RequestState

    rng = np.random.RandomState(4321)
    reqs = [engine.submit(prefix + rng.randint(0, vocab, size=8).tolist(),
                          SamplingParams(max_new_tokens=8 * n_steps,
                                         temperature=0.0))
            for _ in range(8)]

    def decoding():
        return all(r.state == RequestState.DECODE for r in reqs)

    for _ in range(100):
        if decoding():
            break
        engine.step()
    check(decoding(), "decode profile: the 8 requests did not reach decode")

    def steps():
        for _ in range(n_steps):
            engine.step()
        torch.cuda.synchronize()

    steps()
    t0 = time.perf_counter()
    steps()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    groups, device_ms, _ = _profile_step(steps, tag)
    check(decoding(),
          "decode profile: a request finished inside the timed steps")
    engine.stop()                       # aborts the 8 requests
    return (wall_ms, device_ms / n_steps,
            {k: v / n_steps for k, v in groups.items()})


def _prefill_profile(engine, prefix, vocab, tag, variant, n_chunks=4):
    """Where a prefill chunk goes, on the stopped engine, single-stepped:
    requests of the cached ``prefix`` (whole pages) plus one chunk of new
    tokens, asking for one token, so that one step admits a request and
    runs its one prefill chunk, whose first token ends it.  ``n_chunks``
    of them are timed on the host's clock, ``n_chunks`` more run under
    torch.profiler.  Checks that each chunk's paged reads took
    ``variant``.  Returns (unprofiled ms a chunk, device-busy ms a chunk,
    ms a chunk by kernel group)."""
    import numpy as np
    import torch

    from megatron_llm_torch.serving import SamplingParams

    rng = np.random.RandomState(8765)
    C = engine.config.prefill_chunk
    L = engine.model.cfg.num_layers

    def chunks():
        for _ in range(n_chunks):
            req = engine.submit(prefix + rng.randint(0, vocab, C).tolist(),
                                SamplingParams(max_new_tokens=1,
                                               temperature=0.0))
            engine.step()
            check(req.cached_prompt_tokens == len(prefix)
                  and len(req.out_tokens) == 1,
                  f"prefill profile: a request cached "
                  f"{req.cached_prompt_tokens} tokens and made "
                  f"{len(req.out_tokens)} in one step")
        torch.cuda.synchronize()

    chunks()
    before = (engine.stats()["prefill_chunks"], _paged_variants())
    t0 = time.perf_counter()
    chunks()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_chunks
    after = (engine.stats()["prefill_chunks"], _paged_variants())
    check(after[0] - before[0] == n_chunks,
          f"prefill profile: {after[0] - before[0]} chunks for {n_chunks} "
          f"steps")
    moved = {k: v - before[1].get(k, 0) for k, v in after[1].items()
             if v != before[1].get(k, 0)}
    check(moved == {variant: L * n_chunks},
          f"prefill profile: paged launches by variant {moved}, expected "
          f"{ {variant: L * n_chunks} }")
    groups, device_ms, _ = _profile_step(chunks, tag)
    return (wall_ms, device_ms / n_chunks,
            {k: v / n_chunks for k, v in groups.items()})


def _fp32_path_check(model, params, tokens, quantized):
    """Max |logit diff| between the paged path (its kernels, fp32
    variants) and the no-cache path, with fp32 params and compute, over
    plain pools and, when ``quantized``, over int8 pools too.  Returns
    (plain-pool diff, int8-pool diff or None, max |logit|, logit std)."""
    import torch

    from megatron_llm_torch.tree import tree_map

    cfg32 = model.cfg.replace(params_dtype="fp32", compute_dtype="fp32")
    p32 = tree_map(lambda t: t.float(), params)
    model32 = type(model)(cfg32, device=model.device)
    ref = _no_cache_logits(model32, p32, tokens, cfg32)
    diff = (_paged_logits(model32, p32, tokens) - ref).abs().max().item()
    diff8 = None
    if quantized:
        diff8 = (_paged_logits(model32, p32, tokens, quantized=True)
                 - ref).abs().max().item()
    scale, std = ref.abs().max().item(), ref.std().item()
    del p32
    torch.cuda.empty_cache()
    return diff, diff8, scale, std


def _serving_counts():
    """Launches of the serving kernels since they were last zeroed."""
    from megatron_llm_torch.ops.kernels import layernorm as ln
    from megatron_llm_torch.ops.kernels import paged_attention as pa
    from megatron_llm_torch.ops.kernels import rmsnorm as rn

    return {"B": rn.launches, "D": ln.launches,
            "A decode": pa.decode_launches,
            "A prefill": pa.prefill_launches,
            "A' decode": pa.quant_decode_launches,
            "A' prefill": pa.quant_prefill_launches}


def _norm_plan_launches(counts):
    """B's, C's, D's and E's launches by plan since the last zeroing
    (kernels with none left out), checked against their counts in
    ``counts``."""
    from megatron_llm_torch.ops.kernels import layernorm as ln
    from megatron_llm_torch.ops.kernels import rmsnorm as rn

    out = {}
    for key, by_plan in (("B", rn.plan_launches), ("C", rn.bwd_plan_launches),
                         ("D", ln.plan_launches),
                         ("E", ln.bwd_plan_launches)):
        check(sum(by_plan.values()) == counts[key],
              f"{key}'s launches by plan {by_plan} do not add up to "
              f"{counts[key]}")
        if by_plan:
            out[key] = {str(list(p)): n for p, n in by_plan.items()}
    return out


def _paged_variants():
    """Paged-attention launches by kernel variant since the last zeroing
    (variants with none left out)."""
    from megatron_llm_torch.ops.kernels import paged_attention as pa

    return {k: v for k, v in pa.variant_launches.items() if v}


def _merges():
    from megatron_llm_torch.ops.kernels import paged_attention as pa

    return pa.merge_launches


# the two serving workloads: the same traffic through two model families
SERVING = {
    "llama": dict(
        label="Llama-2-7B", model_name="llama2", vocab=32000, quantized=False,
        # max_model_len cut from 4096 to 2048 to halve the KV pool
        # (8 slots x 2048 tokens), default serve flags
        flags=["--serve_max_model_len", "2048"],
        # kernel row -> (count key, launches per layer and dispatch kind)
        norm=("rmsnorm", "B", lambda L: 2 * L + 1),
        decode=("paged_decode", "A decode"),
        prefill=("paged_prefill", "A prefill"),
        # the paged kernel variant of a decode step (one query row a KV
        # group) and of a prefill chunk (64)
        variants=("simt", "mma"),
        margin_bound=MARGIN_BOUND, min_checked=MIN_CHECKED_FRACTION),
    "falcon": dict(
        label="Falcon-7B", model_name="falcon", vocab=65024, quantized=True,
        # max_model_len 2048 is the model's own
        flags=["--int8_kv_cache", "--serve_max_model_len", "2048"],
        # the parallel block has one norm a layer
        norm=("layernorm", "D", lambda L: L + 1),
        decode=("paged_decode_int8", "A' decode"),
        prefill=("paged_prefill_int8", "A' prefill"),
        # 71 query rows a KV group at decode, 64 x 71 in a prefill chunk
        variants=("mma", "mma"),
        margin_bound=MARGIN_BOUND, min_checked=INT8_MIN_CHECKED_FRACTION),
}


def _add_launches(kernels, row, phase, n):
    """Add a path's launch count to a kernel's row of the last line."""
    k = kernels[row]
    k["launches"] = k.get("launches", 0) + n
    k.setdefault("launches_by_phase", {})[phase] = n


def serve_phase(results, kernels, spec):
    import numpy as np
    import torch

    from megatron_llm_torch.run_text_generation_server import (
        build_parser, build_server)
    from megatron_llm_torch.tokenizer import NullTokenizer

    new_tokens = 64
    vocab = spec["vocab"]
    argv = ["--model_name", spec["model_name"], "--bf16", "--seed", "1234",
            "--host", "127.0.0.1", "--port", "0"] + spec["flags"]
    args = build_parser().parse_args(argv)
    t0 = time.perf_counter()
    server = build_server(args, NullTokenizer(vocab))
    engine = server.engine
    log(f"  model + engine + warmup: {time.perf_counter() - t0:.1f} s; "
        f"{engine.model.num_params(engine.params) / 1e9:.2f} B params; "
        f"paged_kernel={engine.paged_kernel} "
        f"prefill_kernel={engine.prefill_kernel}; pool arrays "
        f"{sorted(engine._st.pages[0])}")
    check(("k_pages_q" in engine._st.pages[0]) == spec["quantized"],
          f"pool arrays {sorted(engine._st.pages[0])}")
    httpd = server.make_httpd("127.0.0.1", 0)
    port = httpd.server_address[1]
    srv = threading.Thread(target=server.run, daemon=True)
    srv.start()
    records = []
    hook = engine.request_done_hook

    def collect(rec):
        records.append(rec)
        hook(rec)

    engine.request_done_hook = collect
    try:
        check(_get(port, "/health")[1].get("status") == "ok", "/health")
        rng = np.random.RandomState(1234)
        lens = [100, 250, 400, 600, 800, 1000, 1200, 1500]
        prompts = [rng.randint(0, vocab, size=n).tolist() for n in lens]
        # wave 2: a prompt sharing the first 992 tokens (62 full pages)
        # of prompt 5, whose pages are cached by then, and an exact
        # repeat of prompt 2 (400 tokens: its first 24 pages, 384 tokens,
        # are cached; the page holding the last prompt token never is)
        shared = prompts[5][:992] + rng.randint(0, vocab, 158).tolist()
        # cached tokens of each request, by prompt length, in order
        want_hits = {len(shared): [992], len(prompts[2]): [0, 384]}
        s0 = engine.stats()
        _zero_counts()
        t_wave = time.perf_counter()
        outs = _serve_wave(port, prompts, new_tokens)
        outs2 = _serve_wave(port, [shared, prompts[2]], new_tokens)
        wall = time.perf_counter() - t_wave
        # a request's record follows its answer: wait for the last ones
        deadline = time.monotonic() + 30
        while len(records) < 10 and time.monotonic() < deadline:
            time.sleep(0.01)
        check(len(records) == 10, f"{len(records)} request_done records")
        launches = _serving_counts()
        variants = _paged_variants()
        training = {k: v for k, v in _counts().items() if k in "CEFGH"}
        norm_plans = _norm_plan_launches(_counts())
        s1 = engine.stats()
        for p, o in zip(prompts + [shared], outs + outs2[:1]):
            check(o[:len(p)] == p and len(o) == len(p) + new_tokens,
                  f"a request returned {len(o)} tokens for a "
                  f"{len(p)}-token prompt")
        check(outs2[1] == outs[2], "repeating a request changed its tokens")
        check(s1["paged_kernel"] == s1["prefill_kernel"] == "cuda",
              f"kernel paths {s1['paged_kernel']}/{s1['prefill_kernel']}")
        fin = {k: s1["finished"].get(k, 0) - s0["finished"].get(k, 0)
               for k in s1["finished"]}
        check(fin == {"length": 10}, f"finish reasons {fin}")
        hit = s1["prefix_cache_hit_tokens"] - s0["prefix_cache_hit_tokens"]
        got_hits = {}
        for r in records:
            got_hits.setdefault(r["prompt_tokens"], []).append(
                r["cached_prompt_tokens"])
        check({n: got_hits.get(n) for n in want_hits} == want_hits,
              f"prefix-cache hits by prompt length {got_hits}, expected "
              f"{want_hits}")
        check(hit == 992 + 384,
              f"{hit} prefix-cache hit tokens, expected {992 + 384}")
        L = engine.model.cfg.num_layers
        dec = s1["decode_steps"] - s0["decode_steps"]
        pre = s1["prefill_chunks"] - s0["prefill_chunks"]
        log(f"  dispatches: {dec} decode steps, {pre} prefill chunks; "
            f"launches {launches}; prefix-cache hit tokens {hit}; "
            f"COW copies {s1['cow_copies'] - s0['cow_copies']}")
        norm_row, norm_key, per_dispatch = spec["norm"]
        want = {k: 0 for k in launches}
        want[norm_key] = per_dispatch(L) * (dec + pre)
        want[spec["decode"][1]] = L * dec
        want[spec["prefill"][1]] = L * pre
        check(launches == want,
              f"serving launches {launches}, expected {want} ({L} layers, "
              f"{dec} decode steps, {pre} prefill chunks)")
        check(not any(training.values()),
              f"serving launched training kernels: {training}")
        dec_v, pre_v = spec["variants"]
        want_v = {dec_v: 0, pre_v: 0}
        want_v[dec_v] += L * dec
        want_v[pre_v] += L * pre
        log(f"  paged launches by variant {variants} (merges of split keys "
            f"{_merges()}); norm launches by plan {norm_plans}")
        results["norm_plan_launches"] = norm_plans
        check(variants == want_v,
              f"paged launches by variant {variants}, expected {want_v} "
              f"(decode steps on {dec_v}, prefill chunks on {pre_v})")
        results["paged_variant_launches"] = variants
        phase = f"serving {spec['label']}"
        _add_launches(kernels, norm_row, phase, launches[norm_key])
        for row, key in (spec["decode"], spec["prefill"]):
            _add_launches(kernels, row, phase, launches[key])

        # independent check: no-cache forward through no kernel; the fp32
        # paged path takes the CUDA-core kernel only
        before = _paged_variants()
        diff, diff8, scale, std = _fp32_path_check(
            engine.model, engine.params, outs[5][:-1], spec["quantized"])
        moved = {k: v - before.get(k, 0)
                 for k, v in _paged_variants().items()
                 if v != before.get(k, 0)}
        check(list(moved) == ["simt"],
              f"the fp32 paged path launched {moved}, expected simt only")
        tol = FP32_PLAIN_POOL_TOL if spec["quantized"] else FP32_LOGIT_TOL
        log(f"  fp32 teacher-forced logits, paged over plain pools (its "
            f"kernels) vs no-cache (none), {len(outs[5]) - 1} tokens: max "
            f"|diff| {diff:.3g} (max |logit| {scale:.3g}, tolerance {tol})")
        check(diff <= tol, f"fp32 paged vs no-cache logits differ by {diff}")
        results["fp32_paged_vs_no_cache_max_abs"] = diff
        if diff8 is not None:
            log(f"  fp32 teacher-forced logits, paged over int8 pools vs "
                f"no-cache: max |diff| {diff8:.3g}, {diff8 / std:.3g} of "
                f"the logits' std {std:.3g} (bound "
                f"{INT8_LOGIT_DRIFT_BOUND}: quantisation, not summation "
                f"order)")
            check(diff8 <= INT8_LOGIT_DRIFT_BOUND * std,
                  f"fp32 int8 paged vs no-cache logits differ by {diff8}, "
                  f"{diff8 / std} of their std")
            check(diff8 > diff, "the int8 pools are as exact as the plain "
                                "ones: they were not quantised")
            results["fp32_int8_paged_vs_no_cache_max_abs"] = diff8
            results["fp32_logit_std"] = std
        for i in (2, 5):
            n_sure, n_agree, n, spread = _token_check(
                engine.model, engine.params, outs[i], len(prompts[i]),
                spec["quantized"], spec["margin_bound"])
            log(f"  bf16 no-cache check, prompt {len(prompts[i])}: "
                f"{n_agree}/{n_sure} served tokens agree where the top-2 "
                f"margin > {spec['margin_bound']} ({n} positions); bf16 "
                f"teacher-forced logits, paged vs no-cache: "
                + ", ".join(f"{k} {v:.4g}" for k, v in spread.items()))
            results[f"bf16_paged_vs_no_cache_prompt{len(prompts[i])}"] = \
                dict(spread, checked=n_sure, agreed=n_agree, positions=n)
            check(n_sure >= spec["min_checked"] * n,
                  f"only {n_sure}/{n} positions above the margin bound")
            check(n_agree == n_sure,
                  f"no-cache forward disagrees at {n_sure - n_agree} "
                  f"positions")

        met = _get(port, "/metrics")[1]
        check(met["engine"]["paged_kernel"] == "cuda", "/metrics engine")
        ttft = sorted(r["ttft_secs"] for r in records)
        dec_tok = (s1["tokens_generated"] - s0["tokens_generated"]
                   - len(records))
        dec_secs = s1["decode_secs"] - s0["decode_secs"]
        results.update(
            requests=len(records), wall_secs=wall,
            ttft_p50_secs=ttft[len(ttft) // 2], ttft_max_secs=ttft[-1],
            decode_tokens_per_sec=dec_tok / dec_secs if dec_secs else None,
            decode_step_ms=1e3 * dec_secs / max(dec, 1),
            prefill_chunk_ms=1e3 * (s1["prefill_secs"] - s0["prefill_secs"])
            / max(pre, 1),
            mean_batch_occupancy=((s1["mean_batch_occupancy"] * s1[
                "decode_steps"] - s0["mean_batch_occupancy"]
                * s0["decode_steps"]) / max(dec, 1)))
    finally:
        server.shutdown()
        engine.stop()
        srv.join(30)
    cow0 = engine.stats()["cow_copies"]
    hits = _cow_check(engine, [prompts[5], shared], [outs[5], outs2[0]])
    cow = engine.stats()["cow_copies"] - cow0
    log(f"  copy-on-write on the card: {cow} page copy of page 0, shared "
        f"by two requests with {hits[0]} and {hits[1]} cached tokens; the "
        f"copy equals its source in {hits[2]} of every layer and both "
        f"requests kept their served tokens")
    results["cow_copies_forced"] = cow
    wall_ms, device_ms, groups = _decode_profile(
        engine, prompts[5][:992], vocab, "decode_" + spec["label"].lower())
    idle = 1 - device_ms / wall_ms if device_ms > 0 else None
    if device_ms > 0:
        log(f"  decode step of 8 slots at context ~1000 under "
            f"torch.profiler: device busy {device_ms:.1f} ms of an "
            f"unprofiled step of {wall_ms:.1f} ms (idle share {idle:.3f}); "
            f"device ms by kernel: "
            + ", ".join(f"{k} {v:.2f}" for k, v in groups.items() if v))
    else:
        log(f"  decode step of 8 slots at context ~1000: {wall_ms:.1f} ms; "
            f"torch.profiler recorded no device time (idle share not "
            f"measured)")
    results["decode_profile"] = dict(
        step_ms=wall_ms, device_ms=device_ms, idle_share=idle,
        device_ms_by_kernel=groups)
    wall_ms, device_ms, groups = _prefill_profile(
        engine, prompts[5][:992], vocab, "prefill_" + spec["label"].lower(),
        spec["variants"][1])
    idle = 1 - device_ms / wall_ms if device_ms > 0 else None
    if device_ms > 0:
        log(f"  prefill chunk of 64 tokens at context 992 under "
            f"torch.profiler: device busy {device_ms:.1f} ms of an "
            f"unprofiled chunk of {wall_ms:.1f} ms (idle share {idle:.3f});"
            f" device ms by kernel: "
            + ", ".join(f"{k} {v:.2f}" for k, v in groups.items() if v))
    else:
        log(f"  prefill chunk of 64 tokens at context 992: {wall_ms:.1f} "
            f"ms; torch.profiler recorded no device time (idle share not "
            f"measured)")
    results["prefill_profile"] = dict(
        chunk_ms=wall_ms, device_ms=device_ms, idle_share=idle,
        device_ms_by_kernel=groups)


# ---------------------------------------------------------------------------
# phase 1, training kernels: C, F, G and H against their plain versions
# ---------------------------------------------------------------------------

def _attn_pairs(b, nh, sq, sk, window):
    """Visible query-key pairs of causal(+window) attention, over heads
    and batch: the work this input needs."""
    pairs = 0
    for q in range(sq):
        hi = min(q, sk - 1)
        lo = 0 if window is None else max(0, q - window + 1)
        pairs += max(0, hi - lo + 1)
    return b * nh * pairs


def _attn_bound(b, s, nh, ng, d, window, backward):
    """(bound_ms, bound_by) of flash attention in bf16: the forward's 2
    block products (QK^T, PV), the backward's 5 (S recomputed, dP, dV,
    dK, dQ), over the visible pairs; bytes: each input read once and
    each output written once (forward q, k, v -> o, lse; backward q, k,
    v, o, do, lse -> dq, dk, dv)."""
    pairs = _attn_pairs(b, nh, s, s, window)
    qb = b * s * nh * d * 2
    kvb = 2 * b * s * ng * d * 2
    lse = b * nh * s * 4
    if backward:
        return bound(4 * qb + 2 * kvb + lse, 5 * 2 * pairs * d, BF16_FLOPS)
    return bound(2 * qb + kvb + lse, 2 * 2 * pairs * d, BF16_FLOPS)


def _grad_errors(got, want):
    """(max-abs error, max of error over the leaf's max-abs) over
    (dq, dk, dv)."""
    e_abs = e_rel = 0.0
    for g, r in zip(got, want):
        e = (g.float() - r.float()).abs().max().item()
        e_abs = max(e_abs, e)
        e_rel = max(e_rel, e / max(r.float().abs().max().item(), 1e-6))
    return e_abs, e_rel


def _time_attention_shape(gen, b, s, nh, ng, d):
    """F and G in bf16 at one attention shape: kernel, plain version and
    SDPA (on K/V expanded to the nh query heads) times, and the bound."""
    import torch
    import torch.nn.functional as F

    from megatron_llm_torch.ops.kernels import build
    from megatron_llm_torch.ops.kernels import flash_attention as fa

    q, do = (torch.randn(b, s, nh, d, device="cuda",
                         generator=gen).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, s, ng, d, device="cuda",
                        generator=gen).to(torch.bfloat16) for _ in range(2))
    scale = 1.0 / math.sqrt(d)
    qt, kt, vt = (t_.transpose(1, 2).expand(b, nh, s, d).contiguous()
                  for t_ in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    o, lse = fa.flash_attention_fwd_kernel(q, k, v, True, None, scale)
    qr, kr, vr = (t_.detach().requires_grad_(True) for t_ in (qt, kt, vt))
    out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
    shape = f"b={b} s={s} nh={nh} g={ng} d={d} causal bf16"
    res = {}
    for key, backward, run, plain, lib in (
            ("F", False,
             lambda: fa.flash_attention_fwd_kernel(q, k, v, True, None,
                                                   scale),
             lambda: fa._reference_attention(q, k, v, True, None, scale),
             lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                    is_causal=True)),
            ("G", True,
             lambda: fa.flash_attention_bwd_kernel(q, k, v, o, lse, do, True,
                                                   None, scale),
             lambda: fa._reference_attention_bwd(q, k, v, o, lse, do, True,
                                                 None, scale),
             lambda: torch.autograd.grad(out, (qr, kr, vr), dot,
                                         retain_graph=True))):
        b_ms, b_by = _attn_bound(b, s, nh, ng, d, None, backward)
        res[key] = dict(ms=time_ms(run, iters=10),
                        plain_ms=time_ms(plain, iters=2, warmup=1),
                        library_ms=time_ms(lib, iters=10), bound_ms=b_ms,
                        bound_by=b_by, shape=shape)
        _log_times(f"flash attention ({key})", res[key],
                   f"SDPA on K/V expanded to {nh} heads")
    res["G"]["head_splits"] = fa.head_splits(
        b, s, ng, nh // ng, fa.TILES[(torch.bfloat16, d)][1][1],
        build.sm_count(q.device))
    del q, k, v, do, qt, kt, vt, dot, o, lse, qr, kr, vr, out
    torch.cuda.empty_cache()
    return res


# H's kernels by name substring: its passes' device times come from
# torch.profiler over the calls
_H_PASSES = (("prep", "flash_bwd_prep"), ("dq", "flash_bwd_dq"),
             ("dkv", "flash_bwd_kv"), ("sum", "flash_dkv_sum"))
# H's timing shapes (b, s, nh, ng, d), causal, bf16: Llama-2-7B's
# attention at the sequence-1000 step, Falcon-7B's, Gemma-7B's
H_SHAPES = {"llama": (1, 1000, 32, 32, 128), "falcon": (1, 1000, 71, 1, 64),
            "gemma": (1, 1000, 16, 16, 256)}
# D's timing rows (Falcon-7B's width): decode and a training micro-batch
D_SHAPES = ((8, 4544), (2048, 4544))


def _device_ms_by_pass(run, calls, passes=_H_PASSES):
    """Device ms a call of each of ``passes`` (name, kernel-name
    substring), from torch.profiler over ``calls`` calls of ``run``, and
    of all kernels under "all" (None where the profiler saw none)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    ms = {name: 0.0 for name, _ in passes}
    ms["all"] = 0.0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        t = evt.self_device_time_total / 1e3 / calls
        ms["all"] += t
        for name, key in passes:
            if key in evt.key:
                ms[name] += t
    if not ms["all"]:
        return {name: None for name in ms}
    return ms


def h_and_d_times(gen):
    """H (the two-pass flash backward) at H_SHAPES and D (the LayerNorm
    forward) at D_SHAPES, bf16: eager ms (the host issuing the calls), the
    device ms of H and its passes (torch.profiler) and of D (a CUDA graph
    replayed), beside SDPA's backward on K/V expanded to the query heads
    (eager and device) and F.layer_norm in the same process, and each
    bound.  Calls only the wrappers' public entry points."""
    import torch
    import torch.nn.functional as F

    from megatron_llm_torch.ops.kernels import flash_attention as fa
    from megatron_llm_torch.ops.kernels import layernorm as ln

    out = {"H": {}, "D": {}}
    runs, libs = {}, {}
    for name, (b, s, nh, ng, d) in H_SHAPES.items():
        q, do = (torch.randn(b, s, nh, d, device="cuda",
                             generator=gen).to(torch.bfloat16)
                 for _ in range(2))
        k, v = (torch.randn(b, s, ng, d, device="cuda",
                            generator=gen).to(torch.bfloat16)
                for _ in range(2))
        scale = 1.0 / math.sqrt(d)
        o, lse = fa.flash_attention_fwd_kernel(q, k, v, True, None, scale)
        runs[name] = functools.partial(fa.flash_attention_bwd_kernel, q, k,
                                       v, o, lse, do, True, None, scale)
        qr, kr, vr = (t_.transpose(1, 2).expand(b, nh, s, d).contiguous()
                      .requires_grad_(True) for t_ in (q, k, v))
        dot = do.transpose(1, 2).contiguous()
        sdpa = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
        libs[name] = functools.partial(torch.autograd.grad, sdpa,
                                       (qr, kr, vr), dot, retain_graph=True)
        b_ms, b_by = _attn_bound(b, s, nh, ng, d, None, True)
        out["H"][name] = dict(
            library_ms=time_ms(libs[name], iters=10),
            ms=time_ms(runs[name], iters=10), bound_ms=b_ms, bound_by=b_by,
            shape=f"b={b} s={s} nh={nh} g={ng} d={d} causal bf16")
    for n, h in D_SHAPES:
        x = torch.randn(n, h, device="cuda", generator=gen).to(torch.bfloat16)
        sc = torch.ones(h, device="cuda", dtype=torch.bfloat16)
        bi = torch.zeros(h, device="cuda", dtype=torch.bfloat16)
        b_ms, b_by = bound(2 * n * h * 2 + 2 * h * 2 + 2 * n * 4, 8 * n * h,
                           FP32_FLOPS)

        def run():
            return ln.layer_norm_fwd_kernel(x, sc, bi, 1e-5)

        def lib():
            return F.layer_norm(x, (h,), sc, bi, 1e-5)

        row = dict(ms=time_ms(run, iters=200), device_ms=graph_ms(run),
                   library_ms=time_ms(lib, iters=200),
                   library_device_ms=graph_ms(lib), bound_ms=b_ms,
                   bound_by=b_by, shape=f"x [{n}, {h}] bf16")
        out["D"][n] = row
        log(f"  D {row['shape']}: eager {row['ms']:.4f} ms, device "
            f"{row['device_ms']:.4f} ms; F.layer_norm eager "
            f"{row['library_ms']:.4f} ms, device "
            f"{row['library_device_ms']:.4f} ms; bound {b_ms:.5f} ms "
            f"({b_by})")
    # the profiler last: SDPA and D are timed before it attaches
    for name, run in runs.items():
        row = out["H"][name]
        passes = _device_ms_by_pass(run, 10)
        row.update({f"{p}_device_ms": v_ for p, v_ in passes.items()
                    if p != "all"}, device_ms=passes["all"],
                   library_device_ms=_device_ms_by_pass(libs[name], 10,
                                                        ())["all"])
        log(f"  H {name} {row['shape']}: eager {row['ms']:.4f} ms; device "
            "by pass: " + ", ".join(
                f"{p} {v_:.4f}" if v_ is not None else f"{p} not measured"
                for p, v_ in passes.items())
            + f" ms; SDPA backward eager {row['library_ms']:.4f} ms, device "
            + (f"{row['library_device_ms']:.4f}"
               if row["library_device_ms"] is not None else "not measured")
            + f" ms; bound {row['bound_ms']:.5f} ms ({row['bound_by']})")
    del runs, libs
    torch.cuda.empty_cache()
    return out


def fwd_plan_sweep(gen, kind):
    """Device time (CUDA graph replay) of the norm forward under every
    plan ``_fwd_plans`` lists beside ``plan``'s, bf16: D (``kind`` "D")
    at D_SHAPES or B ("B") at B_SHAPES."""
    import torch

    from megatron_llm_torch.ops.kernels import layernorm as ln
    from megatron_llm_torch.ops.kernels import rmsnorm as rn

    sm = _sm_count()
    out = {}
    for n, h in (D_SHAPES if kind == "D" else B_SHAPES):
        x = torch.randn(n, h, device="cuda", generator=gen).to(torch.bfloat16)
        one = torch.ones(h, device="cuda", dtype=torch.bfloat16)
        if kind == "D":
            run = functools.partial(ln.layer_norm_fwd_kernel, x, one, one,
                                    1e-5)
        else:
            run = functools.partial(rn.rms_norm_fwd_kernel, x, one, 1e-5)
        times = {p: graph_ms(functools.partial(run, force_plan=p))
                 for p in _fwd_plans(n, h, torch.bfloat16, sm)}
        best = min(times, key=times.get)
        out[n] = {str(p): ms for p, ms in times.items()}
        log(f"  {kind} plans, x [{n}, {h}] bf16, device ms: " + ", ".join(
            f"{p}: {ms:.4f}" for p, ms in sorted(times.items(),
                                                  key=lambda kv: kv[1])[:8])
            + f"; plan() gives {ln.plan(n, h, torch.bfloat16, sm)}, best "
            f"{best}")
    return out


def _bwd_sweep(kind, name, n, h, run, sm, rms=False):
    """The device time (CUDA graph replay) of ``run(force_plan=p)``, the
    norm backward on [n, h] bf16 rows, under every (row_threads, vecs,
    rows) ``norm_plan.bwd_plans`` lists, each over one and two blocks an
    SM and over all the row groups at once, beside ``bwd_plan``'s plan."""
    import torch

    from megatron_llm_torch.ops.kernels import norm_plan

    planned = norm_plan.bwd_plan(n, h, torch.bfloat16, sm, rms)
    plans = {planned}
    for t, v, rows, _ in norm_plan.bwd_plans(n, h, torch.bfloat16, sm, rms):
        groups = -(-n // rows)
        plans |= {(t, v, rows, min(groups, k * sm)) for k in (1, 2)}
        plans.add((t, v, rows, groups))
    times = {p: graph_ms(functools.partial(run, force_plan=p))
             for p in sorted(plans)}
    best = min(times, key=times.get)
    log(f"  {kind} plans, {name} x, g [{n}, {h}] bf16, device ms: "
        + ", ".join(f"{p}: {ms:.4f}" for p, ms in sorted(
            times.items(), key=lambda kv: kv[1])[:10])
        + f"; bwd_plan gives {planned} ({times[planned]:.4f}), best {best}")
    return {str(p): ms for p, ms in times.items()}


def e_plan_sweep(gen):
    """E's device time under every plan (``_bwd_sweep``) at E_SWEEP_SHAPES:
    Falcon-7B's training rows and GPT-2's."""
    import torch

    from megatron_llm_torch.ops.kernels import layernorm as ln

    sm = _sm_count()
    out = {}
    for name, (n, h) in E_SWEEP_SHAPES.items():
        x, g = (torch.randn(n, h, device="cuda", generator=gen).to(
            torch.bfloat16) for _ in range(2))
        one = torch.ones(h, device="cuda", dtype=torch.bfloat16)
        _, mu, rstd = ln.layer_norm_fwd_kernel(x, one, one, 1e-5)
        out[name] = _bwd_sweep("E", name, n, h, functools.partial(
            ln.layer_norm_bwd_kernel, x, one, g, mu, rstd), sm)
    return out


def c_plan_sweep(gen):
    """C's device time under every plan (``_bwd_sweep``) at C_SHAPES."""
    import torch

    from megatron_llm_torch.ops.kernels import rmsnorm as rn

    sm = _sm_count()
    out = {}
    for name, (n, h) in C_SHAPES.items():
        x, g = (torch.randn(n, h, device="cuda", generator=gen).to(
            torch.bfloat16) for _ in range(2))
        one = torch.ones(h, device="cuda", dtype=torch.bfloat16)
        _, rstd = rn.rms_norm_fwd_kernel(x, one, 1e-5)
        out[name] = _bwd_sweep("C", name, n, h, functools.partial(
            rn.rms_norm_bwd_kernel, x, one, g, rstd), sm, rms=True)
    return out


def _host_us(label, parts, calls=2000, runs=1):
    """Host microseconds a call of each of ``parts`` (name -> function of
    no arguments): time.perf_counter over ``calls`` calls after a warm-up,
    the median of ``runs`` such runs, synchronised around each run
    (``calls`` few enough that the device's work never fills the launch
    queue, so the device's time a call does not hold the host)."""
    import torch

    out = {}
    for name, fn in parts.items():
        for _ in range(50):
            fn()
        times = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
        out[name] = sorted(times)[runs // 2]
    log(f"  {label} host us a call: " + ", ".join(
        f"{k} {v:.2f}" for k, v in out.items()))
    return out


def c_host_breakdown():
    """Host microseconds a call of C's wrapper at C_SHAPES["C"] bf16 and
    of its parts (the checks, the three allocations, plan, pack, the
    packed call that launches both passes), beside ``F.rms_norm``'s
    backward: ``_host_us``, the median of 5 runs of 100 calls (100 calls
    stay inside the launch queue)."""
    import torch
    import torch.nn.functional as F

    from megatron_llm_torch.ops.kernels import norm_plan
    from megatron_llm_torch.ops.kernels import rmsnorm as rn

    n, h = C_SHAPES["C"]
    bf16, f32 = torch.bfloat16, torch.float32
    x, g = (torch.randn(n, h, device="cuda").to(bf16) for _ in range(2))
    one = torch.ones(h, device="cuda", dtype=bf16)
    _, rstd = rn.rms_norm_fwd_kernel(x, one, 1e-5)
    xl, sl = (t.clone().requires_grad_(True) for t in (x, one))
    yl = F.rms_norm(xl, (h,), weight=sl, eps=1e-5)
    sm = _sm_count()
    p = norm_plan.bwd_plan(n, h, bf16, sm, True)
    dx = torch.empty_like(x)
    sums = x.new_empty((h,), dtype=f32)
    part = x.new_empty((p[3], h), dtype=f32)
    packed = norm_plan.BWD_CALL.pack(
        x.data_ptr(), one.data_ptr(), g.data_ptr(), 0, rstd.data_ptr(),
        dx.data_ptr(), part.data_ptr(), sums.data_ptr(),
        torch._C._cuda_getCurrentRawStream(0), n, h, 1, 1, *p, 1)
    entry = norm_plan.entry("mlt_norm_bwd")
    return _host_us(f"C, x, g [{n}, {h}] bf16", {
        "wrapper": lambda: rn.rms_norm_bwd_kernel(x, one, g, rstd),
        "F.rms_norm backward (autograd.grad)": lambda: torch.autograd.grad(
            yl, (xl, sl), g, retain_graph=True),
        "checks (norm_plan.bwd_checks)": lambda: norm_plan.bwd_checks(
            "rmsnorm backward", x, one, g, None, rstd),
        "allocations (dx, dscale, partials)": lambda: (
            torch.empty_like(x), x.new_empty((h,), dtype=f32),
            x.new_empty((p[3], h), dtype=f32)),
        "plan": lambda: norm_plan.bwd_plan(n, h, bf16, sm, True),
        "stream handle": lambda: torch._C._cuda_getCurrentRawStream(0),
        "pack": lambda: norm_plan.BWD_CALL.pack(
            1, 2, 3, 0, 5, 6, 7, 8, 9, n, h, 1, 1, *p, 1),
        "entry(packed) (the launch of both passes)": lambda: entry(packed),
    }, calls=100, runs=5)


def d_host_breakdown():
    """Host microseconds a call (``_host_us``, 2000 calls, the queue never
    full: D's decode rows take 3 us of device time) of D's
    wrapper at [8, 4544] bf16 and of its parts, beside F.layer_norm."""
    import torch
    import torch.nn.functional as F

    from megatron_llm_torch.ops.kernels import build
    from megatron_llm_torch.ops.kernels import layernorm as ln
    from megatron_llm_torch.ops.kernels import norm_plan

    n, h = 8, 4544
    x = torch.randn(n, h, device="cuda").to(torch.bfloat16)
    one = torch.ones(h, device="cuda", dtype=torch.bfloat16)
    dev = x.device

    sm = _sm_count()
    st = torch.empty((2, n, 1), dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    p = ln.plan(n, h, torch.bfloat16, sm)
    packed = norm_plan.FWD_CALL.pack(
        x.data_ptr(), one.data_ptr(), one.data_ptr(), y.data_ptr(),
        st.data_ptr(), st.data_ptr() + 4 * n,
        torch._C._cuda_getCurrentRawStream(0), n, h, 1, 1, *p, 0, 1e-5)
    entry = norm_plan.entry("mlt_norm_fwd")
    return _host_us("D, x [8, 4544] bf16", {
        "wrapper": lambda: ln.layer_norm_fwd_kernel(x, one, one, 1e-5),
        "F.layer_norm": lambda: F.layer_norm(x, (h,), one, one, 1e-5),
        "empty_like(x)": lambda: torch.empty_like(x),
        "torch.empty((2, n, 1), dtype, device)": lambda: torch.empty(
            (2, n, 1), dtype=torch.float32, device=dev),
        "x.new_empty((2, n, 1), dtype)": lambda: x.new_empty(
            (2, n, 1), dtype=torch.float32),
        "st[0], st[1]": lambda: (st[0], st[1]),
        "st.unbind(0)": lambda: st.unbind(0),
        "plan": lambda: ln.plan(n, h, torch.bfloat16, sm),
        "build.sm_count(x.device)": lambda: build.sm_count(x.device),
        "stream handle": lambda: torch._C._cuda_getCurrentRawStream(0),
        "pack": lambda: norm_plan.FWD_CALL.pack(
            1, 2, 3, 4, 5, 6, 7, n, h, 1, 1, *p, 0, 1e-5),
        "entry(packed) (the launch)": lambda: entry(packed),
        "checks (norm_plan.fwd_checks)": lambda: norm_plan.fwd_checks(
            "layernorm", x, one, one),
    })


# B's timing rows (Llama-2-7B's width): decode, a prefill chunk and a
# training micro-batch; E's and C's training rows (Falcon-7B's, Llama's)
B_SHAPES = ((8, 4096), (64, 4096), (4096, 4096))
E_SHAPE = (2048, 4544)
# E's plan sweep: Falcon-7B's training rows and GPT-2 125M's (a micro-batch
# of 8 sequences of 1024 tokens, 768 columns)
E_SWEEP_SHAPES = {"falcon": E_SHAPE, "gpt2": (8192, 768)}
# C's training rows: Llama-2-7B's micro-batch (4096 tokens of 4096) and
# Gemma-7B's (2048 tokens of 3072)
C_SHAPES = {"C": (4096, 4096), "C_gemma": (2048, 3072)}
# E's and C's kernels (one template) by name substring: the device time
# of each pass
_NORM_BWD_PASSES = (("first", "norm_bwd_kernel"),
                    ("column", "norm_column_pass_kernel"))


def _median_ms(fn, iters=200, repeats=5):
    """Median over ``repeats`` of ``time_ms`` over ``iters`` calls: the
    eager time a call, the host issuing it."""
    return sorted(time_ms(fn, iters=iters) for _ in range(repeats))[
        repeats // 2]


def norm_times(gen):
    """B at B_SHAPES and at its serving call site, E at E_SHAPE and C at
    C_SHAPES, bf16: eager ms (``_median_ms``) and device ms (``graph_ms``)
    beside one library call on the same inputs (``F.rms_norm``,
    ``F.layer_norm``'s and ``F.rms_norm``'s backward) timed the same way,
    and each bound.  Returns (rows, profile runs): E's and C's device time
    by pass comes later from ``norm_profiles``, after every eager timing
    of the process."""
    import torch
    import torch.nn.functional as F

    from megatron_llm_torch.ops import layernorm as opsln
    from megatron_llm_torch.ops.kernels import layernorm as ln
    from megatron_llm_torch.ops.kernels import rmsnorm as rn

    bf16 = torch.bfloat16
    out = {"B": {}, "E": {}}
    runs = {}
    for n, h in B_SHAPES:
        x = torch.randn(n, h, device="cuda", generator=gen).to(bf16)
        s = (torch.rand(h, device="cuda", generator=gen) + 0.5).to(bf16)
        # serving's rows (decode, prefill) take B as its no-grad call
        # makes it, with no rstd; training's rows keep rstd
        training = n > 132
        b_ms, b_by = bound(2 * n * h * 2 + h * 2 + training * n * 4,
                           4 * n * h, FP32_FLOPS)
        run = functools.partial(rn.rms_norm_fwd_kernel, x, s, 1e-5,
                                rstd=training)
        lib = functools.partial(F.rms_norm, x, (h,), weight=s, eps=1e-5)
        out["B"][n] = dict(ms=_median_ms(run), device_ms=graph_ms(run),
                           library_ms=_median_ms(lib),
                           library_device_ms=graph_ms(lib), bound_ms=b_ms,
                           bound_by=b_by,
                           shape=f"x [{n}, {h}] bf16, " + (
                               "rstd kept" if training else "no rstd"))
        if not training:
            # the same call keeping rstd, as the training forward makes it
            out["B"][n]["ms_with_rstd"] = _median_ms(functools.partial(
                rn.rms_norm_fwd_kernel, x, s, 1e-5))
        if n == 8:
            # the cost serving pays: the norm dispatch of every layer,
            # under inference_mode as the engine runs it
            params = {"scale": s}
            x3 = x.reshape(n, 1, h)

            def site():
                with torch.inference_mode():
                    return opsln.apply_norm(x3, params, "rmsnorm",
                                            use_kernel=True)

            def site_lib():
                with torch.inference_mode():
                    return F.rms_norm(x3, (h,), weight=s, eps=1e-5)

            out["B"]["call_site"] = dict(
                ms=_median_ms(site), library_ms=_median_ms(site_lib),
                shape=f"apply_norm(x [{n}, 1, {h}] bf16) under "
                      f"inference_mode")
    n, h = E_SHAPE
    x = (torch.randn(n, h, device="cuda", generator=gen) * 3 + 1).to(bf16)
    sc = (torch.rand(h, device="cuda", generator=gen) + 0.5).to(bf16)
    bi = torch.zeros(h, device="cuda", dtype=bf16)
    g = torch.randn(n, h, device="cuda", generator=gen).to(bf16)
    _, mu, rstd = ln.layer_norm_fwd_kernel(x, sc, bi, 1e-5)
    xl, sl, bl = (t.clone().requires_grad_(True) for t in (x, sc, bi))
    yl = F.layer_norm(xl, (h,), sl, bl, 1e-5)
    run = functools.partial(ln.layer_norm_bwd_kernel, x, sc, g, mu, rstd)
    lib = functools.partial(torch.autograd.grad, yl, (xl, sl, bl), g,
                            retain_graph=True)
    b_ms, b_by = bound(3 * n * h * 2 + 2 * n * 4 + h * 2 + 2 * h * 4,
                       12 * n * h, FP32_FLOPS)
    out["E"] = dict(ms=_median_ms(run), device_ms=graph_ms(run),
                    library_ms=_median_ms(lib), bound_ms=b_ms, bound_by=b_by,
                    shape=f"x, g [{n}, {h}] bf16")
    runs["E"] = (run, lib, _NORM_BWD_PASSES)
    for name, (n, h) in C_SHAPES.items():
        x = torch.randn(n, h, device="cuda", generator=gen).to(bf16)
        sc = (torch.rand(h, device="cuda", generator=gen) + 0.5).to(bf16)
        g = torch.randn(n, h, device="cuda", generator=gen).to(bf16)
        _, rstd = rn.rms_norm_fwd_kernel(x, sc, 1e-5)
        xl, sl = (t.clone().requires_grad_(True) for t in (x, sc))
        yl = F.rms_norm(xl, (h,), weight=sl, eps=1e-5)
        run = functools.partial(rn.rms_norm_bwd_kernel, x, sc, g, rstd)
        lib = functools.partial(torch.autograd.grad, yl, (xl, sl), g,
                                retain_graph=True)
        b_ms, b_by = bound(3 * n * h * 2 + n * 4 + h * 2 + h * 4, 8 * n * h,
                           FP32_FLOPS)
        out[name] = dict(ms=_median_ms(run, iters=50),
                         device_ms=graph_ms(run),
                         library_ms=_median_ms(lib, iters=50), bound_ms=b_ms,
                         bound_by=b_by, shape=f"x, g [{n}, {h}] bf16")
        runs[name] = (run, lib, _NORM_BWD_PASSES)
    for n, row in out["B"].items():
        log(f"  B {row['shape']}: eager {row['ms']:.4f} ms"
            + (f" ({row['ms_with_rstd']:.4f} ms keeping rstd)"
               if "ms_with_rstd" in row else "")
            + (f", device {row['device_ms']:.4f} ms" if "device_ms" in row
               else "") + f"; F.rms_norm eager {row['library_ms']:.4f} ms"
            + (f", device {row['library_device_ms']:.4f} ms"
               if "library_device_ms" in row else "")
            + (f"; bound {row['bound_ms']:.5f} ms ({row['bound_by']})"
               if "bound_ms" in row else ""))
    return out, runs


def norm_profiles(out, runs):
    """E's and C's device ms a call by pass (first pass, column pass) and
    in all, and their library calls' device ms, from torch.profiler over
    10 calls each, into ``out`` (from ``norm_times``)."""
    for name, (run, lib, passes) in runs.items():
        row = out[name]
        ms = _device_ms_by_pass(run, 10, passes)
        row.update({f"{p}_device_ms": v_ for p, v_ in ms.items()
                    if p != "all"}, profiled_device_ms=ms["all"],
                   library_device_ms=_device_ms_by_pass(lib, 10, ())["all"])
        f4 = lambda v_: "not measured" if v_ is None else f"{v_:.4f}"
        lib_name = ("F.layer_norm" if name == "E" else "F.rms_norm")
        log(f"  {name} {row['shape']}: eager {row['ms']:.4f} ms, device "
            f"(graph) {row['device_ms']:.4f} ms; by pass (profiler): first "
            f"{f4(ms['first'])}, column {f4(ms['column'])}, all "
            f"{f4(ms['all'])} ms; {lib_name} backward eager "
            f"{row['library_ms']:.4f} ms, device "
            f"{f4(row['library_device_ms'])} ms; bound "
            f"{row['bound_ms']:.5f} ms ({row['bound_by']})")


def _inference_mode_only():
    import torch

    with torch.inference_mode():
        pass


def b_host_breakdown():
    """Host microseconds a call (``_host_us``, 2000 calls, the queue never
    full) of B's wrapper at [8, 4096] bf16, of its serving
    call site and of the parts a wrapper is made of, beside F.rms_norm."""
    import torch
    import torch.nn.functional as F

    from megatron_llm_torch.ops import layernorm as opsln
    from megatron_llm_torch.ops.kernels import build
    from megatron_llm_torch.ops.kernels import norm_plan
    from megatron_llm_torch.ops.kernels import rmsnorm as rn

    n, h = 8, 4096
    x = torch.randn(n, h, device="cuda").to(torch.bfloat16)
    one = torch.ones(h, device="cuda", dtype=torch.bfloat16)
    dev = x.device
    params = {"scale": one}
    x3 = x.reshape(n, 1, h)

    def site():
        with torch.inference_mode():
            return opsln.apply_norm(x3, params, "rmsnorm", use_kernel=True)

    sm = _sm_count()
    p = norm_plan.plan(n, h, torch.bfloat16, sm)
    y = torch.empty_like(x)
    packed = norm_plan.FWD_CALL.pack(
        x.data_ptr(), one.data_ptr(), 0, y.data_ptr(), 0, 0,
        torch._C._cuda_getCurrentRawStream(0), n, h, 1, 1, *p, 1, 1e-5)
    entry = norm_plan.entry("mlt_norm_fwd")
    return _host_us("B, x [8, 4096] bf16", {
        "wrapper (y and rstd)": lambda: rn.rms_norm_fwd_kernel(x, one, 1e-5),
        "wrapper, no rstd": lambda: rn.rms_norm_fwd_kernel(x, one, 1e-5,
                                                           rstd=False),
        "call site, inference_mode": site,
        "F.rms_norm": lambda: F.rms_norm(x, (h,), weight=one, eps=1e-5),
        "inference_mode enter and exit": _inference_mode_only,
        "empty_like(x)": lambda: torch.empty_like(x),
        "torch.empty((n, 1), dtype, device)": lambda: torch.empty(
            (n, 1), dtype=torch.float32, device=dev),
        "x.new_empty((n, 1), dtype)": lambda: x.new_empty(
            (n, 1), dtype=torch.float32),
        "x.reshape(-1, h)": lambda: x3.reshape(-1, h),
        "build.load_library()": build.load_library,
        "stream handle": lambda: torch._C._cuda_getCurrentRawStream(0),
        "plan": lambda: norm_plan.plan(n, h, torch.bfloat16, sm),
        "build.sm_count(0)": lambda: build.sm_count(0),
        "pack": lambda: norm_plan.FWD_CALL.pack(
            1, 2, 0, 4, 0, 0, 7, n, h, 1, 1, *p, 1, 1e-5),
        "entry(packed) (the launch)": lambda: entry(packed),
        "checks (norm_plan.fwd_checks)": lambda: norm_plan.fwd_checks(
            "rmsnorm", x, one, None),
    })


def _reference_by_group(fa, q, k, v, causal, window, scale, grads_of=None):
    """The plain forward (o, lse), or with ``grads_of`` = (o, lse, do) the
    plain backward (dq, dk, dv), one KV group at a time where a call's
    fp32 scores would pass 1 GiB ([b, nh, s, s] at 8192 tokens and 32
    heads is 8 GiB, and the backward holds several), else in one call.
    Each group's query heads go with their K/V head and their rows of o,
    lse and do; the groups share nothing, so the outputs, put back in
    head order, are the plain function's."""
    import torch

    b, s, nh, _ = q.shape
    ng = k.shape[2]

    def plain(q, k, v, o=None, lse=None, do=None):
        if grads_of is None:
            return fa._reference_attention(q, k, v, causal, window, scale)
        return fa._reference_attention_bwd(q, k, v, o, lse, do, causal,
                                           window, scale)

    if b * nh * s * k.shape[1] * 4 <= 1 << 30:
        return plain(q, k, v, *(grads_of or ()))
    qpg = nh // ng
    outs = []
    for j in range(ng):
        hs = slice(j * qpg, (j + 1) * qpg)
        extra = ()
        if grads_of is not None:
            o, lse, do = grads_of
            extra = (o[:, :, hs], lse[:, hs], do[:, :, hs])
        outs.append(plain(q[:, :, hs], k[:, :, j:j + 1], v[:, :, j:j + 1],
                          *extra))
    if grads_of is None:
        return (torch.cat([o_ for o_, _ in outs], dim=2),
                torch.cat([l_ for _, l_ in outs], dim=1))
    return tuple(torch.cat(parts, dim=2) for parts in zip(*outs))


def phase1_training(gen, results):
    import torch
    import torch.nn.functional as F

    from megatron_llm_torch.ops.kernels import build
    from megatron_llm_torch.ops.kernels import flash_attention as fa
    from megatron_llm_torch.ops.kernels import layernorm as ln
    from megatron_llm_torch.ops.kernels import norm_plan
    from megatron_llm_torch.ops.kernels import rmsnorm as rn

    dts = {"bf16": torch.bfloat16, "fp32": torch.float32}
    sm = _sm_count()

    # -- kernel C: RMSNorm backward ---------------------------------------
    # Llama's and Gemma-7B's training rows (C_SHAPES), Llama-3's at 8192
    # tokens (phase 9), a ragged row count, a tiny row and 5504 columns
    # (idle vectors): each at bwd_plan()'s
    # plan and at every forced plan of norm_plan.bwd_plans,
    # against the plain backward, its partial rows and dscale against
    # their plain walk (_reference_bwd_partials), and run twice: the same
    # bits for dx and dscale
    err = {"bf16": 0.0, "fp32": 0.0}
    gen89 = _phase8_9_gen()
    for tag, dt in dts.items():
        for n, h in (*C_SHAPES.values(), (8192, 4096), (300, 4096),
                     (3, 128), (17, 11008 // 2)):
            gen_ = gen89 if (n, h) in PHASE8_9_ROWS else gen
            x = (torch.randn(n, h, device="cuda", generator=gen_) * 3).to(dt)
            sc = (torch.rand(h, device="cuda", generator=gen_) + 0.5).to(dt)
            g = torch.randn(n, h, device="cuda", generator=gen_).to(dt)
            _, rstd = rn.rms_norm_fwd_plain(x, sc, 1e-5)
            dx0, ds0 = rn.rms_norm_bwd_plain(x, sc, g, rstd)
            plans = norm_plan.bwd_plans(n, h, dt, sm, rms=True)
            worst = [0.0, 0.0, 0.0]
            for p in plans:
                dx, ds, part = rn.rms_norm_bwd_kernel(
                    x, sc, g, rstd, force_plan=p, partials=True)
                again = rn.rms_norm_bwd_kernel(x, sc, g, rstd, force_plan=p)
                ref_part, ref_ds = rn._reference_bwd_partials(x, sc, g, rstd,
                                                              p)
                torch.cuda.synchronize()
                e_dx = (dx.float() - dx0.float()).abs().max().item()
                e_ds = ((ds - ds0).abs().max()
                        / ds0.abs().max().clamp(min=1.0)).item()
                size = ref_part.abs().max().clamp(min=1.0)
                e_part = max(((part - ref_part).abs().max() / size).item(),
                             ((ds - ref_ds).abs().max() / size).item())
                check(e_dx <= TOL[tag] and e_ds <= GRAD_TOL[tag],
                      f"rmsnorm backward {tag} n={n} h={h} plan {p}: dx "
                      f"{e_dx}, dscale {e_ds}")
                check(e_part <= 1e-5, f"rmsnorm backward {tag} n={n} h={h} "
                      f"plan {p}: partial rows off their plain walk by "
                      f"{e_part} of their size")
                check(all(torch.equal(a_, b_) for a_, b_ in
                          zip(again, (dx, ds))),
                      f"rmsnorm backward {tag} n={n} h={h} plan {p}: the "
                      f"output changed between two runs")
                worst = [max(w, e) for w, e in zip(worst, (e_dx, e_ds,
                                                           e_part))]
            log(f"  rmsnorm backward {tag} n={n} h={h}: bwd_plan(rms) "
                f"{plans[0]} and {len(plans) - 1} forced plans; dx "
                f"max_abs_err "
                f"{worst[0]:.3g}, dscale error / max|dscale| {worst[1]:.3g},"
                f" partial rows {worst[2]:.3g} of their size; the same bits "
                f"on every rerun")
            err[tag] = max(err[tag], worst[0])
    # timed with B, D, E and H in phase1_times, at the end of phase 1
    results["rmsnorm_bwd"] = dict(
        name="rmsnorm_bwd", route="cuda",
        source="megatron_llm_torch/csrc/layernorm.cu",
        replaces="megatron_llm_tpu/ops/pallas/rmsnorm.py:64",
        max_abs_err=err["bf16"], max_abs_err_fp32=err["fp32"])

    # -- kernel E: LayerNorm backward --------------------------------------
    # Falcon-7B's decode, prefill and training rows, GPT-2's 768, GPT-2
    # 345M's training rows (phase 8) and odd shapes: each at bwd_plan()'s
    # plan and at forced plans, against the
    # plain backward, its partial rows and column sums against their plain
    # walk (_reference_bwd_partials, fp32 up to the kernel's fused
    # multiply-adds), and run twice: the same bits for dx, dgamma, dbeta
    err = {"bf16": 0.0, "fp32": 0.0}
    gen89 = _phase8_9_gen()
    for tag, dt in dts.items():
        for n, h in ((8, 4544), (64, 4544), (2048, 4544), (1000, 768),
                     (4096, 1024), (3, 128), (300, 1600)):
            gen_ = gen89 if (n, h) in PHASE8_9_ROWS else gen
            x = (torch.randn(n, h, device="cuda", generator=gen_) * 3
                 + 1).to(dt)
            sc = (torch.rand(h, device="cuda", generator=gen_) + 0.5).to(dt)
            b = torch.zeros(h, device="cuda", dtype=dt)
            g = torch.randn(n, h, device="cuda", generator=gen_).to(dt)
            _, mu, rstd = ln.layer_norm_fwd_plain(x, sc, b, 1e-5)
            dx0, dg0, db0 = ln.layer_norm_bwd_plain(x, sc, g, mu, rstd)
            plans = norm_plan.bwd_plans(n, h, dt, sm)
            worst = [0.0, 0.0, 0.0, 0.0]
            for p in plans:
                dx, dg, db, part = ln.layer_norm_bwd_kernel(
                    x, sc, g, mu, rstd, force_plan=p, partials=True)
                again = ln.layer_norm_bwd_kernel(x, sc, g, mu, rstd,
                                                 force_plan=p)
                ref_part, ref_sums = ln._reference_bwd_partials(
                    x, sc, g, mu, rstd, p)
                torch.cuda.synchronize()
                e_dx = (dx.float() - dx0.float()).abs().max().item()
                e_dg = ((dg - dg0).abs().max()
                        / dg0.abs().max().clamp(min=1.0)).item()
                e_db = ((db - db0).abs().max()
                        / db0.abs().max().clamp(min=1.0)).item()
                size = ref_part.abs().max().clamp(min=1.0)
                e_part = max(((part - ref_part).abs().max() / size).item(),
                             ((torch.cat([dg, db]) - ref_sums).abs().max()
                              / size).item())
                check(e_dx <= TOL[tag] and max(e_dg, e_db) <= GRAD_TOL[tag],
                      f"layernorm backward {tag} n={n} h={h} plan {p}: dx "
                      f"{e_dx}, dgamma {e_dg}, dbeta {e_db}")
                check(e_part <= 1e-5, f"layernorm backward {tag} n={n} "
                      f"h={h} plan {p}: partial rows off their plain walk "
                      f"by {e_part} of their size")
                check(all(torch.equal(a_, b_) for a_, b_ in
                          zip(again, (dx, dg, db))),
                      f"layernorm backward {tag} n={n} h={h} plan {p}: the "
                      f"output changed between two runs")
                worst = [max(w, e) for w, e in zip(worst, (e_dx, e_dg, e_db,
                                                           e_part))]
            log(f"  layernorm backward {tag} n={n} h={h}: bwd_plan() "
                f"{plans[0]} and {len(plans) - 1} forced plans; dx "
                f"max_abs_err {worst[0]:.3g}, dgamma error / max|dgamma| "
                f"{worst[1]:.3g}, dbeta {worst[2]:.3g}, partial rows "
                f"{worst[3]:.3g} of their size; the same bits on every "
                f"rerun")
            err[tag] = max(err[tag], worst[0])
    # timed with B, C, D and H in phase1_times, at the end of phase 1
    results["layernorm_bwd"] = dict(
        name="layernorm_bwd", route="cuda",
        source="megatron_llm_torch/csrc/layernorm.cu",
        replaces="megatron_llm_tpu/ops/pallas/layernorm.py:62",
        max_abs_err=err["bf16"], max_abs_err_fp32=err["fp32"])

    # -- kernels F, G, H: flash attention ---------------------------------
    # (label, b, s, nh, ng, d, window, views); s a multiple of 64 takes G,
    # else H.  With ``views`` q, k and v are the views of one fused
    # [b, s, ng, qpg + 2, d] QKV tensor that the training path passes (q
    # a view only when qpg = 1), read through their strides.
    cases = [
        ("7B s4096", 1, 4096, 32, 32, 128, None, False),
        ("7B s4096 window 4096", 1, 4096, 32, 32, 128, 4096, False),
        ("GQA g8 s1024 window 100", 1, 1024, 32, 8, 128, 100, False),
        ("MQA g1 s1024", 1, 1024, 32, 1, 128, None, False),
        ("s1000, ragged last tile", 1, 1000, 32, 32, 128, None, False),
        ("GQA g8 b2 s1000 window 100", 2, 1000, 32, 8, 128, 100, False),
        ("fused-QKV views s1000", 1, 1000, 32, 32, 128, None, True),
        ("fused-QKV views GQA g8 s1000 window 100", 1, 1000, 32, 8, 128,
         100, True),
        ("fused-QKV views s1024", 1, 1024, 32, 32, 128, None, True),
        # Falcon-7B: 71 query heads on one KV head of 64, as the model
        # passes them (views of its fused [b, s, 1, 73, 64] QKV output)
        ("Falcon-7B MQA nh71 d64 s2048", 1, 2048, 71, 1, 64, None, False),
        ("Falcon-7B fused-QKV views s2048", 1, 2048, 71, 1, 64, None, True),
        ("Falcon-7B MQA nh71 d64 s1000", 1, 1000, 71, 1, 64, None, False),
        ("Falcon-7B fused-QKV views s1000", 1, 1000, 71, 1, 64, None, True),
        # head_dim 256: Gemma-7B (16 heads of 256, MHA) and Gemma-2B (8
        # query heads on one KV head of 256)
        ("Gemma-7B nh16 g16 d256 s2048", 1, 2048, 16, 16, 256, None, False),
        ("Gemma-2B MQA nh8 g1 d256 s2048", 1, 2048, 8, 1, 256, None, False),
        ("Gemma-2B fused-QKV views s1000", 1, 1000, 8, 1, 256, None, True),
        ("Gemma-7B d256 s1000 window 300", 1, 1000, 16, 16, 256, 300,
         False),
    ]
    # the training paths of phases 8 and 9, on inputs of their own
    # generator: GPT-2 345M (16 heads of 64, micro-batch 4 of 1024 tokens;
    # one KV head a query head, so q is a view too) and Llama-3-8B at its
    # own sequence (32 heads on 8 KV heads of 128, 8192 tokens)
    gen89 = _phase8_9_gen()
    cases = [(c, gen) for c in cases] + [(c, gen89) for c in (
        ("GPT-2 345M b4 s1024 nh16 d64", 4, 1024, 16, 16, 64, None, False),
        ("GPT-2 345M fused-QKV views b4 s1024", 4, 1024, 16, 16, 64, None,
         True),
        ("Llama-3 fused-QKV views GQA g8 s8192", 1, 8192, 32, 8, 128, None,
         True))]
    f_err = {"bf16": 0.0, "fp32": 0.0}
    b_err = {k: {"bf16": [0.0, 0.0], "fp32": [0.0, 0.0]} for k in "GH"}
    for (label, b, s, nh, ng, d, w, views), gen_ in cases:
        for tag, dt in dts.items():
            if views:
                qpg = nh // ng
                mixed = torch.randn(b, s, ng, qpg + 2, d, device="cuda",
                                    generator=gen_).to(dt)
                q = mixed[:, :, :, :qpg].reshape(b, s, nh, d)
                k, v = mixed[:, :, :, qpg], mixed[:, :, :, qpg + 1]
                check(not k.is_contiguous() and not v.is_contiguous()
                      and (qpg > 1 or not q.is_contiguous()),
                      f"{label}: the views are contiguous")
            else:
                q = torch.randn(b, s, nh, d, device="cuda",
                                generator=gen_).to(dt)
                k = torch.randn(b, s, ng, d, device="cuda",
                                generator=gen_).to(dt)
                v = torch.randn(b, s, ng, d, device="cuda",
                                generator=gen_).to(dt)
            do = torch.randn(b, s, nh, d, device="cuda",
                             generator=gen_).to(dt)
            scale = 1.0 / math.sqrt(d)
            o, lse = fa.flash_attention_fwd_kernel(q, k, v, True, w, scale)
            o0, lse0 = _reference_by_group(fa, q, k, v, True, w, scale)
            torch.cuda.synchronize()
            e_f = max((o.float() - o0.float()).abs().max().item(),
                      (lse - lse0).abs().max().item())
            kind = "G" if fa.uses_fused_backward(s, s) else "H"
            before = (fa.bwd_fused_launches, fa.bwd_launches)
            grads = fa.flash_attention_bwd_kernel(q, k, v, o0, lse0, do,
                                                  True, w, scale)
            after = (fa.bwd_fused_launches, fa.bwd_launches)
            again = fa.flash_attention_bwd_kernel(q, k, v, o0, lse0, do,
                                                  True, w, scale)
            ref = _reference_by_group(fa, q, k, v, True, w, scale,
                                      grads_of=(o0, lse0, do))
            torch.cuda.synchronize()
            e_abs, e_rel = _grad_errors(grads, ref)
            splits = fa.head_splits(b, s, ng, nh // ng,
                                    fa.TILES[(dt, d)][
                                        1 if kind == "G" else 3][1],
                                    build.sm_count(q.device))
            log(f"  flash attention {label} {tag}: forward max_abs_err "
                f"{e_f:.3g}; backward {kind} ({splits} head splits): "
                f"max_abs_err {e_abs:.3g}, error / max|grad| {e_rel:.3g}")
            check(torch.equal(grads[1], again[1])
                  and torch.equal(grads[2], again[2]),
                  f"flash backward {label} {tag}: dK/dV changed between two "
                  f"runs ({splits} head splits)")
            # H writes each dq row from one block: the same bits again
            check(kind == "G" or torch.equal(grads[0], again[0]),
                  f"flash backward {label} {tag}: dq changed between two "
                  f"runs")
            check(math.isfinite(e_f) and e_f <= TOL[tag],
                  f"flash forward {label} {tag}: {e_f} > {TOL[tag]}")
            check(math.isfinite(e_rel) and e_rel <= GRAD_TOL[tag],
                  f"flash backward {label} {tag}: {e_rel} > "
                  f"{GRAD_TOL[tag]}")
            want = (before[0] + 1, before[1]) if kind == "G" else (
                before[0], before[1] + 1)
            check(after == want, f"flash backward {label}: dispatch "
                                 f"{before} -> {after}, expected {kind}")
            f_err[tag] = max(f_err[tag], e_f)
            b_err[kind][tag] = [max(b_err[kind][tag][0], e_abs),
                                max(b_err[kind][tag][1], e_rel)]
            del q, k, v, do, o, lse, o0, lse0, grads, again, ref
            torch.cuda.empty_cache()

    # timing, bf16: F and G at the Llama training path's shape, then at
    # the Falcon training path's shape (71 heads on one KV head of 64,
    # 2048 tokens) and at Gemma-7B's attention shape (16 heads of 256,
    # 4096 tokens); SDPA gets K/V expanded to the query heads beforehand.
    # H is timed in h_and_d_times, at the end of phase 1.
    other = {}
    for name, (b, s, nh, ng, d) in (("falcon_shape", (1, 2048, 71, 1, 64)),
                                    ("gemma_shape", (1, 4096, 16, 16, 256))):
        other[name] = _time_attention_shape(gen, b, s, nh, ng, d)

    b, s, nh, d = 1, 4096, 32, 128
    q, k, v, do = (torch.randn(b, s, nh, d, device="cuda",
                               generator=gen).to(torch.bfloat16)
                   for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    ms = time_ms(lambda: fa.flash_attention_fwd_kernel(
        q, k, v, True, None, scale), iters=10)
    plain_ms = time_ms(lambda: fa._reference_attention(
        q, k, v, True, None, scale), iters=3, warmup=1)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), iters=10)
    b_ms, b_by = _attn_bound(b, s, nh, nh, d, None, False)
    shape = f"b={b} s={s} nh=g={nh} d={d} causal bf16"
    results["flash_fwd"] = dict(
        name="flash_attention_fwd", route="cuda",
        source="megatron_llm_torch/csrc/flash_attention.cu",
        replaces="megatron_llm_tpu/ops/pallas/flash_attention.py:93",
        max_abs_err=f_err["bf16"], max_abs_err_fp32=f_err["fp32"],
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms, falcon_shape=other["falcon_shape"]["F"],
        gemma_shape=other["gemma_shape"]["F"], shape=shape)
    log(f"  flash forward (F) {shape}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound {b_ms:.5f} ms "
        f"({b_by})")
    o, lse = fa.flash_attention_fwd_kernel(q, k, v, True, None, scale)
    ms = time_ms(lambda: fa.flash_attention_bwd_kernel(
        q, k, v, o, lse, do, True, None, scale), iters=5)
    plain_ms = time_ms(lambda: fa._reference_attention_bwd(
        q, k, v, o, lse, do, True, None, scale), iters=2, warmup=1)
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
    out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
    lib_ms = time_ms(lambda: torch.autograd.grad(
        out, (qr, kr, vr), dot, retain_graph=True), iters=5)
    b_ms, b_by = _attn_bound(b, s, nh, nh, d, None, True)
    results["flash_bwd_fused"] = dict(
        name="flash_attention_bwd_fused", route="cuda",
        source="megatron_llm_torch/csrc/flash_attention.cu",
        replaces="megatron_llm_tpu/ops/pallas/flash_attention.py:345",
        max_abs_err=b_err["G"]["bf16"][0], max_rel_err=b_err["G"]["bf16"][1],
        max_abs_err_fp32=b_err["G"]["fp32"][0],
        max_rel_err_fp32=b_err["G"]["fp32"][1],
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms, falcon_shape=other["falcon_shape"]["G"],
        gemma_shape=other["gemma_shape"]["G"], shape=shape)
    log(f"  flash backward (G) {shape}: kernel {ms:.4f} ms (delta, the dq "
        f"buffer and its cast included), plain {plain_ms:.4f} ms, SDPA "
        f"backward {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    results["flash_bwd"] = dict(
        name="flash_attention_bwd_two_pass", route="cuda",
        source="megatron_llm_torch/csrc/flash_attention.cu",
        replaces="megatron_llm_tpu/ops/pallas/flash_attention.py:213",
        variant=fa.kernel_variant(torch.bfloat16, 128, "two_pass"),
        max_abs_err=b_err["H"]["bf16"][0], max_rel_err=b_err["H"]["bf16"][1],
        max_abs_err_fp32=b_err["H"]["fp32"][0],
        max_rel_err_fp32=b_err["H"]["fp32"][1])
    del q, k, v, do, qt, kt, vt, dot, o, lse, qr, kr, vr, out
    torch.cuda.empty_cache()


def phase1_times(gen, results):
    """B, C, D, E and H timed at their main-path shapes, the plain
    versions beside them, into the kernels' entries (every eager time
    first, the profiler windows last): B at the decode rows with its
    prefill and training rows, its serving call site, its host work by
    part and its plans beside them; C and E at their training rows, with the device time of each
    pass; H at Llama's shape with Falcon's and Gemma-7B's beside it, each
    with the device time of its passes; D at Falcon's training rows with
    the decode rows beside them; each norm row with its graph-replay
    device time and its plan."""
    import torch

    from megatron_llm_torch.ops.kernels import flash_attention as fa
    from megatron_llm_torch.ops.kernels import layernorm as ln
    from megatron_llm_torch.ops.kernels import rmsnorm as rn

    bf16 = torch.bfloat16
    sm = _sm_count()
    # B's host work by part in the process whose eager times are kept
    b_host = b_host_breakdown()
    c_host = c_host_breakdown()
    norms, norm_runs = norm_times(gen)
    hd = h_and_d_times(gen)
    norm_profiles(norms, norm_runs)
    for name, row in hd["H"].items():
        b, s, nh, ng, d = H_SHAPES[name]
        q, do = (torch.randn(b, s, nh, d, device="cuda",
                             generator=gen).to(torch.bfloat16)
                 for _ in range(2))
        k, v = (torch.randn(b, s, ng, d, device="cuda",
                            generator=gen).to(torch.bfloat16)
                for _ in range(2))
        scale = 1.0 / math.sqrt(d)
        o, lse = fa._reference_attention(q, k, v, True, None, scale)
        row["plain_ms"] = time_ms(lambda: fa._reference_attention_bwd(
            q, k, v, o, lse, do, True, None, scale), iters=2, warmup=1)
        row["variant"] = fa.kernel_variant(torch.bfloat16, d, "two_pass")
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    for n, row in hd["D"].items():
        x = torch.randn(n, 4544, device="cuda", generator=gen).to(bf16)
        one = torch.ones(4544, device="cuda", dtype=bf16)
        row["plain_ms"] = time_ms(lambda: ln.layer_norm_fwd_plain(
            x, one, one, 1e-5), iters=50)
        row["plan"] = list(ln.plan(n, 4544, bf16, sm))
    for n, h in B_SHAPES:
        row = norms["B"][n]
        x = torch.randn(n, h, device="cuda", generator=gen).to(bf16)
        one = torch.ones(h, device="cuda", dtype=bf16)
        row["plain_ms"] = time_ms(lambda: rn.rms_norm_fwd_plain(
            x, one, 1e-5), iters=50)
        row["plan"] = list(ln.plan(n, h, bf16, sm))
    n, h = E_SHAPE
    x, g = (torch.randn(n, h, device="cuda", generator=gen).to(bf16)
            for _ in range(2))
    one = torch.ones(h, device="cuda", dtype=bf16)
    _, mu, rstd = ln.layer_norm_fwd_plain(x, one, one, 1e-5)
    norms["E"].update(plain_ms=time_ms(lambda: ln.layer_norm_bwd_plain(
        x, one, g, mu, rstd), iters=20), plan=list(ln.bwd_plan(n, h, bf16,
                                                                sm)))
    for name, (n, h) in C_SHAPES.items():
        x, g = (torch.randn(n, h, device="cuda", generator=gen).to(bf16)
                for _ in range(2))
        one = torch.ones(h, device="cuda", dtype=bf16)
        _, rstd = rn.rms_norm_fwd_plain(x, one, 1e-5)
        norms[name]["plain_ms"] = time_ms(lambda: rn.rms_norm_bwd_plain(
            x, one, g, rstd), iters=20)
    del x, g, mu, rstd
    torch.cuda.empty_cache()
    results["flash_bwd"].update(hd["H"]["llama"],
                                falcon_shape=hd["H"]["falcon"],
                                gemma_shape=hd["H"]["gemma"])
    results["layernorm"].update(hd["D"][2048], decode_rows=hd["D"][8])
    b_rows = norms["B"]
    results["rmsnorm"].update(
        b_rows[8], prefill_rows=b_rows[64], training_rows=b_rows[4096],
        training_device_ms=b_rows[4096]["device_ms"],
        call_site=b_rows["call_site"], host_us=b_host)
    results["rmsnorm_bwd"].update(
        norms["C"], gemma_rows=norms["C_gemma"], host_us=c_host,
        plan=list(ln.bwd_plan(*C_SHAPES["C"], bf16, sm, rms=True)))
    results["layernorm_bwd"].update(norms["E"])
    for label, row in (("H, Llama", hd["H"]["llama"]),
                       ("H, Falcon", hd["H"]["falcon"]),
                       ("H, Gemma-7B", hd["H"]["gemma"])):
        _log_times(f"flash backward ({label})", row, "SDPA backward")
    for n in (2048, 8):
        _log_times(f"layernorm (D, plan {hd['D'][n]['plan']})", hd["D"][n],
                   "F.layer_norm")
    for n, _ in B_SHAPES:
        _log_times(f"rmsnorm (B, plan {b_rows[n]['plan']})", b_rows[n],
                   "F.rms_norm")
    _log_times(f"layernorm backward (E, plan {norms['E']['plan']})",
               norms["E"], "F.layer_norm backward")
    for name, (n, h) in C_SHAPES.items():
        _log_times(f"rmsnorm backward (C, plan "
                   f"{ln.bwd_plan(n, h, bf16, sm, rms=True)})", norms[name],
                   "F.rms_norm backward")


# ---------------------------------------------------------------------------
# phases 3 and 5: the training slice at 7B width, 8 layers
# ---------------------------------------------------------------------------

def _zero_counts():
    """Set every kernel's launch count to 0."""
    from megatron_llm_torch.ops.kernels import flash_attention as fa
    from megatron_llm_torch.ops.kernels import layernorm as ln
    from megatron_llm_torch.ops.kernels import paged_attention as pa
    from megatron_llm_torch.ops.kernels import rmsnorm as rn

    fa.fwd_launches = fa.bwd_fused_launches = fa.bwd_launches = 0
    fa.variant_launches.clear()
    rn.launches = rn.bwd_launches = 0
    ln.launches = ln.bwd_launches = 0
    for by_plan in (rn.plan_launches, rn.bwd_plan_launches,
                    ln.plan_launches, ln.bwd_plan_launches):
        by_plan.clear()
    pa.decode_launches = pa.prefill_launches = 0
    pa.quant_decode_launches = pa.quant_prefill_launches = 0
    pa.merge_launches = 0
    pa.variant_launches.clear()


def _counts():
    from megatron_llm_torch.ops.kernels import flash_attention as fa
    from megatron_llm_torch.ops.kernels import layernorm as ln
    from megatron_llm_torch.ops.kernels import paged_attention as pa
    from megatron_llm_torch.ops.kernels import rmsnorm as rn

    return {"F": fa.fwd_launches, "G": fa.bwd_fused_launches,
            "H": fa.bwd_launches, "B": rn.launches, "C": rn.bwd_launches,
            "D": ln.launches, "E": ln.bwd_launches,
            "A": pa.decode_launches + pa.prefill_launches,
            "A'": pa.quant_decode_launches + pa.quant_prefill_launches}


def _log_field(line, name):
    m = re.search(rf"{re.escape(name)}: ([-+0-9.eEna]+)", line)
    return float(m.group(1)) if m else None


def _synthetic_batch(rng, micro, seq, vocab):
    import torch

    toks = torch.from_numpy(rng.randint(0, vocab, (micro, 1, seq))).cuda()
    return {"tokens": toks, "labels": torch.roll(toks, -1, dims=-1),
            "loss_mask": torch.ones(toks.shape, device="cuda")}


# kernel-name substrings of each row of the step's device-time breakdown
_KERNEL_GROUPS = (
    ("A/A' paged attention", ("paged_mma_kernel", "paged_simt_kernel",
                              "paged_merge_kernel")),
    ("F flash forward", ("flash_fwd_wgmma_kernel", "flash_fwd_kernel")),
    ("G/H flash backward", ("flash_bwd_kv_wgmma_kernel",
                            "flash_bwd_kv_mma_kernel", "flash_bwd_kv_kernel",
                            "flash_bwd_dq_kernel", "flash_bwd_dq_wgmma_kernel",
                            "flash_bwd_prep_kernel",
                            "flash_dkv_sum_kernel")),
    ("B/D norm forward", ("norm_fwd_kernel",)),
    ("C/E norm backward", ("norm_bwd_kernel", "norm_column_pass_kernel")),
    ("matmuls (cuBLAS)", ("gemm", "xmma", "nvjet", "cutlass", "cublas")),
)


def _profile_step(run, tag):
    """Device time by kernel group over one call of ``run`` (which ends
    in a synchronize), from torch.profiler; returns (ms by group, device
    ms in all, wall ms).  The full table goes to chiprun_out/."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    wall_ms = (time.perf_counter() - t0) * 1e3
    groups = {name: 0.0 for name, _ in _KERNEL_GROUPS}
    groups["other kernels"] = 0.0
    events = prof.key_averages()
    for evt in events:
        if evt.device_type != DeviceType.CUDA:
            continue
        ms = evt.self_device_time_total / 1e3
        name = next((g for g, keys in _KERNEL_GROUPS
                     if any(k in evt.key for k in keys)), "other kernels")
        groups[name] += ms
    with open(os.path.join(OUT_DIR, f"chip_smoke_profile_{tag}.txt"),
              "w") as f:
        f.write(events.table(sort_by="self_device_time_total",
                             row_limit=60))
    return groups, sum(groups.values()), wall_ms


def _fp32_grad_check(spec, seq, L=2):
    """Kernel path (F, G/H and the family's norm kernels) against the
    plain path (core_attention and the autograd of the plain norm), fp32,
    same params and tokens.  Returns (relative loss difference, worst leaf
    name, its error over its max-abs, launches of the kernel path, the two
    losses)."""
    import numpy as np
    import torch

    from megatron_llm_torch import models
    from megatron_llm_torch.tree import tree_leaves_with_path

    model_cls, config_fn = (getattr(models, n) for n in spec["model"])
    cfg = config_fn("7B", num_layers=L, seq_length=seq,
                    max_position_embeddings=seq)
    params = model_cls(cfg).init(99)
    named = tree_leaves_with_path(params)
    leaves = [p.requires_grad_(True) for _, p in named]
    rng = np.random.RandomState(5)
    toks = torch.from_numpy(rng.randint(0, spec["vocab"], (1, seq))).cuda()
    labels = torch.roll(toks, -1, dims=-1)

    def run(c):
        loss = model_cls(c)(params, toks, labels=labels, train=True).mean()
        grads = torch.autograd.grad(loss, leaves)
        return loss.item(), grads

    _zero_counts()
    loss_k, g_k = run(cfg)
    counts = _counts()
    _check_variants(counts, torch.float32, cfg.head_dim,
                    f"fp32 check at sequence {seq}")
    loss_p, g_p = run(_plain_path(cfg))
    check(_counts() == counts, f"the plain path launched kernels: "
                               f"{counts} -> {_counts()}")
    worst, worst_name = 0.0, ""
    for (path, _), a, b in zip(named, g_k, g_p):
        e = ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
        if e > worst:
            worst, worst_name = e, "/".join(path)
    del params, leaves, g_k, g_p
    torch.cuda.empty_cache()
    return abs(loss_k - loss_p) / abs(loss_p), worst_name, worst, counts, \
        (loss_k, loss_p)


# the two training workloads: 8 of 32 layers at the model's full width and
# its own sequence length, bf16 with fp32 masters, two micro-batches of 1
TRAINING = {
    "llama": dict(
        label="Llama-2-7B", model=("LlamaModel", "llama_config"),
        vocab=32000, seq=4096, lr=3e-4, head_dim=128,
        flags=["--model_name", "llama2", "--hidden_size", "4096",
               "--num_attention_heads", "32", "--ffn_hidden_size", "11008"],
        # launches per step: attention once a layer and micro-batch, two
        # norms a layer plus the final one
        per_step=lambda L, micro: {
            "F": L * micro, "G": L * micro, "H": 0,
            "B": (2 * L + 1) * micro, "C": (2 * L + 1) * micro,
            "D": 0, "E": 0, "A": 0, "A'": 0},
        norm_rows={"B": "rmsnorm", "C": "rmsnorm_bwd"}),
    "falcon": dict(
        # at 1e-4 and 3e-4 the fixed-batch loss of this model rises and
        # falls in turn (its grad norm swings between ~3 and ~28)
        label="Falcon-7B", model=("FalconModel", "falcon_config"),
        vocab=65024, seq=2048, lr=2e-5, head_dim=64,
        flags=["--model_name", "falcon", "--hidden_size", "4544",
               "--num_attention_heads", "71", "--num_attention_heads_kv",
               "1", "--ffn_hidden_size", "18176", "--gelu_variant", "exact"],
        # the parallel block has one norm a layer
        per_step=lambda L, micro: {
            "F": L * micro, "G": L * micro, "H": 0, "B": 0, "C": 0,
            "D": (L + 1) * micro, "E": (L + 1) * micro, "A": 0, "A'": 0},
        norm_rows={"D": "layernorm", "E": "layernorm_bwd"}),
    "gemma": dict(
        # head_dim 256 (16 heads of 256 on a hidden size of 3072), cut to 2
        # layers; the tied 256000 x 3072 embedding is scaled by
        # sqrt(3072) on the way in, so the repeated batch takes Falcon's
        # small lr
        label="Gemma-7B", model=("GemmaModel", "gemma_config"),
        vocab=256000, seq=2048, lr=2e-5, layers=2, head_dim=256,
        # the input embedding, scaled by sqrt(3072), stays a large part of
        # the last hidden state of a random 2-layer model, and the tied
        # head then gives each position's own token a logit of tens: the
        # first loss lies far above ln V, with no bound from above
        first_loss_excess=None,
        flags=["--model_name", "gemma", "--hidden_size", "3072",
               "--num_attention_heads", "16", "--num_attention_heads_kv",
               "16", "--kv_channels", "256", "--ffn_hidden_size", "24576"],
        per_step=lambda L, micro: {
            "F": L * micro, "G": L * micro, "H": 0,
            "B": (2 * L + 1) * micro, "C": (2 * L + 1) * micro,
            "D": 0, "E": 0, "A": 0, "A'": 0},
        norm_rows={"B": "rmsnorm", "C": "rmsnorm_bwd"}),
}


def _check_variants(counts, dtype, d, what):
    """The F, G and H launches of ``counts`` all went through the kernel
    variants of ``dtype`` at head_dim ``d``."""
    from megatron_llm_torch.ops.kernels import flash_attention as fa

    want = {}
    for key, kind in (("F", "fwd"), ("G", "fused"), ("H", "two_pass")):
        if counts[key]:
            want[fa.kernel_variant(dtype, d, kind)] = counts[key]
    got = {k: v for k, v in fa.variant_launches.items() if v}
    log(f"  {what}: flash launches by variant {got}")
    check(got == want, f"{what}: flash launches by variant {got}, "
                       f"expected {want}")


def train_phase(results, kernels, card, spec):
    import contextlib
    import gc
    import io

    import numpy as np
    import torch

    from megatron_llm_torch import finetune, models
    from megatron_llm_torch.config import ParallelConfig, TrainConfig
    from megatron_llm_torch.optimizer import MegatronOptimizer
    from megatron_llm_torch.telemetry import ThroughputCalculator
    from megatron_llm_torch.training import build_train_step

    L, micro, iters = spec.get("layers", 8), 2, 4
    seq, vocab = spec["seq"], spec["vocab"]
    phase = f"training {spec['label']}"
    # (1) the entry point: the model's width cut to 8 of its 32 layers
    argv = spec["flags"] + [
        "--num_layers", str(L), "--seq_length", str(seq),
        "--max_position_embeddings", str(seq), "--vocab_size", str(vocab),
        "--bf16", "--micro_batch_size", "1", "--global_batch_size",
        str(micro), "--train_iters", str(iters), "--lr", "1e-4",
        "--clip_grad", "1.0", "--log_interval", "1", "--seed", "1234"]
    log(f"  finetune.main({' '.join(argv)})")
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            done = finetune.main(argv)
    finally:
        for line in out.getvalue().splitlines():
            log(f"  | {line}")
    wall = time.perf_counter() - t0
    counts = _counts()
    peak_main = torch.cuda.max_memory_allocated()
    lines = [ln for ln in out.getvalue().splitlines()
             if ln.startswith(" iteration")]
    check(done == iters and len(lines) == iters,
          f"{done} iterations, {len(lines)} log lines")
    losses = [_log_field(ln, "lm loss") for ln in lines]
    norms = [_log_field(ln, "grad norm") for ln in lines]
    check(all(x is not None and math.isfinite(x) for x in losses + norms),
          f"non-finite loss or grad norm: {losses} {norms}")
    # random weights predict no better than chance: the first loss is at
    # least ln V; above it by at most first_loss_excess
    excess = spec.get("first_loss_excess", 1.5)
    check(math.log(vocab) <= losses[0]
          and (excess is None or losses[0] <= math.log(vocab) + excess),
          f"first loss {losses[0]} outside [ln {vocab}, ln {vocab} + "
          f"{excess}]")
    per_step = {k: v / iters for k, v in counts.items()}
    want = spec["per_step"](L, micro)
    norm_plans = _norm_plan_launches(counts)
    log(f"  launches per step {per_step} (expected {want}); norm launches "
        f"by plan {norm_plans}; peak memory {peak_main / 2**30:.2f} GiB; "
        f"{wall:.1f} s for {iters} iterations")
    check(per_step == want, f"launches per step {per_step} != {want}")
    _check_variants(counts, torch.bfloat16, spec["head_dim"],
                    f"finetune.main, {iters} iterations")
    step_ms = [_log_field(ln, "elapsed time per iteration (ms)")
               for ln in lines]
    results["entry_point"] = dict(
        losses=losses, grad_norms=norms, step_ms=step_ms,
        tokens_per_sec=[_log_field(ln, "tokens per second")
                        for ln in lines],
        mfu_pct=[_log_field(ln, "MFU") for ln in lines],
        launches=counts, norm_plan_launches=norm_plans,
        peak_memory_gib=peak_main / 2**30, wall_secs=wall)
    _add_launches(kernels, "flash_fwd", phase, counts["F"])
    _add_launches(kernels, "flash_bwd_fused", phase, counts["G"])
    for key, row in spec["norm_rows"].items():
        _add_launches(kernels, row, phase, counts[key])
    gc.collect()
    torch.cuda.empty_cache()

    # (2) a fixed batch, 5 steps of build_train_step: the loss falls at
    # every step; forward+backward and optimizer timed by CUDA events
    model_cls, config_fn = (getattr(models, n) for n in spec["model"])
    cfg = config_fn("7B", num_layers=L, seq_length=seq,
                    max_position_embeddings=seq, params_dtype="bf16",
                    compute_dtype="bf16")
    model = model_cls(cfg)
    params = model.init(1234)
    lr = spec["lr"]
    tc = TrainConfig(micro_batch_size=1, global_batch_size=micro, lr=lr,
                     bf16=True, clip_grad=1.0)
    opt_events = []

    class TimedOptimizer(MegatronOptimizer):
        def step(self, *a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            res = super().step(*a, **kw)
            e1.record()
            opt_events.append((e0, e1))
            return res

    opt = TimedOptimizer(tc, params_dtype=torch.bfloat16)
    state = opt.init(params)
    step = build_train_step(model, opt, ParallelConfig(), micro)
    rng = np.random.RandomState(7)
    batch = _synthetic_batch(rng, micro, seq, vocab)
    torch.cuda.reset_peak_memory_stats()
    fixed, totals, opts = [], [], []
    for i in range(5):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        params, state, m = step(params, state, batch, None, lr, 0.01)
        e1.record()
        torch.cuda.synchronize()
        fixed.append(float(m["lm loss"]))
        totals.append(e0.elapsed_time(e1))
        opts.append(opt_events[-1][0].elapsed_time(opt_events[-1][1]))
        log(f"  fixed batch step {i + 1}: lm loss {fixed[-1]:.6f}, grad "
            f"norm {float(m['grad_norm']):.4f}, step {totals[-1]:.1f} ms "
            f"(forward+backward {totals[-1] - opts[-1]:.1f} ms, optimizer "
            f"{opts[-1]:.1f} ms)")
    peak_fixed = torch.cuda.max_memory_allocated()
    check(all(b < a for a, b in zip(fixed, fixed[1:])),
          f"the fixed-batch loss did not fall at every step: {fixed}")

    # steady steps (the first allocates the accumulators and warms up)
    total_ms = sorted(totals[1:])[len(totals[1:]) // 2]
    opt_ms = sorted(opts[1:])[len(opts[1:]) // 2]
    tp = ThroughputCalculator.from_model(model).compute(
        micro * seq, total_ms / 1e3)

    # where a steady step's device time goes: one more step under
    # torch.profiler (its wall time carries the profiler's own host
    # overhead, so the idle share is taken against the unprofiled step)
    def one_step():
        nonlocal params, state
        params, state, _ = step(params, state, batch, None, lr, 0.01)
        torch.cuda.synchronize()

    groups, busy_ms, prof_wall_ms = _profile_step(one_step,
                                                  spec["label"].lower())
    idle = 1 - busy_ms / total_ms if busy_ms > 0 else None
    if busy_ms > 0:
        log(f"  one step under torch.profiler ({card}): device busy "
            f"{busy_ms:.1f} ms against an unprofiled step of "
            f"{total_ms:.1f} ms (idle share {idle:.3f}); device ms by "
            f"kernel: " + ", ".join(f"{k} {v:.1f}"
                                    for k, v in groups.items()))
    else:
        log("  one step under torch.profiler: no device time recorded "
            "(device breakdown not measured)")
    results["profiled_step"] = dict(
        profiled_wall_ms=prof_wall_ms, device_ms=busy_ms, idle_share=idle,
        device_ms_by_kernel=groups)

    results["fixed_batch"] = dict(
        losses=fixed, step_ms=totals, optimizer_ms=opts,
        median_step_ms=total_ms, median_optimizer_ms=opt_ms,
        median_fwd_bwd_ms=total_ms - opt_ms, peak_memory_gib=peak_fixed
        / 2**30, params=model.num_params(params),
        flops_per_token=model.flops_per_token(), **tp)
    mfu = ("n/a (no peak for this card)" if tp["mfu"] is None
           else f"{100 * tp['mfu']:.2f}%")
    log(f"  training throughput ({card}): {tp['tokens_per_sec']:.0f} "
        f"tokens/s, {tp['tflops_per_device']:.1f} TFLOP/s, MFU {mfu}; "
        f"step {total_ms:.1f} ms = forward+backward {total_ms - opt_ms:.1f}"
        f" ms + optimizer {opt_ms:.1f} ms; peak memory "
        f"{peak_fixed / 2**30:.2f} GiB; {model.num_params(params) / 1e9:.3f}"
        f" B params")

    # (3) one step at sequence 1000, which takes the two-pass backward
    batch = _synthetic_batch(rng, micro, 1000, vocab)
    _zero_counts()
    params, state, m = step(params, state, batch, None, lr, 0.01)
    torch.cuda.synchronize()
    counts_h = _counts()
    log(f"  step at sequence 1000: lm loss {float(m['lm loss']):.6f}, "
        f"launches {counts_h}")
    check(math.isfinite(float(m["lm loss"])), "H step: non-finite loss")
    check(counts_h["H"] == L * micro and counts_h["G"] == 0
          and counts_h["F"] == L * micro,
          f"H step launches {counts_h}")
    _check_variants(counts_h, torch.bfloat16, spec["head_dim"],
                    "step at sequence 1000")
    _add_launches(kernels, "flash_bwd", phase, counts_h["H"])
    results["h_step"] = dict(loss=float(m["lm loss"]), launches=counts_h)
    del params, state, m, step, opt, batch
    gc.collect()
    torch.cuda.empty_cache()

    # (4) the independent check in fp32: kernels against the plain path,
    # at sequence 1024 (backward G) and at 1000 (backward H, on the
    # strided views of the fused QKV output)
    fwd_norm, bwd_norm = spec["norm_rows"]
    for seq32, bwd, other in ((1024, "G", "H"), (1000, "H", "G")):
        rel_loss, worst_name, worst, counts32, pair = _fp32_grad_check(
            spec, seq32)
        log(f"  fp32 check, 2 layers at sequence {seq32}: loss kernel path "
            f"{pair[0]:.7f}, plain path {pair[1]:.7f} (relative difference "
            f"{rel_loss:.3g}, tolerance {FP32_LOSS_TOL}); worst grad leaf "
            f"{worst_name}: error / max-abs {worst:.3g} (tolerance "
            f"{FP32_GRAD_TOL}); kernel-path launches {counts32}")
        check(rel_loss <= FP32_LOSS_TOL,
              f"fp32 loss at sequence {seq32} differs by {rel_loss}")
        check(worst <= FP32_GRAD_TOL,
              f"fp32 grad of {worst_name} at sequence {seq32} differs by "
              f"{worst} of its max-abs")
        ran = {k for k, v in counts32.items() if v > 0}
        check(ran == {"F", bwd, fwd_norm, bwd_norm},
              f"the fp32 kernel path at sequence {seq32} launched "
              f"{counts32}")
        key = "fp32_check" if seq32 == 1024 else f"fp32_check_s{seq32}"
        results[key] = dict(rel_loss_diff=rel_loss, loss_kernel=pair[0],
                            loss_plain=pair[1], worst_leaf=worst_name,
                            worst_rel_err=worst, launches=counts32)


# ---------------------------------------------------------------------------
# phase 7: train on an mmap corpus, save, resume, serve the checkpoint
# ---------------------------------------------------------------------------

# the corpus: random ids below 32000 (uint16), ~2000 documents of 100-4096
# tokens, from one seed
CORPUS = dict(docs=2000, min_len=100, max_len=4096, vocab=32000, seed=1234)
# characters of the served text prompts (~0.5 tokens a character under
# the byte-pair vocabulary below)
TEXT_PROMPT_CHARS = (200, 500, 800, 1100, 1400, 1800, 2200, 2800)


def text_prompts(n, seed):
    """``n`` text prompts of random lower-case words (lengths from
    TEXT_PROMPT_CHARS, cycled), from ``seed``."""
    import numpy as np

    rng = np.random.RandomState(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    out = []
    for i in range(n):
        words, size = [], 0
        while size < TEXT_PROMPT_CHARS[i % len(TEXT_PROMPT_CHARS)]:
            w = "".join(rng.choice(letters, size=rng.randint(2, 9)))
            words.append(w)
            size += len(w) + 1
        out.append(" ".join(words))
    return out


def write_corpus(prefix, spec=CORPUS):
    """An mmap corpus of ``spec`` (``prefix``.bin/.idx, the port's
    builder); returns (documents, tokens)."""
    import numpy as np

    from megatron_llm_torch.data.indexed_dataset import make_builder

    rng = np.random.RandomState(spec["seed"])
    builder = make_builder(prefix + ".bin", vocab_size=spec["vocab"])
    tokens = 0
    for _ in range(spec["docs"]):
        n = rng.randint(spec["min_len"], spec["max_len"] + 1)
        builder.add_item(rng.randint(0, spec["vocab"], n))
        builder.end_document()
        tokens += n
    builder.finalize(prefix + ".idx")
    return spec["docs"], tokens


def _leaf_digests(tree):
    """{leaf key: (dtype, shape, sum, weighted sum)} of a tree, computed on
    the leaves' device over their bits (int64 sums of the leaf viewed as
    integers, the second weighted by position mod 1000003)."""
    import torch

    from megatron_llm_torch.checkpointing import _flat

    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = {}
    for key, t in _flat(tree).items():
        v = t.detach().reshape(-1).view(ints[t.element_size()]).to(
            torch.int64)
        w = torch.arange(1, v.numel() + 1, device=v.device) % 1000003
        out[key] = (str(t.dtype), tuple(t.shape), int(v.sum()),
                    int((v * w).sum()))
    return out


def _run_finetune(argv, entry=None, norms=None):
    """``finetune.main(argv)`` (or ``entry(argv)``) with its checkpoint IO
    and log lines observed: returns (iteration, stdout lines, {iteration:
    exact lm loss}, device digests of every leaf saved (by iteration) and
    of every leaf loaded); ``norms`` gets {iteration: exact grad norm}.
    An exit of the loop with code 0 (``--exit_interval``) returns the last
    iteration logged."""
    import contextlib
    import io

    from megatron_llm_torch import checkpointing, finetune, training

    entry = entry or finetune.main
    norms = {} if norms is None else norms
    losses, saved, loaded = {}, {}, {}
    save0, load0, log0 = (checkpointing.save_checkpoint,
                          checkpointing.load_checkpoint,
                          training.training_log)

    def save(save_dir, iteration, params, opt_state=None, *a, **kw):
        saved[iteration] = {**_leaf_digests(params), **_leaf_digests(
            checkpointing._opt_state_to_tree(opt_state))}
        return save0(save_dir, iteration, params, opt_state, *a, **kw)

    def load(*a, **kw):
        params, opt_state, meta = load0(*a, **kw)
        if params is not None:
            loaded.update(_leaf_digests(params))
        if opt_state is not None:
            loaded.update(_leaf_digests(
                checkpointing._opt_state_to_tree(opt_state)))
        return params, opt_state, meta

    def log_line(iteration, train_iters, metrics, *a, **kw):
        losses[iteration] = metrics["lm loss"]
        norms[iteration] = metrics.get("grad_norm")
        return log0(iteration, train_iters, metrics, *a, **kw)

    out = io.StringIO()
    checkpointing.save_checkpoint, checkpointing.load_checkpoint = save, load
    training.training_log = log_line
    try:
        with contextlib.redirect_stdout(out):
            it = entry(argv)
    except SystemExit as exc:
        if exc.code not in (0, None):
            raise
        it = max(losses, default=0)
    finally:
        checkpointing.save_checkpoint = save0
        checkpointing.load_checkpoint = load0
        training.training_log = log0
        for line in out.getvalue().splitlines():
            log(f"  | {line}")
    return it, out.getvalue().splitlines(), losses, saved, loaded


def _io_lines(lines, verb):
    """(bytes, seconds) of each ' [checkpoint] saved/loaded' line."""
    pat = re.compile(rf"\[checkpoint\] {verb} .*: (\d+) bytes in "
                     rf"([0-9.]+) s")
    return [(int(m.group(1)), float(m.group(2)))
            for m in map(pat.search, lines) if m]


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def _serve_text_wave(port, texts, new_tokens):
    """PUT every text prompt concurrently; returns the token lists."""
    out = [None] * len(texts)
    errors = []

    def client(i):
        try:
            out[i] = _put(port, {"prompts": [texts[i]],
                                 "tokens_to_generate": new_tokens,
                                 "temperature": 0.0})
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(f"request {i}: {type(exc).__name__}: {exc}")

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(texts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    check(not errors, "; ".join(errors))
    for i, (code, body) in enumerate(out):
        check(code == 200, f"request {i}: HTTP {code} {body}")
    return [body["tokens"][0] for _, body in out], \
        [body["text"][0] for _, body in out]


def corpus_phase(results, kernels, card, synthetic_idle):
    """Phase 7 (see the module's docstring): in a directory under build/
    that it deletes at the end."""
    import shutil

    import torch

    work = os.path.join(REPO, "build", "chip_smoke_corpus")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        _corpus_phase(results, kernels, card, synthetic_idle, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def _corpus_phase(results, kernels, card, synthetic_idle, work):
    import contextlib
    import io

    import torch

    from megatron_llm_torch import finetune
    from megatron_llm_torch.arguments import parse_args
    from megatron_llm_torch.config import (ParallelConfig,
                                           train_config_from_args)
    from megatron_llm_torch.optimizer import MegatronOptimizer
    from megatron_llm_torch.run_text_generation_server import (
        build_parser, build_server)
    from megatron_llm_torch.tokenizer import build_tokenizer
    from megatron_llm_torch.tokenizer.bpe import write_byte_bpe_vocab
    from megatron_llm_torch.training import build_train_step

    spec = TRAINING["llama"]
    L, micro, iters, seq = 2, 2, 4, spec["seq"]
    phase = "corpus Llama-2-7B"
    # (1) the corpus, written by the port's builder
    prefix = os.path.join(work, "corpus_text_document")
    t0 = time.perf_counter()
    docs, tokens = write_corpus(prefix)
    log(f"  corpus: {docs} documents, {tokens} tokens (uint16) in "
        f"{time.perf_counter() - t0:.1f} s")
    ckpt = os.path.join(work, "ckpt")
    common = spec["flags"] + [
        "--num_layers", str(L), "--seq_length", str(seq),
        "--max_position_embeddings", str(seq), "--vocab_size",
        str(CORPUS["vocab"]), "--bf16", "--micro_batch_size", "1",
        "--global_batch_size", str(micro), "--train_iters", str(iters),
        "--lr", "1e-4", "--clip_grad", "1.0", "--log_interval", "1",
        "--seed", "1234", "--data_path", prefix, "--split", "98,2,0",
        "--eval_interval", "2", "--eval_iters", "1"]

    # (2) 4 iterations straight, saving at 2 and 4
    argv = common + ["--save", ckpt, "--save_interval", "2"]
    log(f"  finetune.main({' '.join(argv)})")
    _zero_counts()
    t0 = time.perf_counter()
    it, lines_a, loss_a, saved, _ = _run_finetune(argv)
    wall_a = time.perf_counter() - t0
    counts = _counts()
    evals_a = [_log_field(ln, f"validation loss at iteration {i}")
               for i in (2, 4) for ln in lines_a
               if f"validation loss at iteration {i}:" in ln]
    check(it == iters and sorted(loss_a) == [1, 2, 3, 4],
          f"uninterrupted run: iteration {it}, losses {loss_a}")
    check(all(math.isfinite(v) for v in list(loss_a.values()) + evals_a)
          and len(evals_a) == 2,
          f"uninterrupted run: losses {loss_a}, eval losses {evals_a}")
    n_evals = 2
    want = {"F": (iters + n_evals) * L * micro, "G": iters * L * micro,
            "H": 0, "B": (iters + n_evals) * (2 * L + 1) * micro,
            "C": iters * (2 * L + 1) * micro, "D": 0, "E": 0, "A": 0,
            "A'": 0}
    log(f"  uninterrupted run: losses {loss_a}, eval losses {evals_a}; "
        f"launches {counts} (expected {want}); {wall_a:.1f} s")
    check(counts == want, f"corpus run launches {counts} != {want}")
    _check_variants(counts, torch.bfloat16, spec["head_dim"],
                    "corpus run")
    for key, row in (("F", "flash_fwd"), ("G", "flash_bwd_fused"),
                     ("B", "rmsnorm"), ("C", "rmsnorm_bwd")):
        _add_launches(kernels, row, phase + ", training", counts[key])
    steps_ms = [_log_field(ln, "elapsed time per iteration (ms)")
                for ln in lines_a if ln.startswith(" iteration")]
    saves = _io_lines(lines_a, "saved")
    check(len(saves) == 2 and sorted(saved) == [2, 4],
          f"saves {saves}, digests of iterations {sorted(saved)}")
    size = _dir_bytes(os.path.join(ckpt, "iter_0000004"))

    # (3) resume from iteration 2 and run to 4
    argv = common + ["--load", ckpt, "--load_iters", "2"]
    log(f"  finetune.main({' '.join(argv)})")
    _zero_counts()
    it, lines_b, loss_b, _, loaded = _run_finetune(argv)
    counts_b = _counts()
    check(it == iters and sorted(loss_b) == [3, 4],
          f"resumed run: iteration {it}, losses {loss_b}")
    same = sorted(k for k in saved[2] if loaded.get(k) == saved[2][k])
    check(sorted(loaded) == sorted(saved[2]) and len(same) == len(saved[2]),
          f"loaded leaves equal to the saved ones: {len(same)} of "
          f"{len(saved[2])}; differing "
          f"{sorted(set(saved[2]) - set(same))[:6]}")
    log(f"  resumed run: every one of the {len(same)} leaves loaded "
        f"(params and optimizer state) has the device digest of the leaf "
        f"saved at iteration 2")
    loads = _io_lines(lines_b, "loaded")
    evals_b = [_log_field(ln, "validation loss at iteration 4")
               for ln in lines_b if "validation loss at iteration 4:" in ln]
    d3, d4 = loss_b[3] - loss_a[3], loss_b[4] - loss_a[4]
    log(f"  resumed run: iteration 3 loss {loss_b[3]!r} against "
        f"{loss_a[3]!r} uninterrupted (difference {d3!r}, bitwise "
        f"{'equal' if d3 == 0 else 'NOT equal'}); iteration 4 {loss_b[4]!r}"
        f" against {loss_a[4]!r} (difference {d4:.3g}, tolerance "
        f"{TOL['bf16']}); eval loss at 4 {evals_b} against {evals_a[1:]};"
        f" launches {counts_b}")
    check(loss_b[3] == loss_a[3],
          f"the resumed first loss {loss_b[3]!r} is not the "
          f"uninterrupted run's {loss_a[3]!r}")
    check(abs(d4) <= TOL["bf16"], f"iteration 4 loss differs by {d4}")
    check(len(evals_b) == 1 and math.isfinite(evals_b[0]),
          f"resumed eval losses {evals_b}")
    for key, row in (("F", "flash_fwd"), ("G", "flash_bwd_fused"),
                     ("B", "rmsnorm"), ("C", "rmsnorm_bwd")):
        _add_launches(kernels, row, phase + ", resumed", counts_b[key])
    gc.collect()
    torch.cuda.empty_cache()

    save_gb_s = [b / s / 1e9 for b, s in saves]
    load_b, load_s = sum(b for b, _ in loads), sum(s for _, s in loads)
    log(f"  checkpoint IO ({card}): iteration 4 is {size / 1e9:.3f} GB on "
        f"disk; saves " + ", ".join(f"{b / 1e9:.3f} GB in {s:.2f} s "
                                    f"({b / s / 1e9:.2f} GB/s)"
                                    for b, s in saves)
        + f"; resume load {load_b / 1e9:.3f} GB in {load_s:.2f} s "
        f"({load_b / load_s / 1e9:.2f} GB/s, params then optimizer "
        f"state, to the card)")
    results.update(
        corpus_tokens=tokens, corpus_docs=docs,
        uninterrupted=dict(losses=loss_a, eval_losses=evals_a,
                           step_ms=steps_ms, launches=counts,
                           wall_secs=wall_a),
        resumed=dict(losses=loss_b, eval_losses=evals_b,
                     launches=counts_b, loss3_diff=d3, loss4_diff=d4,
                     leaves_checked=len(same)),
        checkpoint_bytes_on_disk=size,
        save=[dict(bytes=b, secs=s, gb_per_s=b / s / 1e9) for b, s in saves],
        load=dict(bytes=load_b, secs=load_s, gb_per_s=load_b / load_s / 1e9),
        save_gb_per_s=save_gb_s)

    # (4) the loader-fed step against a fixed device batch: 2 layers, the
    # same flags, a train step on the real loader's batches
    args = parse_args(common + ["--train_iters", "16"],
                      extra_args_provider=finetune.extra_args)
    finetune._apply_model_defaults(args, common)
    model = finetune.model_provider(args)
    params = model.init(1234)
    opt = MegatronOptimizer(train_config_from_args(args),
                            params_dtype=torch.bfloat16)
    state = opt.init(params)
    step = build_train_step(model, opt, ParallelConfig(), micro)
    train_iter, _ = finetune.build_data_iterator(args, micro, device="cuda")
    fixed = next(train_iter)

    def loader_step():
        nonlocal params, state
        params, state, _ = step(params, state, next(train_iter), None,
                                1e-5, 0.01)
        torch.cuda.synchronize()

    def fixed_step():
        nonlocal params, state
        params, state, _ = step(params, state, fixed, None, 1e-5, 0.01)
        torch.cuda.synchronize()

    shares = {}
    for tag, run in (("fixed", fixed_step), ("loader", loader_step)):
        run()
        times = []
        for _ in range(4):
            t0 = time.perf_counter()
            run()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = sorted(times)[len(times) // 2]
        groups, busy, _ = _profile_step(run, f"corpus_{tag}")
        idle = 1 - busy / ms if busy > 0 else None
        shares[tag] = dict(step_ms=ms, step_ms_all=times, device_ms=busy,
                           idle_share=idle, device_ms_by_kernel=groups)
    def fmt(v):
        return "not measured" if v is None else f"{v:.3f}"

    log(f"  2-layer step ({card}): on the loader's batches "
        f"{shares['loader']['step_ms']:.1f} ms, device idle share "
        f"{fmt(shares['loader']['idle_share'])}; on one batch kept on the "
        f"card {shares['fixed']['step_ms']:.1f} ms, idle share "
        f"{fmt(shares['fixed']['idle_share'])}; phase 3's synthetic "
        f"8-layer step: idle share {fmt(synthetic_idle)}")
    results["loader_step"] = shares
    results["synthetic_idle_share_phase3"] = synthetic_idle
    del params, state, step, opt, fixed, train_iter
    gc.collect()
    torch.cuda.empty_cache()

    # (5) the port's server on the iteration-4 checkpoint, with a GPT-2
    # byte-level BPE tokenizer over a 32000-id vocabulary
    vf, mf = write_byte_bpe_vocab(work, CORPUS["vocab"])
    sargs = build_parser().parse_args([
        "--model_name", "llama2", "--num_layers", str(L), "--bf16",
        "--load", ckpt, "--tokenizer_type", "GPT2BPETokenizer",
        "--vocab_file", vf, "--merge_file", mf, "--serve_max_model_len",
        "2048", "--host", "127.0.0.1", "--port", "0"])
    tok = build_tokenizer(sargs)
    check(sargs.padded_vocab_size == CORPUS["vocab"],
          f"the tokenizer pads the vocab to {sargs.padded_vocab_size}")
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        server = build_server(sargs, tok)
    for line in out.getvalue().splitlines():
        log(f"  | {line}")
    (srv_bytes, srv_secs), = _io_lines(out.getvalue().splitlines(), "loaded")
    engine = server.engine
    log(f"  server on {ckpt}: built in {time.perf_counter() - t0:.1f} s, "
        f"params loaded {srv_bytes / 1e9:.3f} GB in {srv_secs:.2f} s "
        f"({srv_bytes / srv_secs / 1e9:.2f} GB/s)")
    httpd = server.make_httpd("127.0.0.1", 0)
    port = httpd.server_address[1]
    srv = threading.Thread(target=server.run, daemon=True)
    srv.start()
    new_tokens = 64
    try:
        texts = text_prompts(8, 1234)
        prompts = [tok.tokenize(t) for t in texts]
        s0 = engine.stats()
        _zero_counts()
        outs, out_texts = _serve_text_wave(port, texts, new_tokens)
        launches = _serving_counts()
        s1 = engine.stats()
        for p, o, t, ot in zip(prompts, outs, texts, out_texts):
            check(o[:len(p)] == p and len(o) == len(p) + new_tokens,
                  f"a request returned {len(o)} tokens for a "
                  f"{len(p)}-token prompt")
            check(ot.startswith(t), "the answer's text does not start "
                                    "with its prompt")
        dec = s1["decode_steps"] - s0["decode_steps"]
        pre = s1["prefill_chunks"] - s0["prefill_chunks"]
        want = {k: 0 for k in launches}
        want["B"] = (2 * L + 1) * (dec + pre)
        want["A decode"], want["A prefill"] = L * dec, L * pre
        log(f"  served {len(texts)} text prompts of "
            f"{[len(p) for p in prompts]} tokens: {dec} decode steps, "
            f"{pre} prefill chunks; launches {launches}")
        check(launches == want, f"serving launches {launches} != {want}")
        _add_launches(kernels, "rmsnorm", phase + ", serving", launches["B"])
        _add_launches(kernels, "paged_decode", phase + ", serving",
                      launches["A decode"])
        _add_launches(kernels, "paged_prefill", phase + ", serving",
                      launches["A prefill"])
        checked = agreed = positions = 0
        for i in (2, 5):
            n_sure, n_agree, n, spread = _token_check(
                engine.model, engine.params, outs[i], len(prompts[i]),
                False, MARGIN_BOUND)
            log(f"  bf16 no-cache check on the loaded params, prompt "
                f"{len(prompts[i])}: {n_agree}/{n_sure} served tokens agree"
                f" where the top-2 margin > {MARGIN_BOUND} ({n} positions);"
                f" logits, paged vs no-cache: "
                + ", ".join(f"{k} {v:.4g}" for k, v in spread.items()))
            checked, agreed, positions = (checked + n_sure,
                                          agreed + n_agree, positions + n)
        check(checked >= MIN_CHECKED_FRACTION * positions,
              f"only {checked}/{positions} positions above the margin "
              f"bound")
        check(agreed == checked,
              f"no-cache forward disagrees at {checked - agreed} positions")
        results["served"] = dict(
            prompt_tokens=[len(p) for p in prompts], launches=launches,
            token_check=dict(checked=checked, agreed=agreed,
                             positions=positions),
            load=dict(bytes=srv_bytes, secs=srv_secs))
    finally:
        server.shutdown()
        engine.stop()
        srv.join(30)


def _log_flash_build(build):
    """Registers, spills and shared memory of every flash-attention and
    paged-attention kernel instantiation: ptxas's lines from the build,
    and the dynamic shared memory and tiles each flash (dtype, head_dim)
    launches with."""
    import ctypes

    import torch

    from megatron_llm_torch.ops.kernels import flash_attention as fa

    lines = build.build_log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\S*(flash|paged)\S*)'",
                      line)
        if not m:
            continue
        used = next((ln.split(":", 1)[1].strip() for ln in lines[i + 1:i + 4]
                     if "Used" in ln), "?")
        spill = next((ln.strip() for ln in lines[i + 1:i + 4]
                      if "spill" in ln), "?")
        log(f"  ptxas {m.group(1)}: {used}; {spill}")
    for line in lines:
        if line.startswith("ptxas") and "warn" in line.lower():
            log(f"  {line.strip()}")
    lib = build.load_library()
    for code, tag in ((1, "bf16"), (0, "fp32")):
        for d in (64, 128, 256):
            smem = (ctypes.c_longlong * 4)()
            tiles = (ctypes.c_int * 8)()
            build.check_rc(lib.mlt_flash_smem(code, d, smem), "flash smem")
            build.check_rc(lib.mlt_flash_tiles(code, d, tiles), "flash tiles")
            log(f"  flash {tag} d={d}: dynamic shared memory forward "
                f"{smem[0]} B, G {smem[1]} B, H dQ {smem[2]} B, H dK/dV "
                f"{smem[3]} B; tiles (q rows, k rows) forward "
                f"{tuple(tiles[0:2])}, G {tuple(tiles[2:4])}, H dQ "
                f"{tuple(tiles[4:6])}, H dK/dV {tuple(tiles[6:8])}")
            check(max(smem) <= 232448, f"flash {tag} d={d}: {tuple(smem)} B"
                                       f" of shared memory")
            dt = {"bf16": torch.bfloat16, "fp32": torch.float32}[tag]
            want = tuple(x for pair in fa.TILES[(dt, d)] for x in pair)
            check(tuple(tiles) == want, f"flash {tag} d={d}: the kernels' "
                  f"tiles {tuple(tiles)} differ from fa.TILES {want}")


_NORM_TYPES = (("I13__nv_bfloat16S1_", "bf16/bf16"),
               ("I13__nv_bfloat16f", "bf16/fp32"), ("Iff", "fp32/fp32"))


def _log_norm_build(build):
    """Registers and spills of every norm kernel instantiation, from
    ptxas's lines of the build: one line a kernel and (x, parameter)
    dtype pair, V (vectors a thread) by V; each kernel's RMSNorm (B, C)
    and LayerNorm (D, E) instantiations apart."""
    lines = build.build_log.splitlines()
    found = {}
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '\S*?(norm_fwd_kernel|"
                      r"norm_bwd_kernel|norm_column_pass_kernel)(\S*)'",
                      line)
        if not m:
            continue
        info = " ".join(x for x in lines[i + 1:i + 4] if "Used" in x
                        or "spill" in x)
        regs = re.search(r"Used (\d+) registers", info)
        spill = re.search(r"(\d+) bytes spill stores", info)
        types = next((t for key, t in _NORM_TYPES
                      if m.group(2).startswith(key)), "")
        v = re.search(r"Li(\d)E", m.group(2))
        rms = re.search(r"Lb([01])E", m.group(2))
        names = (("B", "D") if m.group(1) == "norm_fwd_kernel"
                 else ("C", "E"))
        kernel = m.group(1) + (
            f" ({names[0]}, RMSNorm)" if rms and rms.group(1) == "1"
            else f" ({names[1]}, LayerNorm)" if rms else "")
        found.setdefault((kernel, types), []).append(
            (int(v.group(1)) if v else 0, regs.group(1) if regs else "?",
             spill.group(1) if spill else "?"))
    for (kernel, types), rows in sorted(found.items()):
        log(f"  ptxas {kernel} {types}: " + ", ".join(
            (f"V{v} " if v else "") + f"{r} registers"
            + (f" ({sp} B spilled)" if sp not in ("0", "?") else "")
            for v, r, sp in sorted(rows)))


# ---------------------------------------------------------------------------
# phase 8: GPT-2 345M pretraining with its dropouts
# ---------------------------------------------------------------------------

# the corpus: random ids below GPT-2's 50257 (uint16), documents of
# 100-4096 tokens, from one seed: enough for 20 iterations of 8 samples
# and a 5% valid split that holds three evaluations of 10 batches
GPT2_CORPUS = dict(docs=2500, min_len=100, max_len=4096, vocab=50257,
                   seed=1234)
# examples/pretrain_gpt.sh, with 20 iterations and eval every 10
GPT2_FLAGS = [
    "--num_layers", "24", "--hidden_size", "1024",
    "--num_attention_heads", "16", "--seq_length", "1024",
    "--max_position_embeddings", "1024", "--micro_batch_size", "4",
    "--global_batch_size", "8", "--lr_decay_iters", "320000",
    "--lr", "0.00015", "--min_lr", "1e-5", "--lr_decay_style", "cosine",
    "--lr_warmup_fraction", "0.01", "--weight_decay", "0.01",
    "--clip_grad", "1.0", "--bf16", "--split", "949,50,1",
    "--tokenizer_type", "GPT2BPETokenizer", "--log_interval", "1",
    "--eval_interval", "10", "--eval_iters", "10", "--seed", "1234"]


@contextlib.contextmanager
def _optimizer_peaks(peaks):
    """Record, at each optimizer step, the peak device memory since the
    last step ended (the forward and backward, and any eval between) and
    the peak of the step itself, in GiB."""
    import torch

    from megatron_llm_torch.optimizer import MegatronOptimizer

    step0 = MegatronOptimizer.step

    def step(self, *a, **kw):
        peaks.setdefault("fwd_bwd", []).append(
            torch.cuda.max_memory_allocated() / 2**30)
        torch.cuda.reset_peak_memory_stats()
        out = step0(self, *a, **kw)
        peaks.setdefault("optimizer", []).append(
            torch.cuda.max_memory_allocated() / 2**30)
        torch.cuda.reset_peak_memory_stats()
        return out

    MegatronOptimizer.step = step
    torch.cuda.reset_peak_memory_stats()
    try:
        yield peaks
    finally:
        MegatronOptimizer.step = step0


def _entry_run(entry, argv, label):
    """One run of a training entry point: (iteration, log lines, exact
    losses, exact grad norms, launches, peaks, wall seconds)."""
    import torch

    log(f"  {label}: {entry.__module__}.main({' '.join(argv)})")
    _zero_counts()
    norms, peaks = {}, {}
    t0 = time.perf_counter()
    with _optimizer_peaks(peaks):
        it, lines, losses, _, _ = _run_finetune(argv, entry=entry,
                                                norms=norms)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    return it, lines, losses, norms, _counts(), peaks, wall


def _loop_numbers(lines, skip_first=True):
    """Step ms, tokens/s and MFU (%) of the log's iteration lines."""
    its = [ln for ln in lines if ln.startswith(" iteration")]
    its = its[1:] if skip_first and len(its) > 1 else its
    return dict(
        step_ms=[_log_field(ln, "elapsed time per iteration (ms)")
                 for ln in its],
        tokens_per_sec=[_log_field(ln, "tokens per second") for ln in its],
        mfu_pct=[_log_field(ln, "MFU") for ln in its])


def _median(xs):
    xs = sorted(x for x in xs if x is not None)
    return xs[len(xs) // 2] if xs else None


def gpt2_phase(results, kernels, card):
    """Phase 8 (see the module's docstring): in a directory under build/
    that it deletes at the end."""
    import shutil

    import torch

    work = os.path.join(REPO, "build", "chip_smoke_gpt2")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        _gpt2_phase(results, kernels, card, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def _gpt2_phase(results, kernels, card, work):
    import torch

    from megatron_llm_torch import pretrain_gpt
    from megatron_llm_torch.tokenizer.bpe import write_byte_bpe_vocab

    L, micro, iters, evals, eval_iters = 24, 2, 20, 2, 10
    phase = "pretraining GPT-2 345M"
    prefix = os.path.join(work, "corpus_text_document")
    t0 = time.perf_counter()
    docs, tokens = write_corpus(prefix, GPT2_CORPUS)
    vf, mf = write_byte_bpe_vocab(work, GPT2_CORPUS["vocab"])
    log(f"  corpus: {docs} documents, {tokens} tokens below "
        f"{GPT2_CORPUS['vocab']} (uint16), byte-level BPE of "
        f"{GPT2_CORPUS['vocab']} ids, in {time.perf_counter() - t0:.1f} s")
    common = GPT2_FLAGS + ["--data_path", prefix, "--vocab_file", vf,
                           "--merge_file", mf]

    def argv(n, *extra):
        return common + ["--train_iters", str(n)] + list(extra)

    # (1) 20 iterations with the parser's dropouts (0.1 and 0.1)
    it, lines, loss, norm, counts, peaks, wall = _entry_run(
        pretrain_gpt.main, argv(iters), "dropout 0.1/0.1")
    check(it == iters and sorted(loss) == list(range(1, iters + 1)),
          f"GPT-2 run: iteration {it}, losses {sorted(loss)}")
    check(any("padded vocab (size: 50257)" in ln and "50304" in ln
              for ln in lines), "the tokenizer did not pad 50257 to 50304")
    vals = [_log_field(ln, f"validation loss at iteration {i}")
            for i in (10, 20) for ln in lines
            if f"validation loss at iteration {i}:" in ln]
    check(len(vals) == evals and all(math.isfinite(v) for v in
                                     list(loss.values()) + vals),
          f"GPT-2 run: losses {loss}, eval losses {vals}")
    # a random model predicts about uniformly over the padded vocabulary:
    # the first loss lies near ln 50304
    check(abs(loss[1] - math.log(50304)) <= 0.5,
          f"first loss {loss[1]}, ln 50304 = {math.log(50304):.4f}")
    # training takes core_attention (attention dropout), the evaluations
    # flash attention; every norm is the LayerNorm kernels
    want = {"F": evals * eval_iters * L * micro, "G": 0, "H": 0,
            "D": (iters + evals * eval_iters) * (2 * L + 1) * micro,
            "E": iters * (2 * L + 1) * micro, "B": 0, "C": 0, "A": 0,
            "A'": 0}
    nums = _loop_numbers(lines)
    log(f"  GPT-2 345M ({card}): losses {[loss[i] for i in (1, 10, 20)]} "
        f"at iterations 1, 10, 20; eval losses {vals}; step "
        f"{_median(nums['step_ms'])} ms, {_median(nums['tokens_per_sec'])} "
        f"tokens/s, MFU {_median(nums['mfu_pct'])}% (medians after "
        f"iteration 1); peak memory forward+backward "
        f"{max(peaks['fwd_bwd']):.2f} GiB, optimizer "
        f"{max(peaks['optimizer']):.2f} GiB; launches {counts} (expected "
        f"{want}); {wall:.1f} s")
    check(counts == want, f"GPT-2 launches {counts} != {want}")
    _check_variants(counts, torch.bfloat16, 64, "GPT-2 345M evaluations")
    for key, row in (("F", "flash_fwd"), ("D", "layernorm"),
                     ("E", "layernorm_bwd")):
        _add_launches(kernels, row, phase, counts[key])
    results["dropout"] = dict(
        losses=loss, grad_norms=norm, eval_losses=vals, launches=counts,
        peak_fwd_bwd_gib=max(peaks["fwd_bwd"]),
        peak_optimizer_gib=max(peaks["optimizer"]), wall_secs=wall, **nums)

    # (2) the same run again, both dropouts at 0, full recompute, LIMA:
    # one iteration each (--exit_interval 1: the samples' order depends on
    # --train_iters), against the iteration-1 loss and grad norm
    variants = (
        ("same seed", [], True),
        ("dropout 0", ["--hidden_dropout", "0", "--attention_dropout", "0"],
         False),
        ("recompute full", ["--recompute_granularity", "full"], True),
        ("lima", ["--lima_dropout"], None))
    for label, extra, same in variants:
        it, lines, l1, n1, counts, peaks, wall = _entry_run(
            pretrain_gpt.main, argv(iters, "--exit_interval", "1", *extra),
            label)
        check(it == 1 and math.isfinite(l1[1]), f"{label}: {l1}")
        rel = abs(n1[1] - norm[1]) / abs(norm[1])
        log(f"  {label}: iteration-1 loss {l1[1]!r} against {loss[1]!r} "
            f"({'equal' if l1[1] == loss[1] else 'different'}), grad norm "
            f"{n1[1]!r} against {norm[1]!r} (relative {rel:.3g}); peak "
            f"memory forward+backward {max(peaks['fwd_bwd']):.2f} GiB; "
            f"launches {counts}; {wall:.1f} s")
        if same is True:
            check(l1[1] == loss[1], f"{label}: the iteration-1 loss "
                                    f"{l1[1]!r} is not {loss[1]!r}")
            check(rel <= 1e-3, f"{label}: grad norm off by {rel}")
        elif same is False:
            check(l1[1] != loss[1], f"{label}: the loss did not change")
        rec = 2 if label == "recompute full" else 1
        want = {"F": 0, "G": 0, "H": 0,
                "D": (rec * 2 * L + 1) * micro, "E": (2 * L + 1) * micro,
                "B": 0, "C": 0, "A": 0, "A'": 0}
        if label == "dropout 0":
            # no attention dropout: flash attention trains
            want.update(F=L * micro, G=L * micro)
        check(counts == want, f"{label}: launches {counts} != {want}")
        for key, row in (("F", "flash_fwd"), ("G", "flash_bwd_fused"),
                         ("D", "layernorm"), ("E", "layernorm_bwd")):
            _add_launches(kernels, row, f"{phase}, {label}", counts[key])
        results[label.replace(" ", "_")] = dict(
            loss=l1[1], grad_norm=n1[1], grad_norm_rel=rel, launches=counts,
            peak_fwd_bwd_gib=max(peaks["fwd_bwd"]), wall_secs=wall)


# ---------------------------------------------------------------------------
# phase 9: Llama-3-8B's width at its own sequence 8192
# ---------------------------------------------------------------------------

LLAMA3_FLAGS = [
    "--model_name", "llama3", "--num_layers", "4", "--hidden_size", "4096",
    "--num_attention_heads", "32", "--num_attention_heads_kv", "8",
    "--ffn_hidden_size", "14336", "--vocab_size", "128256",
    "--seq_length", "8192", "--max_position_embeddings", "8192", "--bf16",
    "--micro_batch_size", "1", "--global_batch_size", "2",
    "--train_iters", "3", "--lr", "1e-4", "--clip_grad", "1.0",
    "--log_interval", "1", "--seed", "1234"]
LLAMA3_VARIANTS = (
    ("fused CE", ["--fused_lm_cross_entropy"]),
    ("defaults", []),
    ("fused CE, recompute selective",
     ["--fused_lm_cross_entropy", "--recompute_granularity", "selective"]),
    ("fused CE, recompute full",
     ["--fused_lm_cross_entropy", "--recompute_granularity", "full"]),
    ("fused CE, no flash", ["--fused_lm_cross_entropy", "--no_flash_attn"]),
)


def llama3_phase(results, kernels, card):
    import torch

    from megatron_llm_torch import finetune
    from megatron_llm_torch.models.llama import llama_config

    L, micro, iters, seq = 4, 2, 3, 8192
    phase = "training Llama-3-8B"
    ref = llama_config("llama3-8B", num_layers=L)
    runs = {}
    for label, extra in LLAMA3_VARIANTS:
        it, lines, loss, norm, counts, peaks, wall = _entry_run(
            finetune.main, LLAMA3_FLAGS + extra, label)
        check(it == iters and all(math.isfinite(loss[i]) for i in loss),
              f"{label}: iteration {it}, losses {loss}")
        auto = any("auto-enabling fused_lm_cross_entropy" in ln
                   for ln in lines)
        note = any("padded_vocab_size >= 64k" in ln for ln in lines)
        nums = _loop_numbers(lines)
        runs[label] = r = dict(
            losses=loss, grad_norms=norm, launches=counts,
            peak_fwd_bwd_gib=max(peaks["fwd_bwd"]),
            peak_optimizer_gib=max(peaks["optimizer"]), wall_secs=wall,
            policy_auto_on=auto, policy_note=note, **nums)
        log(f"  {label} ({card}): losses {[loss[i] for i in sorted(loss)]}"
            f", grad norms {[norm[i] for i in sorted(norm)]}; step "
            f"{_median(nums['step_ms'])} ms, "
            f"{_median(nums['tokens_per_sec'])} tokens/s, MFU "
            f"{_median(nums['mfu_pct'])}% (iterations 2-3); peak memory "
            f"forward+backward {r['peak_fwd_bwd_gib']:.2f} GiB, optimizer "
            f"{r['peak_optimizer_gib']:.2f} GiB; launches {counts}; policy "
            f"auto-on {auto}, 64k note {note}; {wall:.1f} s")
        # per step: attention once a layer and micro-batch (twice under
        # recompute), two norms a layer plus the final one (the layers'
        # twice under recompute)
        rec = 2 if "recompute" in label else 1
        flash = "no flash" not in label
        want = {"F": iters * rec * L * micro * flash,
                "G": iters * L * micro * flash, "H": 0,
                "B": iters * (rec * 2 * L + 1) * micro,
                "C": iters * (2 * L + 1) * micro, "D": 0, "E": 0, "A": 0,
                "A'": 0}
        check(counts == want, f"{label}: launches {counts} != {want}")
        if flash:
            _check_variants(counts, torch.bfloat16, ref.head_dim, label)
        for key, row in (("F", "flash_fwd"), ("G", "flash_bwd_fused"),
                         ("B", "rmsnorm"), ("C", "rmsnorm_bwd")):
            _add_launches(kernels, row, f"{phase}, {label}", counts[key])
    a = runs["fused CE"]
    # at 128256 ids the policy (on from 131072) leaves the head unfused
    # and says so; the explicit flag is what turns it on
    check(not runs["defaults"]["policy_auto_on"]
          and runs["defaults"]["policy_note"],
          "the fused-CE policy did not leave 128256 ids unfused with its "
          "note")
    for label, r in runs.items():
        if label == "fused CE":
            continue
        rel = abs(r["losses"][1] - a["losses"][1]) / abs(a["losses"][1])
        nrel = abs(r["grad_norms"][1] - a["grad_norms"][1]) \
            / abs(a["grad_norms"][1])
        r.update(loss1_rel=rel, grad_norm1_rel=nrel)
        log(f"  {label} against fused CE: iteration-1 loss relative "
            f"{rel:.3g}, grad norm relative {nrel:.3g}")
        if "recompute" in label:
            check(r["losses"][1] == a["losses"][1],
                  f"{label}: iteration-1 loss {r['losses'][1]!r} is not "
                  f"{a['losses'][1]!r}")
            check(nrel <= 1e-3, f"{label}: grad norm off by {nrel}")
        else:
            check(rel <= 1e-3, f"{label}: iteration-1 loss off by {rel}")
    extra_gib = runs["defaults"]["peak_fwd_bwd_gib"] - a["peak_fwd_bwd_gib"]
    sel = runs["fused CE, recompute selective"]["peak_fwd_bwd_gib"]
    full = runs["fused CE, recompute full"]["peak_fwd_bwd_gib"]
    log(f"  peak forward+backward memory: unfused head +{extra_gib:.2f} GiB"
        f" over fused; recompute full {full:.2f} < selective {sel:.2f} < "
        f"none {a['peak_fwd_bwd_gib']:.2f} GiB")
    check(extra_gib * 2**30 >= 6e9,
          f"the unfused head adds only {extra_gib:.2f} GiB")
    check(full < sel < a["peak_fwd_bwd_gib"],
          f"recompute peaks full {full}, selective {sel}, none "
          f"{a['peak_fwd_bwd_gib']}")
    results.update(runs=runs, unfused_extra_gib=extra_gib,
                   config=dict(hidden=ref.hidden_size,
                               heads=ref.num_attention_heads,
                               kv_heads=ref.num_query_groups,
                               ffn=ref.ffn_hidden_size,
                               vocab=ref.padded_vocab_size,
                               rope_theta=ref.rope_theta, layers=L,
                               seq=seq))


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--measure", action="store_true",
        help="build the kernels, time B, C, D, E and H at their main-path "
             "shapes (norm_times, h_and_d_times; B's and C's host work by "
             "part, b_host_breakdown, c_host_breakdown) and stop: no phase "
             "runs, no result line")
    parser.add_argument(
        "--sweep", action="store_true",
        help="with --measure: also time B, C, D and E under other plans "
             "(fwd_plan_sweep, e_plan_sweep, c_plan_sweep) and D's "
             "wrapper's host work (d_host_breakdown)")
    opts = parser.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: FAIL: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "megatron_llm_torch")):
        print("chip_smoke: FAIL: megatron_llm_torch/ not found beside "
              "chip_smoke.py (run it from a checkout of the repo)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    os.makedirs(OUT_DIR, exist_ok=True)
    _LOG_FILES.append(open(os.path.join(OUT_DIR, "chip_smoke.log"), "w"))

    # phase 0: device, numerics, build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmuls and cuDNN (fp32 comparisons run in full fp32)")
    from megatron_llm_torch.ops.kernels import build

    t0 = time.perf_counter()
    lib_path = build.build()
    build.load_library()
    log(f"phase 0: kernels built from megatron_llm_torch/csrc in "
        f"{time.perf_counter() - t0:.1f} s -> "
        f"{os.path.relpath(lib_path, REPO)}")
    with open(os.path.join(OUT_DIR, "chip_smoke_build.log"), "w") as f:
        f.write(build.build_log)
    _log_flash_build(build)
    _log_norm_build(build)

    kernels = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    if opts.measure:
        log(f"B, C, D, E and H times ({card})")
        # the sweeps and every eager timing first: the profiler windows of
        # h_and_d_times and norm_profiles come last
        sweep = dict(D_plans=fwd_plan_sweep(gen, "D"),
                     B_plans=fwd_plan_sweep(gen, "B"),
                     E_plans=e_plan_sweep(gen), C_plans=c_plan_sweep(gen),
                     D_host_us=d_host_breakdown()) if opts.sweep else None
        b_host = b_host_breakdown()
        c_host = c_host_breakdown()
        norms, norm_runs = norm_times(gen)
        res = {"card": card, **h_and_d_times(gen), **norms,
               "B_host_us": b_host, "C_host_us": c_host}
        norm_profiles(norms, norm_runs)
        if sweep is not None:
            res.update(sweep)
        print(json.dumps(res), flush=True)
        return 0
    t0 = time.perf_counter()
    log("phase 1: serving kernels vs plain versions")
    phase1(gen, kernels)
    log("phase 1: training kernels vs plain versions")
    phase1_training(gen, kernels)
    log("phase 1: B, C, D, E and H timed at their main-path shapes")
    phase1_times(gen, kernels)
    log(f"phase 1 passed in {time.perf_counter() - t0:.1f} s")
    serving, training = {}, {}
    for number, kind, family in ((2, "serving", "llama"),
                                 (3, "training", "llama"),
                                 (4, "serving", "falcon"),
                                 (5, "training", "falcon"),
                                 (6, "training", "gemma")):
        t0 = time.perf_counter()
        out = (serving if kind == "serving" else training).setdefault(
            family, {})
        if kind == "serving":
            spec = SERVING[family]
            log(f"phase {number}: {spec['label']} through the port's HTTP "
                f"server" + (" over int8 KV pools" if spec["quantized"]
                             else ""))
            serve_phase(out, kernels, spec)
        else:
            spec = TRAINING[family]
            log(f"phase {number}: training {spec['label']} width, "
                f"{spec.get('layers', 8)} layers, sequence {spec['seq']}, "
                f"through megatron_llm_torch.finetune")
            train_phase(out, kernels, card, spec)
        log(f"phase {number} passed in {time.perf_counter() - t0:.1f} s")
        log(f"{kind} {spec['label']} ({card}): " + json.dumps(out))
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log("phase 7: Llama-2-7B width, 2 layers, sequence 4096, trained on an "
        "mmap corpus, saved, resumed and served from its checkpoint")
    corpus = {}
    corpus_phase(corpus, kernels, card,
                 training["llama"]["profiled_step"]["idle_share"])
    log(f"phase 7 passed in {time.perf_counter() - t0:.1f} s")
    log(f"corpus Llama-2-7B ({card}): " + json.dumps(corpus))
    t0 = time.perf_counter()
    log("phase 8: GPT-2 345M pretraining at full width and depth with its "
        "dropouts, through megatron_llm_torch.pretrain_gpt")
    gpt2 = {}
    gpt2_phase(gpt2, kernels, card)
    log(f"phase 8 passed in {time.perf_counter() - t0:.1f} s")
    log(f"pretraining GPT-2 345M ({card}): " + json.dumps(gpt2))
    t0 = time.perf_counter()
    log("phase 9: Llama-3-8B width, 4 layers, sequence 8192: the fused LM "
        "head cross entropy, recompute and the chunked attention")
    llama3 = {}
    llama3_phase(llama3, kernels, card)
    log(f"phase 9 passed in {time.perf_counter() - t0:.1f} s")
    log(f"training Llama-3-8B ({card}): " + json.dumps(llama3))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    names = ("paged_decode", "paged_prefill", "paged_decode_int8",
             "paged_prefill_int8", "rmsnorm", "rmsnorm_bwd", "layernorm",
             "layernorm_bwd", "flash_fwd", "flash_bwd_fused", "flash_bwd")
    for n in names:
        check(kernels[n].get("launches", 0) > 0,
              f"{n} was not launched on its path")
    # and, where a row has them, its device times and its plan or variant
    extra = ("ms_with_rstd", "device_ms", "library_device_ms",
             "training_device_ms",
             "first_device_ms", "column_device_ms", "dq_device_ms",
             "dkv_device_ms", "plan", "variant")
    line = {"kernels": [{k: kernels[n][k] for k in keys + extra
                         if k in keys or k in kernels[n]} for n in names]}
    with open(os.path.join(OUT_DIR, "chip_smoke_result.json"), "w") as f:
        json.dump({"card": card, "kernels": kernels, "serving": serving,
                   "training": training, "corpus": corpus, "gpt2": gpt2,
                   "llama3": llama3}, f, indent=1)
    log(card)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        for f in _LOG_FILES:
            f.write(f"chip_smoke: FAIL: {exc}\n")
        sys.exit(1)
    finally:
        for f in _LOG_FILES:
            f.close()
