#!/usr/bin/env python3
"""Quickest proof that the PyTorch port starts and serves on one GPU.

    python3 chip_smoke.py

Phase 0 prints the card and builds the port's CUDA kernels from
``megatron_llm_torch/csrc``.  Phase 1 holds each kernel against its plain
PyTorch version on the card, in bf16 and fp32, at the serving path's
Llama-2-7B shapes and at edge cases (GQA, sliding windows, empty
context, chunks across page boundaries), and times the kernel, the plain
version and one PyTorch library call.  Phase 2 starts the port's HTTP
server through ``build_server`` with Llama-2-7B at full width (random
bf16 weights from a seed), answers ``PUT /api`` requests, and checks
that every request finished, that a repeated request gives the same
tokens, that both kernels ran exactly as often as the engine's dispatch
counts say, that each repeated prefix hit the prefix cache for exactly
its full cached pages, and that an independent no-cache forward
(neither kernel: plain norm and ``core_attention``) agrees with the
served tokens.  Then, on the stopped engine, it forces the
copy-on-write of a page two requests share and checks the copy.

It prints, before its last line, the card's name and power limit, one
JSON line with every kernel's numbers (``{"kernels": [...]}``), and as
its last line ``{"ok": true, "device": {...}}``.  Any failed check exits
non-zero without that line; so does a run without a CUDA device or
outside a checkout of the repo.  Long logs go to ``chiprun_out/``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")

# tolerances (max-abs, kernel vs plain version on identical inputs): the
# bf16 tolerance of tests/test_pallas_kernels.py, and fp32 at 1e-4
TOL = {"bf16": 2e-2, "fp32": 1e-4}
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


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


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


def bound(nbytes: float, flops: float, flop_rate: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------

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


def _paged_bytes_flops(S, C, nh, g, d, bs, ctx, window, itemsize):
    """Bytes the function must move (q in, out, and each slot's live K/V
    pages of every group, read once) and its matmul operations."""
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
    kv = pages * bs * g * d * 2 * itemsize
    qo = 2 * S * C * nh * d * itemsize
    return kv + qo + S * 4 * 2, flops


def phase1(gen, results):
    import torch
    import torch.nn.functional as F

    from megatron_llm_torch.ops.kernels import paged_attention as pa
    from megatron_llm_torch.ops.kernels import rmsnorm as rn

    dts = {"bf16": torch.bfloat16, "fp32": torch.float32}

    # -- kernel B: RMSNorm ------------------------------------------------
    err = {"bf16": 0.0, "fp32": 0.0}
    for tag, dt in dts.items():
        for n, h in ((8, 4096), (64, 4096), (3, 128), (17, 11008 // 2)):
            x = (torch.randn(n, h, device="cuda", generator=gen) * 3).to(dt)
            s = (torch.rand(h, device="cuda", generator=gen) + 0.5).to(dt)
            y, r = rn.rms_norm_fwd_kernel(x, s, 1e-5)
            y0, r0 = rn.rms_norm_fwd_plain(x, s, 1e-5)
            torch.cuda.synchronize()
            e = max((y.float() - y0.float()).abs().max().item(),
                    (r - r0).abs().max().item())
            log(f"  rmsnorm {tag} n={n} h={h}: max_abs_err {e:.3g}")
            check(e <= TOL[tag], f"rmsnorm {tag} n={n} h={h}: {e} > "
                                 f"{TOL[tag]}")
            err[tag] = max(err[tag], e)
    # timing at the serving path's decode shape: 8 rows of 4096, bf16
    n, h = 8, 4096
    x = torch.randn(n, h, device="cuda", generator=gen).to(torch.bfloat16)
    s = torch.ones(h, device="cuda", dtype=torch.bfloat16)
    ms = time_ms(lambda: rn.rms_norm_fwd_kernel(x, s, 1e-5), iters=200)
    plain_ms = time_ms(lambda: rn.rms_norm_fwd_plain(x, s, 1e-5), iters=200)
    lib_ms = time_ms(lambda: F.rms_norm(x, (h,), weight=s, eps=1e-5),
                     iters=200)
    b_ms, b_by = bound(2 * n * h * 2 + h * 2 + n * 4, 4 * n * h, FP32_FLOPS)
    results["rmsnorm"] = dict(
        name="rmsnorm_fwd", route="cuda",
        source="megatron_llm_torch/csrc/rmsnorm.cu",
        replaces="megatron_llm_tpu/ops/pallas/rmsnorm.py:56",
        max_abs_err=err["bf16"], max_abs_err_fp32=err["fp32"],
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms, shape=f"x [{n}, {h}] bf16")
    log(f"  rmsnorm [8, 4096] bf16: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, F.rms_norm {lib_ms:.4f} ms, bound "
        f"{b_ms:.5f} ms ({b_by})")

    # -- kernel A: ragged paged attention --------------------------------
    # (S, C, nh, g, d, bs, M, ctx, window, block_q)
    cases = [
        ("7B decode", 8, 1, 32, 32, 128, 16, 128,
         [0, 37, 100, 513, 1000, 1200, 1500, 2000], None, None),
        ("7B prefill", 1, 64, 32, 32, 128, 16, 128, [1000], None, None),
        ("7B prefill ctx 0", 1, 64, 32, 32, 128, 16, 128, [0], None, None),
        ("GQA g8 decode", 8, 1, 32, 8, 128, 16, 128,
         [0, 5, 16, 17, 300, 700, 1100, 2000], None, None),
        ("GQA g8 prefill", 2, 64, 32, 8, 128, 16, 128, [7, 250], None, 16),
        ("Mistral window 4096 decode", 4, 1, 32, 8, 128, 16, 320,
         [0, 4095, 4100, 5000], 4096, None),
        ("window 5 prefill", 3, 64, 32, 8, 128, 16, 16, [0, 3, 40], 5, 8),
        ("window 12 decode, bs 8", 4, 1, 8, 2, 64, 8, 16,
         [0, 7, 30, 100], 12, None),
        ("page-crossing chunk, ctx % bs != 0", 2, 64, 32, 32, 128, 16, 8,
         [9, 55], None, None),
    ]
    err = {"decode": {"bf16": 0.0, "fp32": 0.0},
           "prefill": {"bf16": 0.0, "fp32": 0.0}}
    for (label, S, C, nh, g, d, bs, M, ctx, window, bq) in cases:
        for tag, dt in dts.items():
            q, kp, vp, bt, cl = _paged_case(gen, S, C, nh, g, d, bs, M, ctx,
                                            dt)
            scale = 1.0 / math.sqrt(d)
            if C == 1:
                kind = "decode"
                out = pa.paged_attention_decode(q[:, 0].contiguous(), kp, vp,
                                                bt, cl, sliding_window=window)
                ref = pa._reference_paged_attention(q[:, 0], kp, vp, bt, cl,
                                                    scale, window)
            else:
                kind = "prefill"
                out = pa.paged_attention_prefill(q, kp, vp, bt, cl,
                                                 sliding_window=window,
                                                 block_q=bq)
                ref = pa._reference_paged_prefill(q, kp, vp, bt, cl, scale,
                                                  window)
            torch.cuda.synchronize()
            e = (out.float() - ref.float()).abs().max().item()
            log(f"  paged attention {label} {tag}: max_abs_err {e:.3g}")
            check(math.isfinite(e) and e <= TOL[tag],
                  f"paged attention {label} {tag}: {e} > {TOL[tag]}")
            err[kind][tag] = max(err[kind][tag], e)

    # timing at the serving path's shapes, bf16
    for kind, (S, C, ctx) in (("decode", (8, 1, [1000] * 8)),
                              ("prefill", (1, 64, [1000]))):
        nh = g = 32
        d, bs, M = 128, 16, 128
        q, kp, vp, bt, cl = _paged_case(gen, S, C, nh, g, d, bs, M, ctx,
                                        torch.bfloat16)
        scale = 1.0 / math.sqrt(d)
        if kind == "decode":
            q1 = q[:, 0].contiguous()
            run = lambda: pa.paged_attention_decode(q1, kp, vp, bt, cl)
            plain = lambda: pa._reference_paged_attention(q1, kp, vp, bt, cl,
                                                          scale, None)
        else:
            run = lambda: pa.paged_attention_prefill(q, kp, vp, bt, cl)
            plain = lambda: pa._reference_paged_prefill(q, kp, vp, bt, cl,
                                                        scale, None)
        ms = time_ms(run, iters=50)
        plain_ms = time_ms(plain, iters=10)
        sweep = None
        if kind == "prefill":
            # query rows per block (block_q, as qpg = 1 here): the sweep
            # behind the wrapper's default, _KERNEL_ROWS_PER_BLOCK
            sweep = {bq: time_ms(lambda bq=bq: pa.paged_attention_prefill(
                q, kp, vp, bt, cl, block_q=bq), iters=50)
                for bq in (1, 2, 4, 8, 16, 32, 64)}
            log("  paged attention prefill, ms by query rows per block: "
                + ", ".join(f"{bq}: {t:.4f}" for bq, t in sweep.items()))
        # library yardstick: SDPA over a pre-gathered dense [S, nh, T, d]
        # view of each slot's live keys (the gather is not timed)
        T = ctx[0] + C
        kd = kp[bt.long()].reshape(S, M * bs, g, d)[:, :T].transpose(1, 2)
        vd = vp[bt.long()].reshape(S, M * bs, g, d)[:, :T].transpose(1, 2)
        kd, vd = kd.contiguous(), vd.contiguous()
        qd = q.transpose(1, 2).contiguous()                 # [S, nh, C, d]
        kpos = torch.arange(T, device="cuda")
        qpos = ctx[0] + torch.arange(C, device="cuda")
        mask = (kpos[None, :] <= qpos[:, None])[None, None]
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask), iters=50)
        nbytes, flops = _paged_bytes_flops(S, C, nh, g, d, bs, ctx, None, 2)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
        results[f"paged_{kind}"] = dict(
            name=f"paged_attention_{kind}", route="cuda",
            source="megatron_llm_torch/csrc/paged_attention.cu",
            replaces="megatron_llm_tpu/ops/pallas/paged_attention.py:133",
            max_abs_err=err[kind]["bf16"],
            max_abs_err_fp32=err[kind]["fp32"],
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, rows_per_block_ms=sweep,
            shape=f"S={S} C={C} nh=g=32 d=128 bs=16 ctx={ctx[0]} bf16")
        log(f"  paged attention {kind} {results[f'paged_{kind}']['shape']}: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA over a "
            f"pre-gathered dense K/V (gather not timed) {lib_ms:.4f} ms, "
            f"bound {b_ms:.5f} ms ({b_by})")


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


def _paged_logits(model, params, tokens, chunk=64):
    """Teacher-forced logits of ``tokens`` through the paged path with
    both kernels: chunked prefill into a fresh one-slot pool."""
    import torch

    from megatron_llm_torch.models.language_model import (
        language_model_forward)
    from megatron_llm_torch.text_generation.generation import (
        init_paged_kv_caches)

    cfg = model.cfg
    bs = 16
    M = -(-len(tokens) // bs) + chunk // bs
    pages = init_paged_kv_caches(cfg, 1 + M, bs, device="cuda")
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
        logits, _ = language_model_forward(params, toks, pos, None, cfg,
                                           kv_caches=caches)
        out.append(logits[0, :len(part)].float())
    return torch.cat(out)


def _no_cache_logits(model, params, tokens, cfg=None):
    """Teacher-forced logits [T, V] of ``tokens`` through the no-cache
    forward with plain norms and core_attention (neither kernel)."""
    import torch

    from megatron_llm_torch.models.language_model import (
        language_model_forward)

    cfg = (cfg or model.cfg).replace(use_fused_rmsnorm=False)
    inp = torch.tensor([tokens], device="cuda")
    return language_model_forward(params, inp, None, None, cfg)[0].float()


def _token_check(model, params, tokens, n_prompt):
    """Served tokens vs the bf16 no-cache argmax.  Returns (positions
    above the margin bound, agreements among them, positions, and the
    spread of the bf16 teacher-forced logits of the two paths)."""
    import torch

    logits = _no_cache_logits(model, params, tokens[:-1])
    paged = _paged_logits(model, params, tokens[:-1])
    diff = (paged - logits).abs().flatten()
    k999 = max(1, math.ceil(0.999 * diff.numel()))
    spread = dict(mean_abs_diff=diff.mean().item(),
                  p999_abs_diff=diff.kthvalue(k999).values.item(),
                  max_abs_diff=diff.max().item(),
                  logit_std=logits.std().item())
    gen = logits[n_prompt - 1:]                 # predicts tokens[n_prompt:]
    want = torch.tensor(tokens[n_prompt:], device="cuda")
    top2 = torch.topk(gen, 2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > MARGIN_BOUND
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
    bit for bit while both requests still give their served tokens.
    Runs on the stopped engine, single-stepped."""
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
    return a.cached_prompt_tokens, b.cached_prompt_tokens


def _fp32_path_check(model, params, tokens):
    """Max |logit diff| between the paged path (both kernels, fp32
    variants) and the no-cache path, with fp32 params and compute."""
    import torch

    from megatron_llm_torch.models.transformer import tree_map

    cfg32 = model.cfg.replace(params_dtype="fp32", compute_dtype="fp32")
    p32 = tree_map(lambda t: t.float(), params)
    model32 = type(model)(cfg32, device=model.device)
    ref = _no_cache_logits(model32, p32, tokens, cfg32)
    paged = _paged_logits(model32, p32, tokens)
    diff = (paged - ref).abs().max().item()
    scale = ref.abs().max().item()
    del p32
    torch.cuda.empty_cache()
    return diff, scale


def phase2(results, kernels):
    import numpy as np
    import torch

    from megatron_llm_torch.ops.kernels import paged_attention as pa
    from megatron_llm_torch.ops.kernels import rmsnorm as rn
    from megatron_llm_torch.run_text_generation_server import (
        build_parser, build_server)
    from megatron_llm_torch.tokenizer import NullTokenizer

    new_tokens = 64
    # Llama-2-7B at full width; max_model_len cut from 4096 to 2048 to
    # halve the KV pool (8 slots x 2048 tokens), default serve flags
    argv = ["--model_name", "llama2", "--bf16", "--seed", "1234",
            "--serve_max_model_len", "2048", "--host", "127.0.0.1",
            "--port", "0"]
    args = build_parser().parse_args(argv)
    t0 = time.perf_counter()
    server = build_server(args, NullTokenizer(32000))
    engine = server.engine
    log(f"  model + engine + warmup: {time.perf_counter() - t0:.1f} s; "
        f"{engine.model.num_params(engine.params) / 1e9:.2f} B params; "
        f"paged_kernel={engine.paged_kernel} "
        f"prefill_kernel={engine.prefill_kernel}")
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
        prompts = [rng.randint(0, 32000, size=n).tolist() for n in lens]
        # wave 2: a prompt sharing the first 992 tokens (62 full pages)
        # of prompt 5, whose pages are cached by then, and an exact
        # repeat of prompt 2 (400 tokens: its first 24 pages, 384 tokens,
        # are cached; the page holding the last prompt token never is)
        shared = prompts[5][:992] + rng.randint(0, 32000, 158).tolist()
        # cached tokens of each request, by prompt length, in order
        want_hits = {len(shared): [992], len(prompts[2]): [0, 384]}
        s0 = engine.stats()
        rn.launches = 0
        pa.decode_launches = 0
        pa.prefill_launches = 0
        t_wave = time.perf_counter()
        outs = _serve_wave(port, prompts, new_tokens)
        outs2 = _serve_wave(port, [shared, prompts[2]], new_tokens)
        wall = time.perf_counter() - t_wave
        # a request's record follows its answer: wait for the last ones
        deadline = time.monotonic() + 30
        while len(records) < 10 and time.monotonic() < deadline:
            time.sleep(0.01)
        check(len(records) == 10, f"{len(records)} request_done records")
        launches = {"rmsnorm": rn.launches, "decode": pa.decode_launches,
                    "prefill": pa.prefill_launches}
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
        check(launches["decode"] == L * dec,
              f"paged decode launches {launches['decode']} != {L} x {dec}")
        check(launches["prefill"] == L * pre,
              f"paged prefill launches {launches['prefill']} != {L} x {pre}")
        check(launches["rmsnorm"] == (2 * L + 1) * (dec + pre),
              f"rmsnorm launches {launches['rmsnorm']} != (2 x {L} + 1) x "
              f"{dec + pre}")
        kernels["rmsnorm"]["launches"] = launches["rmsnorm"]
        kernels["paged_decode"]["launches"] = launches["decode"]
        kernels["paged_prefill"]["launches"] = launches["prefill"]

        # independent check: no-cache forward through neither kernel
        diff, scale = _fp32_path_check(engine.model, engine.params,
                                       outs[5][:-1])
        log(f"  fp32 teacher-forced logits, paged (both kernels) vs "
            f"no-cache (neither), {len(outs[5]) - 1} tokens: max |diff| "
            f"{diff:.3g} (max |logit| {scale:.3g}, tolerance "
            f"{FP32_LOGIT_TOL})")
        check(diff <= FP32_LOGIT_TOL,
              f"fp32 paged vs no-cache logits differ by {diff}")
        results["fp32_paged_vs_no_cache_max_abs"] = diff
        for i in (2, 5):
            n_sure, n_agree, n, spread = _token_check(
                engine.model, engine.params, outs[i], len(prompts[i]))
            log(f"  bf16 no-cache check, prompt {len(prompts[i])}: "
                f"{n_agree}/{n_sure} served tokens agree where the top-2 "
                f"margin > {MARGIN_BOUND} ({n} positions); bf16 "
                f"teacher-forced logits, paged vs no-cache: "
                + ", ".join(f"{k} {v:.4g}" for k, v in spread.items()))
            results[f"bf16_paged_vs_no_cache_prompt{len(prompts[i])}"] = \
                dict(spread, checked=n_sure, agreed=n_agree, positions=n)
            check(n_sure >= MIN_CHECKED_FRACTION * n,
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
        f"copy equals its source and both requests kept their served "
        f"tokens")
    results["cow_copies_forced"] = cow


# ---------------------------------------------------------------------------

def main() -> int:
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
        f"{time.perf_counter() - t0:.1f} s -> {os.path.relpath(lib_path, REPO)}")
    with open(os.path.join(OUT_DIR, "chip_smoke_build.log"), "w") as f:
        f.write(build.build_log)

    kernels, results = {}, {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    log("phase 1: kernels vs plain versions")
    phase1(gen, kernels)
    log(f"phase 1 passed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log("phase 2: Llama-2-7B through the port's HTTP server")
    phase2(results, kernels)
    log(f"phase 2 passed in {time.perf_counter() - t0:.1f} s")
    log(f"serving ({card}): " + json.dumps(results))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = {"kernels": [{k: kernels[n][k] for k in keys}
                        for n in ("paged_decode", "paged_prefill",
                                  "rmsnorm")]}
    with open(os.path.join(OUT_DIR, "chip_smoke_result.json"), "w") as f:
        json.dump({"card": card, "kernels": kernels, "serving": results},
                  f, indent=1)
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
        sys.exit(1)
