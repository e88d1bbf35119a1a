"""Continuous-batching inference engine over a paged KV pool, in eager
PyTorch (the counterpart of ``megatron_llm_tpu/serving/engine.py``).

One background thread moves requests through prefill -> decode ->
completion with four device programs, run eagerly on the model's device:

* ``decode`` — ``[num_slots]`` rows, one token each; empty slots ride
  along masked (their KV writes land in the garbage block);
* ``prefill`` — ``[1, prefill_chunk]`` prompt tokens of one request; the
  scheduler alternates chunks with decode steps;
* ``sample_first`` — the first token from the last prefill chunk;
* ``cow_copy`` — the copy-on-write page copy of the prefix cache.

On a CUDA device the paged attention of both decode and prefill is the
ragged kernel (``csrc/paged_attention.cu``, over plain pools or, with
``int8_kv_cache``, over int8 pools quantised on write) and every norm is
its norm kernel (``csrc/layernorm.cu``);
``stats()['paged_kernel']`` and
``['prefill_kernel']`` report the resolved path, ``cuda`` or ``torch``.

Per-slot mutable state (last tokens, context lengths, sampling knobs)
lives in host numpy arrays and is uploaded whole for each call; per
request, a ``torch.Generator`` seeded from ``SamplingParams.seed`` draws
the sampled tokens.  Pool-pressure preemption, the prefix cache, the
non-finite sentinel, the loop profiler and the cache observatory work as
in the JAX engine.  Speculative decoding, the host KV tier, the
watchdog and fault injection are later slices: asking for one raises
``NotImplementedError``.  No CUDA graph is captured yet.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from megatron_llm_torch import telemetry, tracing
from megatron_llm_torch.models.language_model import (
    language_model_forward,
    lm_head_weight,
)
from megatron_llm_torch.parallel.layers import parallel_lm_logits
from megatron_llm_torch.serving.cache_observatory import CacheObservatory
from megatron_llm_torch.serving.kv_blocks import (
    BlockManager,
    derive_num_blocks,
)
from megatron_llm_torch.serving.loop_profiler import (
    DispatchRecord,
    LoopProfiler,
)
from megatron_llm_torch.serving.request import (
    FINISH_ABORTED,
    FINISH_DEADLINE,
    FINISH_ERROR,
    FINISH_LENGTH,
    FINISH_NONFINITE,
    FINISH_STOP,
    Request,
    RequestQueue,
    RequestState,
    SamplingParams,
)
from megatron_llm_torch.serving.scheduler import Scheduler
from megatron_llm_torch.text_generation.generation import init_paged_kv_caches
from megatron_llm_torch.text_generation.sampling import NEG_INF, sample_batched


@dataclass
class EngineConfig:
    num_slots: int = 8              # decode batch rows
    block_size: int = 16            # tokens per KV page
    num_blocks: int = 0             # 0 = full per-slot backing (no oversub)
    max_model_len: int = 0          # 0 = model max_position_embeddings
    prefill_chunk: int = 64         # prompt tokens per prefill call
    max_queue_depth: int = 64       # admission control (HTTP 429 beyond)
    default_deadline_secs: float = 120.0  # 0 = no deadline
    int8_kv_cache: bool = False     # int8 pages + per-position scales
    prefix_cache: bool = True       # share KV pages across equal prefixes
    speculative: bool = False       # later slice
    watchdog_secs: float = 0.0      # later slice (0 = off)
    preemption: bool = True         # pool-pressure preemption
    fault_spec: str = ""            # later slice
    cache_ghost_multiples: Tuple[int, ...] = (2, 4, 10)
    host_cache_bytes: int = 0       # later slice (0 = off)


def _check_ported(cfg: EngineConfig) -> None:
    asked = [name for name, on in (
        ("speculative", cfg.speculative),
        ("watchdog_secs", cfg.watchdog_secs > 0),
        ("fault_spec", bool(cfg.fault_spec)),
        ("host_cache_bytes", cfg.host_cache_bytes > 0),
    ) if on]
    if asked:
        raise NotImplementedError(
            f"not ported yet in the PyTorch engine: {', '.join(asked)}")


@dataclass
class _EngineState:
    """The pool and the per-slot host arrays (one generation: the port
    has no in-process restart yet)."""

    blocks: BlockManager
    scheduler: Scheduler
    pages: Any
    last_tokens: np.ndarray
    context_lens: np.ndarray
    active: np.ndarray
    temps: np.ndarray
    top_ks: np.ndarray
    top_ps: np.ndarray
    ban_a: np.ndarray
    ban_b: np.ndarray
    generators: List[Optional[torch.Generator]]


class InferenceEngine:
    """Continuous-batching engine over one model + param set.

    ``submit()`` is thread-safe and returns a :class:`Request` future;
    the background thread (``start()``) moves requests through
    prefill -> decode -> completion.  The engine speaks token ids."""

    def __init__(self, model, params, config: Optional[EngineConfig] = None):
        self.model = model
        self.params = params
        self.config = cfg = config or EngineConfig()
        _check_ported(cfg)
        mcfg = model.cfg
        self.device = model.device
        if cfg.max_model_len <= 0:
            cfg.max_model_len = int(mcfg.max_position_embeddings)
        cfg.max_model_len = min(cfg.max_model_len,
                                int(mcfg.max_position_embeddings))
        self._max_blocks_per_slot = -(-cfg.max_model_len // cfg.block_size)
        self._num_blocks = derive_num_blocks(
            cfg.num_slots, cfg.block_size, cfg.max_model_len,
            cfg.num_blocks or None)
        self.queue = RequestQueue(cfg.max_queue_depth)

        # the paged-attention path of the decode and prefill programs,
        # keyed on the device alone: the CUDA kernel on a CUDA device,
        # its plain version on the CPU
        self.paged_kernel = self.prefill_kernel = (
            "cuda" if self.device.type == "cuda" else "torch")

        self.cache_observatory = CacheObservatory(
            self._num_blocks - 1, cfg.block_size,
            ghost_multiples=cfg.cache_ghost_multiples)
        self._st = self._new_state()

        # counters (read by stats()/the HTTP /metrics endpoint)
        self.decode_steps = 0
        self.prefill_chunks = 0
        self.tokens_generated = 0
        self.prefill_tokens_submitted = 0
        self.prefill_tokens_computed = 0
        self.prefill_tokens_cached = 0
        self.occupancy_sum = 0
        self.prefill_secs = 0.0
        self.decode_secs = 0.0
        self.finished: Dict[str, int] = {}
        self._finished_lock = threading.Lock()
        self.warmed_up = False
        self.slots_evicted_nonfinite = 0
        self.loop_profiler = LoopProfiler()
        self._dispatches = 0
        # called with every request_done record; exceptions never reach
        # the engine loop
        self.request_done_hook: Optional[Any] = None

        self._lifecycle_lock = threading.Lock()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._wake = threading.Event()
        self._submit_lock = threading.Lock()

    def _new_state(self) -> _EngineState:
        cfg = self.config
        blocks = BlockManager(self._num_blocks, cfg.block_size,
                              cfg.num_slots, self._max_blocks_per_slot,
                              prefix_cache=cfg.prefix_cache,
                              observatory=self.cache_observatory)
        sched = Scheduler(self.queue, blocks, cfg.max_model_len, draft_k=0)
        S = cfg.num_slots
        return _EngineState(
            blocks=blocks,
            scheduler=sched,
            pages=init_paged_kv_caches(self.model.cfg, self._num_blocks,
                                       cfg.block_size, device=self.device,
                                       quantized=cfg.int8_kv_cache),
            last_tokens=np.zeros(S, np.int64),
            context_lens=np.zeros(S, np.int32),
            active=np.zeros(S, np.int32),
            temps=np.ones(S, np.float32),
            top_ks=np.zeros(S, np.int32),
            top_ps=np.zeros(S, np.float32),
            ban_a=np.full(S, -1, np.int64),
            ban_b=np.full(S, -1, np.int64),
            generators=[None] * S,
        )

    @property
    def blocks(self) -> BlockManager:
        return self._st.blocks

    @property
    def scheduler(self) -> Scheduler:
        return self._st.scheduler

    # ------------------------------------------------------------------
    # device programs
    # ------------------------------------------------------------------

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    @staticmethod
    def _layer_caches(pages, block_tables, context_lens, valid_lens):
        return [dict(p, block_tables=block_tables,
                     context_lens=context_lens, valid_lens=valid_lens)
                for p in pages]

    @staticmethod
    def _ban(logits: torch.Tensor, prev: torch.Tensor, ban_a: torch.Tensor,
             ban_b: torch.Tensor) -> torch.Tensor:
        # ban pair (prevent_newline_after_colon): token b is illegal
        # immediately after token a
        V = logits.shape[-1]
        banned = (ban_a >= 0) & (prev == ban_a)
        hit = (torch.arange(V, device=logits.device)[None, :]
               == ban_b.clamp(0, V - 1)[:, None])
        return logits.masked_fill(banned[:, None] & hit, NEG_INF)

    @torch.no_grad()
    def _decode_impl(self, params, pages, last_tokens, context_lens,
                     block_tables, active, temps, top_ks, top_ps,
                     ban_a, ban_b, generators):
        """One token for every slot.  Returns (next tokens [S] int64,
        per-slot finite flags [S] bool) as numpy."""
        last = self._dev(last_tokens)
        ctx = self._dev(context_lens)
        caches = self._layer_caches(pages, self._dev(block_tables), ctx,
                                    self._dev(active))
        logits, _ = language_model_forward(
            params, last[:, None], ctx.long()[:, None], None,
            self.model.cfg, kv_caches=caches)
        logits = logits[:, 0, :].float()                    # [S, V]
        # non-finite sentinel over the raw logits, before ban masking
        finite = torch.isfinite(logits).all(dim=-1)
        logits = self._ban(logits, last, self._dev(ban_a), self._dev(ban_b))
        nxt = sample_batched(logits, generators, self._dev(top_ks),
                             self._dev(top_ps), self._dev(temps))
        return nxt.cpu().numpy(), finite.cpu().numpy()

    @torch.no_grad()
    def _prefill_impl(self, params, pages, tokens, start_pos, valid_len,
                      block_table):
        """One [1, C] chunk; returns the last valid row's logits [V]."""
        cfg = self.model.cfg
        C = tokens.shape[1]
        positions = (start_pos + torch.arange(C, device=self.device))[None]
        caches = self._layer_caches(
            pages, self._dev(block_table),
            torch.full((1,), start_pos, dtype=torch.int32,
                       device=self.device),
            torch.full((1,), valid_len, dtype=torch.int32,
                       device=self.device))
        h, _ = language_model_forward(
            params, self._dev(tokens), positions, None, cfg,
            compute_logits=False, kv_caches=caches)
        last = parallel_lm_logits(h[0, valid_len - 1], lm_head_weight(params),
                                  compute_dtype=cfg.compute_torch_dtype)
        return last.float()

    @torch.no_grad()
    def _sample_first_impl(self, logits, generator, top_k, top_p, temp,
                           ban_a, ban_b, last_prompt_tok):
        finite = bool(torch.isfinite(logits).all())
        dev = logits.device
        logits = self._ban(
            logits[None, :],
            torch.tensor([last_prompt_tok], device=dev),
            torch.tensor([ban_a], device=dev),
            torch.tensor([ban_b], device=dev))
        tok = sample_batched(
            logits, [generator],
            torch.tensor([top_k], dtype=torch.int32, device=dev),
            torch.tensor([top_p], dtype=torch.float32, device=dev),
            torch.tensor([temp], dtype=torch.float32, device=dev))
        return int(tok[0]), finite

    @staticmethod
    @torch.no_grad()
    def _cow_copy_impl(pages, src: int, dst: int):
        # duplicate physical page src into dst in every layer's pool
        # arrays (k/v, or the int8 pages and their scales)
        for p in pages:
            for v in p.values():
                v[dst].copy_(v[src])
        return pages

    # ------------------------------------------------------------------
    # submission (any thread)
    # ------------------------------------------------------------------

    def submit(self, prompt_tokens: Sequence[int],
               sampling: Optional[SamplingParams] = None,
               stream: bool = False,
               deadline_secs: Optional[float] = None,
               trace_id: Optional[str] = None) -> Request:
        return self.submit_many([list(prompt_tokens)],
                                [sampling or SamplingParams()],
                                stream=stream,
                                deadline_secs=deadline_secs,
                                trace_id=trace_id)[0]

    def submit_many(self, prompts: Sequence[Sequence[int]],
                    samplings: Sequence[Optional[SamplingParams]],
                    stream: bool = False,
                    deadline_secs: Optional[float] = None,
                    trace_id: Optional[str] = None) -> List[Request]:
        """Atomic multi-request admission: validates and enqueues all, or
        raises (ValueError -> HTTP 400, QueueFull -> HTTP 429) enqueueing
        none."""
        if deadline_secs is None:
            deadline_secs = (self.config.default_deadline_secs or None)
        reqs = []
        for toks, sp in zip(prompts, samplings):
            r = Request(toks, sp or SamplingParams(), stream=stream,
                        deadline_secs=deadline_secs, trace_id=trace_id)
            r._pc_submit = time.perf_counter()
            self.scheduler.validate(r)
            reqs.append(r)
        with self._submit_lock:
            self.queue.put_many(reqs)
        self._wake.set()
        return reqs

    # ------------------------------------------------------------------
    # engine thread
    # ------------------------------------------------------------------

    def start(self) -> "InferenceEngine":
        with self._lifecycle_lock:
            if self._thread is not None:
                raise RuntimeError("engine already started")
            self._running = True
            self._thread = threading.Thread(target=self._loop,
                                            name="serving-engine",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        with self._lifecycle_lock:
            self._running = False
            thread, self._thread = self._thread, None
            self._wake.set()
        if thread is not None:
            thread.join(timeout)
        st = self._st
        for req in self.queue.drain():
            req._finish(FINISH_ABORTED)
        for req in list(st.scheduler.active.values()):
            req._finish(FINISH_ABORTED)
            st.scheduler.evict(req)
        self.loop_profiler.maybe_emit(force=True)
        self.cache_observatory.maybe_emit(force=True)
        stream = telemetry.get_stream()
        if stream is not None:
            stream.emit({"kind": "serve", "event": "engine_stop",
                         **self.stats()})

    def _loop(self) -> None:
        st = self._st
        while self._running:
            try:
                did_work = self.step(st)
            except Exception as e:  # noqa: BLE001 - engine must survive
                self._fail_all(st, f"{type(e).__name__}: {e}")
                did_work = False
            if not did_work:
                self._wake.wait(timeout=0.05)
                self._wake.clear()

    def _fail_all(self, st: _EngineState, msg: str) -> None:
        st.active[:] = 0
        for req in list(st.scheduler.active.values()):
            req._finish(FINISH_ERROR, error=msg)
            st.scheduler.evict(req)
            self._count_finish(FINISH_ERROR)

    def step(self, st: Optional[_EngineState] = None) -> bool:
        """One scheduling decision + device call.  Returns False when
        idle.  Public so tests can single-step the engine without the
        background thread."""
        st = st if st is not None else self._st
        sched = st.scheduler
        d = self.loop_profiler.begin()
        for req in sched.sweep_deadlines():
            req._finish(FINISH_DEADLINE)
            self._retire(st, req)
        t_admit = time.perf_counter()
        admitted = []
        for req in sched.admit():
            self._on_admit(st, req)
            admitted.append(req)
        if not admitted and self.config.preemption:
            admitted = self._try_preempt(st)
        if admitted:
            share = (time.perf_counter() - t_admit) / len(admitted)
            for req in admitted:
                req.admission_secs += share
        self.cache_observatory.maybe_emit()
        kind, arg = sched.next_action()
        if kind == "prefill":
            self._dispatches += 1
            d.mark("schedule")
            self._run_prefill_chunk(st, arg, d)
            return True
        if kind == "decode":
            self._dispatches += 1
            d.mark("schedule")
            self._run_decode(st, arg, d)
            return True
        self.loop_profiler.idle()
        return False

    # -- admission ------------------------------------------------------

    def _on_admit(self, st: _EngineState, req: Request) -> None:
        s = req.slot
        sp = req.sampling
        st.temps[s] = sp.temperature
        st.top_ks[s] = sp.top_k
        st.top_ps[s] = sp.top_p
        st.ban_a[s] = sp.ban_pair[0] if sp.ban_pair else -1
        st.ban_b[s] = sp.ban_pair[1] if sp.ban_pair else -1
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(sp.seed))
        st.generators[s] = gen
        st.active[s] = 0            # stays masked until prefill done
        st.context_lens[s] = 0
        self.prefill_tokens_submitted += len(req.prompt_tokens)
        self.prefill_tokens_cached += req.cached_prompt_tokens
        req._pc_admit = time.perf_counter()
        req.queue_wait_secs = req._pc_admit - req._pc_submit
        tracer = tracing.get_tracer()
        if tracer is not None:
            tracer.completed("queue_wait", "serve", req._pc_submit,
                             req.queue_wait_secs, request=req.id,
                             trace=req.trace_id)
        tracing.instant("admit", "serve", request=req.id, slot=s,
                        trace=req.trace_id,
                        prompt_tokens=len(req.prompt_tokens),
                        cached_prompt_tokens=req.cached_prompt_tokens)
        if req.cached_prompt_tokens > 0:
            tracing.instant("prefix_cache_hit", "serve", request=req.id,
                            trace=req.trace_id,
                            tokens=req.cached_prompt_tokens)

    # -- pool-pressure preemption ---------------------------------------

    def _try_preempt(self, st: _EngineState) -> List[Request]:
        """Admission stalled on blocks while a slot is free: evict a
        strictly-larger running request back to the queue and retry."""
        head = self.queue.peek()
        if head is None or head.past_deadline():
            return []
        bstats = st.blocks.stats()
        if bstats["slots_in_use"] >= bstats["slots_total"]:
            return []       # slot-bound, not block-bound: just wait
        victim = st.scheduler.select_victim(head)
        if victim is None:
            return []
        # pop the head first and re-front it after the victim, so the
        # queue reads [head, victim, ...] and the freed capacity goes to
        # the smaller request
        popped = self.queue.pop()
        self._preempt(st, victim)
        if popped is not None:
            self.queue.put_front(popped)
        admitted = []
        for req in st.scheduler.admit():
            self._on_admit(st, req)
            admitted.append(req)
        return admitted

    def _preempt(self, st: _EngineState, victim: Request) -> None:
        s = victim.slot
        n_written = (int(st.context_lens[s]) if st.context_lens[s] > 0
                     else victim.prefill_pos)
        st.active[s] = 0
        st.context_lens[s] = 0
        tracing.instant("preempt", "serve", request=victim.id, slot=s,
                        trace=victim.trace_id,
                        generated=len(victim.out_tokens))
        stream = telemetry.get_stream()
        if stream is not None:
            stream.emit({"kind": "serve", "event": "preemption",
                         "request": victim.id, "trace_id": victim.trace_id,
                         "generated": len(victim.out_tokens),
                         "n_written": n_written})
        st.scheduler.preempt(victim, token_ids=victim.context_tokens(),
                             n_written=n_written)

    # -- prefill --------------------------------------------------------

    def _writable(self, st: _EngineState, slot: int, block_idx: int) -> None:
        """Copy-on-write barrier before a write into a slot's logical
        page: mirror a swapped-in private copy on the device."""
        res = st.blocks.ensure_writable(slot, block_idx)
        if res is not None:
            new_b, src_b = res
            st.pages = self._cow_copy_impl(st.pages, src_b, new_b)

    def _run_prefill_chunk(self, st: _EngineState, req: Request,
                           d: DispatchRecord) -> None:
        d.kind = "prefill"
        C = self.config.prefill_chunk
        # the full context: prompt plus anything generated before a
        # preemption requeued this request
        ptoks = req.context_tokens()
        start = req.prefill_pos
        chunk = ptoks[start:start + C]
        valid = len(chunk)
        toks = np.zeros((1, C), np.int64)
        toks[0, :valid] = chunk
        bs = self.config.block_size
        for bi in range(start // bs, (start + valid - 1) // bs + 1):
            self._writable(st, req.slot, bi)
        table = st.blocks.tables[req.slot:req.slot + 1].copy()
        d.mark("build_inputs")
        t0 = time.perf_counter()
        finite = True
        with tracing.span("prefill_chunk", "serve", request=req.id,
                          trace=req.trace_id, tokens=valid,
                          cached_tokens=req.cached_prompt_tokens):
            last_logits = self._prefill_impl(
                self.params, st.pages, toks, start, valid, table)
            done = start + valid >= len(ptoks)
            if done:
                s = req.slot
                tok, finite = self._sample_first_impl(
                    last_logits, st.generators[s], int(st.top_ks[s]),
                    float(st.top_ps[s]), float(st.temps[s]),
                    int(st.ban_a[s]), int(st.ban_b[s]), int(ptoks[-1]))
            elif self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        d.mark("device")
        chunk_secs = time.perf_counter() - t0
        self.prefill_secs += chunk_secs
        req.prefill_compute_secs += chunk_secs
        self.prefill_chunks += 1
        self.prefill_tokens_computed += valid
        req.prefill_pos = start + valid
        # freshly filled full blocks become shareable right away
        st.blocks.commit_prefix(req.slot, ptoks, req.prefill_pos)
        if not done:
            self.loop_profiler.finish(d)
            return
        if not finite:
            self._evict_nonfinite(st, req)
            self.loop_profiler.finish(d)
            return
        s = req.slot
        req.state = RequestState.DECODE
        st.context_lens[s] = len(ptoks)
        st.active[s] = 1
        st.last_tokens[s] = tok
        self._emit_and_check(st, req, tok)
        self.loop_profiler.finish(d)

    # -- decode ---------------------------------------------------------

    def _run_decode(self, st: _EngineState, slots: List[int],
                    d: DispatchRecord) -> None:
        d.kind = "decode"
        bs = self.config.block_size
        for s in slots:
            self._writable(st, s, int(st.context_lens[s]) // bs)
        decoding = [r for r in (st.scheduler.active.get(s) for s in slots)
                    if r is not None and r.state == RequestState.DECODE]
        traces = sorted({r.trace_id for r in decoding if r.trace_id})
        # only decoding slots draw: masked rows decode greedily and leave
        # their generators untouched
        temps = np.zeros_like(st.temps)
        temps[slots] = st.temps[slots]
        d.mark("build_inputs")
        t0 = time.perf_counter()
        with tracing.span("decode_step", "serve", batch=len(slots),
                          traces=traces):
            next_tokens, finite = self._decode_impl(
                self.params, st.pages, st.last_tokens, st.context_lens,
                st.blocks.tables.copy(), st.active, temps, st.top_ks,
                st.top_ps, st.ban_a, st.ban_b, st.generators)
        d.mark("device")
        step_secs = time.perf_counter() - t0
        self.decode_secs += step_secs
        self.decode_steps += 1
        self.occupancy_sum += len(slots)
        # amortized TPOT: each co-batched request pays an equal share
        share = step_secs / max(len(decoding), 1)
        for req in decoding:
            req.decode_amortized_secs += share
            req.decode_tokens += 1
        for s in slots:
            req = st.scheduler.active.get(s)
            if req is None or req.state != RequestState.DECODE:
                continue
            if not finite[s]:
                self._evict_nonfinite(st, req)
                continue
            # the step wrote last_tokens[s] into the cache at
            # context_lens[s] and sampled the next token
            st.context_lens[s] += 1
            tok = int(next_tokens[s])
            st.last_tokens[s] = tok
            sp = req.sampling
            if sp.top_p_decay > 0.0:
                st.top_ps[s] = sp.top_p_at(len(req.out_tokens) + 1)
            self._emit_and_check(st, req, tok)
        self.loop_profiler.finish(d)

    # -- completion -----------------------------------------------------

    def _evict_nonfinite(self, st: _EngineState, req: Request) -> None:
        """Non-finite logits for this slot: fail it and evict it without
        registering its pages in the prefix cache."""
        self.slots_evicted_nonfinite += 1
        tracing.instant("slot_evicted_nonfinite", "serve", request=req.id,
                        slot=req.slot, trace=req.trace_id)
        req._finish(FINISH_NONFINITE,
                    error="non-finite logits detected for this slot")
        self._retire(st, req)

    def _emit_and_check(self, st: _EngineState, req: Request,
                        tok: int) -> None:
        prev = (req.out_tokens[-1] if req.out_tokens
                else req.prompt_tokens[-1])
        req._emit_token(tok)
        self.tokens_generated += 1
        sp = req.sampling
        reason = None
        if tok == sp.eod_id or tok in sp.stop_token_ids:
            reason = FINISH_STOP
        elif (prev, tok) in sp.stop_pairs:
            reason = FINISH_STOP
        elif len(req.out_tokens) >= sp.max_new_tokens:
            reason = FINISH_LENGTH
        if reason is not None:
            req._finish(reason)
            self._retire(st, req)

    def _retire(self, st: _EngineState, req: Request) -> None:
        s = req.slot
        n_written = 0
        if s is not None:
            # tokens with KV on the device: context_lens once decoding,
            # else the prefill progress
            n_written = (int(st.context_lens[s])
                         if st.context_lens[s] > 0
                         else req.prefill_pos)
            st.active[s] = 0
            st.generators[s] = None
        if req.finish_reason == FINISH_NONFINITE:
            n_written = 0   # poisoned KV: register nothing for reuse
        st.scheduler.evict(req, token_ids=req.tokens, n_written=n_written)
        self._count_finish(req.finish_reason)
        tracer = tracing.get_tracer()
        pc0 = getattr(req, "_pc_submit", None)
        if tracer is not None and pc0 is not None:
            tracer.completed(
                "request", "serve", pc0, time.perf_counter() - pc0,
                request=req.id, trace=req.trace_id,
                prompt_tokens=len(req.prompt_tokens),
                new_tokens=len(req.out_tokens),
                finish_reason=req.finish_reason)
        bstats = st.blocks.stats()
        tpot = req.tpot_secs()
        record = {
            "kind": "serve", "event": "request_done",
            "request": req.id,
            "trace_id": req.trace_id,
            "prompt_tokens": len(req.prompt_tokens),
            "cached_prompt_tokens": req.cached_prompt_tokens,
            "prefill_computed_tokens":
                max(len(req.prompt_tokens) - req.cached_prompt_tokens, 0),
            "new_tokens": len(req.out_tokens),
            "decode_tokens": req.decode_tokens,
            "drafted_tokens": req.spec_drafted,
            "accepted_tokens": req.spec_accepted,
            "accept_rate": (round(req.accept_rate(), 4)
                            if req.accept_rate() is not None else None),
            "finish_reason": req.finish_reason,
            "ttft_secs": req.ttft_secs(),
            "latency_secs": req.latency_secs(),
            "tpot_secs": round(tpot, 6) if tpot is not None else None,
            "phases": req.phases(),
            "paged_kernel": self.paged_kernel,
            "prefill_kernel": self.prefill_kernel,
            "queue_depth": self.queue.depth(),
            "blocks_free": bstats["blocks_free"],
            "blocks_in_use": bstats["blocks_in_use"],
            "blocks_cached_reusable": bstats["blocks_cached_reusable"],
            "miss_cold_blocks": req.miss_cold_blocks,
            "miss_evicted_blocks": req.miss_evicted_blocks,
            "host_hit_blocks": req.host_hit_blocks,
            "swap_in_secs": round(req.swap_in_secs, 6),
        }
        stream = telemetry.get_stream()
        if stream is not None:
            stream.emit(record)
        hook = self.request_done_hook
        if hook is not None:
            try:
                hook(record)
            except Exception:   # noqa: BLE001 - metrics never stop serving
                pass

    def _count_finish(self, reason: Optional[str]) -> None:
        if reason:
            with self._finished_lock:
                self.finished[reason] = self.finished.get(reason, 0) + 1

    # ------------------------------------------------------------------
    # warmup / stats
    # ------------------------------------------------------------------

    def warmup(self) -> None:
        """Run one dummy greedy request through prefill, first-token
        sampling and decode, and the copy-on-write copy, before
        ``start()``: this builds the CUDA kernels and warms the matmul
        libraries, so the first real request pays neither."""
        if self._thread is not None:
            raise RuntimeError("warm up before start()")
        st = self._st
        prompt = [1] * min(self.config.prefill_chunk + 1,
                           max(self.config.max_model_len - 4, 1))
        req = Request(prompt, SamplingParams(max_new_tokens=3,
                                             temperature=0.0))
        req._pc_submit = time.perf_counter()
        self.queue.put(req)
        deadline = time.monotonic() + 300.0
        while req.state != RequestState.DONE:
            if not self.step(st):
                break
            if time.monotonic() > deadline:
                raise TimeoutError("engine warmup did not converge")
        # garbage -> garbage: a no-op page copy
        st.pages = self._cow_copy_impl(st.pages, 0, 0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.warmed_up = True
        self.loop_profiler.stall_armed = True
        tracing.instant("engine_warm", "serve")

    def estimate_wait_secs(self) -> float:
        """Rough queue wait for a rejected request (429 bodies)."""
        with self._finished_lock:
            done = sum(self.finished.values())
        if done <= 0:
            return 1.0
        per_req = (self.prefill_secs + self.decode_secs) / done
        return round(self.queue.depth() * per_req
                     / max(self.config.num_slots, 1), 3)

    def stats(self) -> Dict[str, Any]:
        s: Dict[str, Any] = dict(self.scheduler.stats())
        with self._finished_lock:
            finished = dict(self.finished)
        dec = max(self.decode_steps, 1)
        s.update({
            "decode_steps": self.decode_steps,
            "prefill_chunks": self.prefill_chunks,
            "tokens_generated": self.tokens_generated,
            "prefill_tokens_submitted": self.prefill_tokens_submitted,
            "prefill_tokens_computed": self.prefill_tokens_computed,
            "prefill_tokens_cached": self.prefill_tokens_cached,
            "mean_batch_occupancy": self.occupancy_sum / dec,
            "prefill_secs": round(self.prefill_secs, 6),
            "decode_secs": round(self.decode_secs, 6),
            "finished": finished,
            "warmed_up": self.warmed_up,
            "paged_kernel": self.paged_kernel,
            "prefill_kernel": self.prefill_kernel,
            # unported features report their off value, so stdlib tools
            # read a port replica unchanged
            "speculative": False,
            "draft_k": 0,
            "drafted_tokens": 0,
            "accepted_tokens": 0,
            "engine_restarts": 0,
            "slots_evicted_nonfinite": self.slots_evicted_nonfinite,
            "loop": self.loop_profiler.stats(),
            "cache": self.cache_observatory.stats(),
        })
        return s
