"""Continuous-batching inference engine over a paged KV pool, in eager
PyTorch (the counterpart of ``megatron_llm_tpu/serving/engine.py``).

One background thread moves requests through prefill -> decode ->
completion with these device programs, run eagerly on the model's device:

* ``decode`` — ``[num_slots]`` rows, one token each; empty slots ride
  along masked (their KV writes land in the garbage block);
* ``verify`` — with ``speculative`` on, the decode program's stand-in:
  ``[num_slots, draft_k + 1]`` rows per step, row s carrying the slot's
  last token and the prompt-lookup drafts of ``serving/drafter.py``
  (``vlens[s] = 1 + drafts``, 0 for an inactive slot).  It rides the
  paged prefill path (scatter the valid prefix, send padded rows to the
  garbage block, read through the prefill entry of the paged kernel);
  row 0 is sampled as the decode program samples, rows 1.. are argmax,
  and the host commits the longest matching prefix plus the bonus token,
  moving the context cursor back over rejected drafts;
* ``prefill`` — ``[1, prefill_chunk]`` prompt tokens of one request; the
  scheduler alternates chunks with decode steps;
* ``sample_first`` — the first token from the last prefill chunk;
* ``cow_copy`` — the copy-on-write page copy of the prefix cache;
* ``fetch_block`` / ``host_load`` — with ``host_cache_bytes`` > 0, the
  host KV tier's (``serving/host_cache.py``) device-to-host copy of one
  page across every layer (the spill thread's, a synchronous copy)
  and the host-to-device copy of a stored page back into the pool before
  a slot's first prefill chunk (the swap-in).

On a CUDA device the paged attention of decode, verify and prefill is
the ragged kernel (``csrc/paged_attention.cu``, over plain pools or,
with ``int8_kv_cache``, over int8 pools quantised on write) and every
norm is its norm kernel (``csrc/layernorm.cu``);
``stats()['paged_kernel']`` and
``['prefill_kernel']`` report the resolved path, ``cuda`` or ``torch``.

Per-slot mutable state (last tokens, context lengths, sampling knobs)
lives in host numpy arrays and is uploaded whole for each call; per
request, a ``torch.Generator`` seeded from ``SamplingParams.seed`` draws
the sampled tokens, once per decode or verify step.  Pool-pressure
preemption, the prefix cache, the non-finite sentinel, the loop
profiler and the cache observatory work as in the JAX engine, and so do
the resilience pieces (``serving/resilience.py``): the fault injector
(``fault_spec``), the watchdog (``watchdog_secs``) and the in-process
``restart``, which swaps in a fresh state object (a new pool) and
abandons the old one to the wedged thread; that thread writes only
through the state it holds, and every request-visible effect checks
``st is self._st``.  No CUDA graph is captured yet.
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
from megatron_llm_torch.serving.drafter import draft_budget, lookup_draft
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
from megatron_llm_torch.serving.resilience import (
    EngineWatchdog,
    ServingFaultInjector,
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
    # speculative decoding (--serve_speculative / --serve_draft_k): the
    # [S, K+1] verify program in place of the decode program; greedy
    # slots draft up to K tokens by prompt lookup, sampled slots draft
    # none and decode inside the same program
    speculative: bool = False
    draft_k: int = 4
    # resilience (serving/resilience.py)
    watchdog_secs: float = 0.0      # 0 = no engine watchdog
    preemption: bool = True         # pool-pressure preemption
    fault_spec: str = ""            # chaos injection, e.g. "nan@12,hang@30"
    restart_backoff_secs: float = 0.5   # restart-storm backoff base
    cache_ghost_multiples: Tuple[int, ...] = (2, 4, 10)
    # host KV tier (serving/host_cache.py): host-RAM budget for pages
    # falling off the pool's LRU; 0 = off (no spill thread)
    host_cache_bytes: int = 0


@dataclass
class _EngineState:
    """Everything a restart replaces.  The wedged thread keeps its
    reference to the OLD state object, so whatever it writes when (if)
    it wakes up lands in the abandoned pool; request-visible effects are
    gated on ``st is self._st`` after every dispatch."""

    gen: int
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

    # the state-object swap is the restart path's linearization point:
    # only restart() (under _restart_lock) publishes a new _EngineState,
    # and the thread/watchdog lifecycle fields share that lock so stop()
    # cannot race a watchdog-driven restart into respawning a loop
    # thread after shutdown
    _lock_protected_ = {
        "_st": "_restart_lock",
        "_running": "_restart_lock",
        "_thread": "_restart_lock",
        "_watchdog": "_restart_lock",
        "finished": "_finished_lock",
    }

    def __init__(self, model, params, config: Optional[EngineConfig] = None):
        self.model = model
        self.params = params
        self.config = cfg = config or EngineConfig()
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

        # the paged-attention path of the decode, verify and prefill
        # programs, keyed on the device alone: the CUDA kernel on a CUDA
        # device, its plain version on the CPU
        self.paged_kernel = self.prefill_kernel = (
            "cuda" if self.device.type == "cuda" else "torch")
        if cfg.speculative and cfg.draft_k < 1:
            raise ValueError(f"speculative decoding needs draft_k >= 1, "
                             f"got {cfg.draft_k}")
        self.speculative = bool(cfg.speculative)
        self.draft_k = int(cfg.draft_k) if self.speculative else 0

        self.cache_observatory = CacheObservatory(
            self._num_blocks - 1, cfg.block_size,
            ghost_multiples=cfg.cache_ghost_multiples)
        # the host tier is built after the first state, so that a page's
        # bytes are read off the real pool tensors (dtype and int8 aware)
        self.host_cache = None
        self._spill_stream = None
        self._st = self._new_state(gen=0)
        if cfg.host_cache_bytes > 0 and cfg.prefix_cache:
            if self.device.type == "cuda":
                self._spill_stream = torch.cuda.Stream(self.device)
            from megatron_llm_torch.serving.host_cache import HostKVCache
            block_bytes = sum(v[0].numel() * v.element_size()
                              for p in self._st.pages for v in p.values())
            self.host_cache = HostKVCache(
                cfg.host_cache_bytes, block_bytes,
                fetch=self._spill_fetch)
            self.cache_observatory.attach_host(self.host_cache)
            self._st.blocks.attach_host_cache(self.host_cache)
            self.host_cache.start()

        # counters (read by stats()/the HTTP /metrics endpoint)
        self.decode_steps = 0
        self.prefill_chunks = 0
        self.tokens_generated = 0
        self.prefill_tokens_submitted = 0
        self.prefill_tokens_computed = 0
        self.prefill_tokens_cached = 0
        self.occupancy_sum = 0
        self.drafted_tokens = 0         # prompt-lookup proposals verified
        self.accepted_tokens = 0        # proposals committed by verify
        self.prefill_secs = 0.0
        self.decode_secs = 0.0
        self.finished: Dict[str, int] = {}
        self._finished_lock = threading.Lock()
        self.warmed_up = False
        self.engine_restarts = 0
        self.slots_evicted_nonfinite = 0
        self.fault_injector = ServingFaultInjector.from_spec(cfg.fault_spec)
        self.loop_profiler = LoopProfiler()
        self._dispatches = 0
        self._watchdog: Optional[EngineWatchdog] = None
        self._restart_lock = threading.Lock()
        self._restart_times: List[float] = []
        # called with every request_done record; exceptions never reach
        # the engine loop
        self.request_done_hook: Optional[Any] = None

        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._wake = threading.Event()
        self._submit_lock = threading.Lock()

    def _new_state(self, gen: int,
                   carry: Optional[_EngineState] = None) -> _EngineState:
        """Fresh restartable state: a new pool and new per-slot arrays.
        The scheduler's and the prefix cache's counters carry across a
        restart (the totals a fleet reads must not reset)."""
        cfg = self.config
        if carry is not None:
            # the fresh pool starts empty: ghost slots release their
            # blocks, digest residency survives the restart
            self.cache_observatory.on_pool_reset()
            if self.host_cache is not None:
                # queued spills reference the abandoned pool; resident
                # host entries and counters survive
                self.host_cache.on_pool_reset()
        blocks = BlockManager(self._num_blocks, cfg.block_size,
                              cfg.num_slots, self._max_blocks_per_slot,
                              prefix_cache=cfg.prefix_cache,
                              observatory=self.cache_observatory,
                              host_cache=self.host_cache)
        sched = Scheduler(self.queue, blocks, cfg.max_model_len,
                          draft_k=self.draft_k)
        if carry is not None:
            old = carry.scheduler
            sched.admitted = old.admitted
            sched.rejected_len = old.rejected_len
            sched.deadline_evictions = old.deadline_evictions
            sched.preemptions = old.preemptions
            sched.swap_in_blocks_reserved = old.swap_in_blocks_reserved
            ob = carry.blocks
            blocks.prefix_cache_hits = ob.prefix_cache_hits
            blocks.prefix_cache_misses = ob.prefix_cache_misses
            blocks.prefix_cache_evictions = ob.prefix_cache_evictions
            blocks.prefix_cache_hit_tokens = ob.prefix_cache_hit_tokens
            blocks.prefix_cache_host_hits = ob.prefix_cache_host_hits
            blocks.cow_copies = ob.cow_copies
        S = cfg.num_slots
        return _EngineState(
            gen=gen,
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

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def _layer_caches(pages, block_tables, context_lens, valid_lens):
        return [dict(p, block_tables=block_tables,
                     context_lens=context_lens, valid_lens=valid_lens)
                for p in pages]

    @staticmethod
    def _ban(logits: torch.Tensor, prev: torch.Tensor, ban_a: torch.Tensor,
             ban_b: torch.Tensor) -> torch.Tensor:
        # ban pair (prevent_newline_after_colon): token b is illegal
        # immediately after token a; logits [..., V], prev [...], the
        # pair [S] broadcast over any middle axis
        V = logits.shape[-1]
        extra = (None,) * (prev.dim() - 1)
        a = ban_a[(slice(None),) + extra]
        b = ban_b.clamp(0, V - 1)[(slice(None),) + extra]
        banned = (a >= 0) & (prev == a)
        hit = torch.arange(V, device=logits.device) == b[..., None]
        return logits.masked_fill(banned[..., None] & hit, NEG_INF)

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
    def _verify_impl(self, params, pages, tokens, context_lens,
                     block_tables, vlens, temps, top_ks, top_ps,
                     ban_a, ban_b, generators):
        """Speculative [S, K+1] verify step, the decode program when
        ``speculative`` is on.  Row s carries ``[last_token, draft_1..
        draft_L, pad]`` with ``vlens[s] = 1 + L`` (0 for inactive slots);
        the paged branch writes the valid prefix's KV at
        ``context_lens[s]..`` and sends padded and inactive rows to the
        garbage block, as for a prefill chunk.  Row 0 goes through
        ``sample_batched`` with one draw per sampled decoding slot, so a
        non-drafting slot sees the decode program's generator stream;
        rows >= 1 are argmax (only greedy slots draft).  Returns (tokens
        [S, K+1] int64, per-slot finite flags over the valid rows [S]
        bool) as numpy; one host sync for the sampled rows' selection,
        one for the result."""
        tok = self._dev(tokens)
        ctx = self._dev(context_lens)
        vl = self._dev(vlens)
        K1 = tok.shape[1]
        j = torch.arange(K1, device=self.device)
        caches = self._layer_caches(pages, self._dev(block_tables), ctx, vl)
        # padded and inactive rows take their slot's last valid position:
        # near max_position_embeddings, ctx + j would index past the
        # rotary and position tables (torch indexing does not clamp, as
        # JAX's gather does).  Valid rows keep ctx + j; the KV writes
        # take their own positions from ctx and vlens.
        last = (vl.long() - 1).clamp(min=0)[:, None]
        positions = ctx.long()[:, None] + torch.minimum(j[None, :], last)
        logits, _ = language_model_forward(
            params, tok, positions, None, self.model.cfg, kv_caches=caches)
        logits = logits.float()                              # [S, K+1, V]
        # the sentinel over the VALID rows only: padded rows attend the
        # garbage block and may legitimately misbehave
        row_valid = j[None, :] < vl.long()[:, None]
        finite = (torch.isfinite(logits).all(dim=-1)
                  | ~row_valid).all(dim=-1)
        # row j samples the token after tokens[:, j]: that input token is
        # the ban pair's "previous" one
        logits = self._ban(logits, tok, self._dev(ban_a), self._dev(ban_b))
        first = sample_batched(logits[:, 0, :], generators,
                               self._dev(top_ks), self._dev(top_ps),
                               self._dev(temps))
        emit = torch.argmax(logits, dim=-1)
        emit[:, 0] = first
        return emit.cpu().numpy(), finite.cpu().numpy()

    @torch.no_grad()
    def _prefill_impl(self, params, pages, tokens, start_pos, valid_len,
                      block_table):
        """One [1, C] chunk; returns the last valid row's logits [V]."""
        cfg = self.model.cfg
        C = tokens.shape[1]
        # the padded tail takes the last valid position, as the verify
        # step's padded rows do: a chunk that starts past a prefix hit
        # can run past the end of the rotary and position tables
        positions = (start_pos + torch.arange(C, device=self.device)
                     .clamp(max=valid_len - 1))[None]
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

    @torch.no_grad()
    def _fetch_block_impl(self, pages, src: int):
        # page src of every layer's pool arrays (k/v, or the int8 pages
        # and their scales) as one flat byte tensor in host memory,
        # finished before this returns: the spill thread re-checks the
        # page's mapping after it.  On the card the gather and the copy
        # run on a side stream that first waits for every write the
        # engine queued, into pinned memory; the spill thread waits on
        # that stream alone, so the engine's later launches do not queue
        # behind the copy.  The host tier keeps a pageable copy.
        arrays = [v[src].reshape(-1).view(torch.uint8)
                  for p in pages for v in p.values()]
        side = self._spill_stream
        if side is None:
            return torch.cat(arrays).cpu()
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            flat = torch.cat(arrays)
            pinned = torch.empty(flat.shape, dtype=torch.uint8,
                                 pin_memory=True)
            pinned.copy_(flat, non_blocking=True)
        side.synchronize()
        return torch.empty(flat.shape, dtype=torch.uint8).copy_(pinned)

    @staticmethod
    @torch.no_grad()
    def _host_load_impl(pages, host_block, dst: int):
        # a stored page (the _fetch_block_impl layout) back into physical
        # page dst, on the engine's stream: one host-to-device copy, then
        # one device copy per pool array (the swap-in)
        flat = host_block.to(next(iter(pages[0].values())).device)
        off = 0
        for p in pages:
            for v in p.values():
                page = v[dst].reshape(-1).view(torch.uint8)
                page.copy_(flat[off:off + page.numel()])
                off += page.numel()
        return pages

    def _spill_fetch(self, manager, block: int):
        """Host-tier spill-thread callback: the device-to-host copy of one
        page.  Runs on the spill thread with no lock held; the
        abandoned-manager guard keeps a post-restart queue drain from
        reading the fresh pool through a stale block id.  A registered
        page's content is frozen (copy-on-write and eviction both
        unregister first), and the caller re-checks the (block, epoch)
        mapping after this returns: the copy is synchronous, so it has
        finished by then."""
        st = self._st
        if st.blocks is not manager:
            return None
        return self._fetch_block_impl(st.pages, int(block))

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
        with self._restart_lock:
            if self._thread is not None:
                raise RuntimeError("engine already started")
            self._running = True
            if self.config.watchdog_secs > 0 and self._watchdog is None:
                self._watchdog = EngineWatchdog(
                    timeout_secs=self.config.watchdog_secs,
                    has_work=lambda: self._st.scheduler.has_work(),
                    on_fire=lambda: self.restart("watchdog")).start()
            self._thread = threading.Thread(target=self._loop,
                                            name="serving-engine",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        # lifecycle writes under _restart_lock: a concurrent watchdog
        # restart() either completes first (its thread is joined here)
        # or sees _running False and spawns nothing
        with self._restart_lock:
            self._running = False
            watchdog, self._watchdog = self._watchdog, None
            thread, self._thread = self._thread, None
            self._wake.set()
        # join OUTSIDE the lock: the watchdog's restart takes it
        if watchdog is not None:
            watchdog.stop()
        if thread is not None:
            thread.join(timeout)
        st = self._st
        for req in self.queue.drain():
            req._finish(FINISH_ABORTED)
        for req in list(st.scheduler.active.values()):
            req._finish(FINISH_ABORTED)
            st.scheduler.evict(req)
        # the spill thread stops before the final flushes, so the host
        # block of the last cache_stats is its final state
        if self.host_cache is not None:
            self.host_cache.close()
        self.loop_profiler.maybe_emit(force=True)
        self.cache_observatory.maybe_emit(force=True)
        stream = telemetry.get_stream()
        if stream is not None:
            stream.emit({"kind": "serve", "event": "engine_stop",
                         **self.stats()})

    def _loop(self) -> None:
        st = self._st
        while self._running and st is self._st:
            try:
                did_work = self.step(st)
            except Exception as e:  # noqa: BLE001 - engine must survive
                if st is self._st:
                    self._fail_all(st, f"{type(e).__name__}: {e}")
                did_work = False
            if st is not self._st:
                return              # restarted under our feet: stand down
            if did_work and self._watchdog is not None:
                self._watchdog.progress()
            if not did_work:
                self._wake.wait(timeout=0.05)
                self._wake.clear()

    def _fail_all(self, st: _EngineState, msg: str) -> None:
        st.active[:] = 0
        for req in list(st.scheduler.active.values()):
            req._finish(FINISH_ERROR, error=msg)
            st.scheduler.evict(req)
            self._count_finish(FINISH_ERROR)

    def restart(self, reason: str) -> None:
        """Restart the engine in-process: publish a fresh state (a new
        pool), requeue interrupted requests that never streamed a token
        at the queue head, fail mid-stream ones, and start a new engine
        thread.  The wedged thread keeps the abandoned state (and its
        pool, until it returns) and is gated out of every
        request-visible effect.  Callable from any thread (the watchdog
        calls it from its own)."""
        with self._restart_lock:
            old = self._st
            self.engine_restarts += 1
            requeue: List[Request] = []
            failed: List[Request] = []
            for req in list(old.scheduler.active.values()):
                if req.state == RequestState.DONE:
                    continue
                if req._events is not None and req.t_first_token is not None:
                    failed.append(req)      # streamed bytes already left
                else:
                    requeue.append(req)
            tracing.instant("engine_restart", "serve", reason=reason,
                            gen=old.gen, requeued=len(requeue),
                            failed=len(failed))
            stream = telemetry.get_stream()
            if stream is not None:
                stream.emit({"kind": "serve", "event": "engine_restart",
                             "reason": reason, "gen": old.gen,
                             "requeued": len(requeue),
                             "failed": len(failed)})
            # publish the fresh state FIRST: from here on the old thread
            # fails its `st is self._st` guards
            self._st = self._new_state(gen=old.gen + 1, carry=old)
            for req in failed:
                req._finish(FINISH_ERROR,
                            error=f"engine restarted mid-stream ({reason})")
                self._count_finish(FINISH_ERROR)
            # queue-head requeue in the original submit order
            for req in sorted(requeue, key=lambda r: r.t_submit,
                              reverse=True):
                req.reset_for_requeue()
                self.queue.put_front(req)
            # restart-storm backoff: repeated fires within a minute back
            # off exponentially
            now = time.monotonic()
            self._restart_times = [t for t in self._restart_times
                                   if now - t < 60.0] + [now]
            storms = len(self._restart_times) - 1
            if storms > 0 and self.config.restart_backoff_secs > 0:
                delay = min(self.config.restart_backoff_secs
                            * 2 ** (storms - 1), 30.0)
                print(f" [engine] restart storm ({storms + 1} in 60s): "
                      f"backing off {delay:.1f}s", flush=True)
                time.sleep(delay)
            if self._running:
                self._thread = threading.Thread(
                    target=self._loop, name="serving-engine", daemon=True)
                self._thread.start()
            if self._watchdog is not None:
                self._watchdog.progress()
            self._wake.set()

    def step(self, st: Optional[_EngineState] = None) -> bool:
        """One scheduling decision + device call.  Returns False when
        idle.  Public so tests can single-step the engine without the
        background thread."""
        st = st if st is not None else self._st
        sched = st.scheduler
        d = self.loop_profiler.begin()
        # fault injection stays disarmed through warmup: chaos specs
        # index steady-state dispatches
        inj = self.fault_injector if self.warmed_up else None
        for req in sched.sweep_deadlines():
            req._finish(FINISH_DEADLINE)
            self._retire(st, req)
        t_admit = time.perf_counter()
        admitted = []
        if inj is not None and inj.maybe_oom(self._dispatches + 1):
            pass        # injected pool exhaustion: the head retries
        else:
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
        if kind in ("prefill", "decode"):
            self._dispatches += 1
            if inj is not None:
                inj.before_dispatch(self._dispatches)
            d.mark("schedule")
            if st is not self._st:
                # restarted while this thread slept in the dispatch:
                # nothing of the abandoned state reaches a request
                self.loop_profiler.finish(d)
                return True
            if kind == "prefill":
                self._run_prefill_chunk(st, arg, d)
            else:
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

    def _swap_in(self, st: _EngineState, req: Request) -> None:
        """Replay the slot's host-tier hits: one host-to-device page copy
        per pending block, before the first prefill chunk touches the
        slot.  A missing host entry (only possible across an engine
        restart, which clears pins) truncates the cached prefix at the
        first gap: the tail recomputes through the normal prefill."""
        pending = st.blocks.take_pending_swap_ins(req.slot)
        if not pending:
            return
        t0 = time.perf_counter()
        host = self.host_cache
        loaded: List[Tuple[int, bytes]] = []
        valid_blocks: Optional[int] = None
        for i, (block_idx, block, digest) in enumerate(pending):
            data = host.take_for_swap_in(digest)
            if data is None:
                valid_blocks = block_idx
                host.unpin([dg for _, _, dg in pending[i + 1:]])
                break
            st.pages = self._host_load_impl(st.pages, data, int(block))
            loaded.append((block, digest))
        self._sync()
        secs = time.perf_counter() - t0
        if valid_blocks is not None:
            cached = valid_blocks * self.config.block_size
            lost = max(req.cached_prompt_tokens - cached, 0)
            req.prefill_pos = min(req.prefill_pos, cached)
            req.cached_prompt_tokens = cached
            self.prefill_tokens_cached -= lost
        st.blocks.complete_swap_ins(req.slot, loaded)
        req.swap_in_secs += secs
        req.host_hit_blocks = len(loaded)
        host.note_swap_in(len(loaded), secs)
        tracing.instant("host_swap_in", "serve", request=req.id,
                        trace=req.trace_id, blocks=len(loaded),
                        secs=round(secs, 6))

    def _run_prefill_chunk(self, st: _EngineState, req: Request,
                           d: DispatchRecord) -> None:
        d.kind = "prefill"
        if self.host_cache is not None:
            # pending host-tier swap-ins first (a no-op after the slot's
            # first chunk); accounted to the build_inputs bucket
            self._swap_in(st, req)
        C = self.config.prefill_chunk
        # the full context: prompt plus anything generated before a
        # preemption or a restart requeued this request
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
            else:
                self._sync()
        d.mark("device")
        if st is not self._st:
            self.loop_profiler.finish(d)
            return          # engine restarted mid-dispatch: stale state
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
        inj = self.fault_injector if self.warmed_up else None
        if inj is not None and inj.poison_nonfinite(self._dispatches):
            finite = False
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

    def _sampling_temps(self, st: _EngineState,
                        slots: List[int]) -> np.ndarray:
        # only decoding slots draw: masked rows decode greedily and
        # leave their generators untouched
        temps = np.zeros_like(st.temps)
        temps[slots] = st.temps[slots]
        return temps

    def _run_decode(self, st: _EngineState, slots: List[int],
                    d: DispatchRecord) -> None:
        if self.speculative:
            # one decode path: with speculation on every decode step is
            # the [S, K+1] verify program; draft-less and sampled slots
            # ride it with vlen 1
            self._run_verify(st, slots, d)
            return
        d.kind = "decode"
        bs = self.config.block_size
        for s in slots:
            self._writable(st, s, int(st.context_lens[s]) // bs)
        decoding = [r for r in (st.scheduler.active.get(s) for s in slots)
                    if r is not None and r.state == RequestState.DECODE]
        traces = sorted({r.trace_id for r in decoding if r.trace_id})
        temps = self._sampling_temps(st, slots)
        d.mark("build_inputs")
        t0 = time.perf_counter()
        with tracing.span("decode_step", "serve", batch=len(slots),
                          traces=traces):
            next_tokens, finite = self._decode_impl(
                self.params, st.pages, st.last_tokens, st.context_lens,
                st.blocks.tables.copy(), st.active, temps, st.top_ks,
                st.top_ps, st.ban_a, st.ban_b, st.generators)
        finite = finite.copy()
        d.mark("device")
        if st is not self._st:
            self.loop_profiler.finish(d)
            return          # engine restarted mid-dispatch: stale state
        inj = self.fault_injector if self.warmed_up else None
        if slots and inj is not None \
                and inj.poison_nonfinite(self._dispatches):
            # flip only the fetched host-side flag of the lowest busy
            # slot: the device state is untouched, so batch-mates are
            # unaffected
            finite[min(slots)] = False
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

    def _run_verify(self, st: _EngineState, slots: List[int],
                    disp: DispatchRecord) -> None:
        """Speculative decode step: draft on the host (prompt lookup per
        slot), verify every slot in one [S, K+1] forward, then commit
        1..K+1 tokens per slot, moving the context cursor back over
        rejected drafts (a slot's pages are append-only; the next step's
        scatter overwrites the stale tail)."""
        disp.kind = "verify"
        cfg = self.config
        K = self.draft_k
        bs = cfg.block_size
        S = cfg.num_slots
        decoding = [r for r in (st.scheduler.active.get(s) for s in slots)
                    if r is not None and r.state == RequestState.DECODE]
        # each greedy slot proposes from its own history, clamped so the
        # accepted drafts and the bonus token never overshoot
        # max_new_tokens; sampled slots draft none
        draft_tokens = np.zeros((S, K), np.int64)
        draft_lens = np.zeros(S, np.int32)
        for req in decoding:
            sp = req.sampling
            if not sp.greedy:
                continue
            dr = lookup_draft(req.tokens,
                              draft_budget(K, sp.max_new_tokens,
                                           len(req.out_tokens)))
            if dr:
                draft_lens[req.slot] = len(dr)
                draft_tokens[req.slot, :len(dr)] = dr
        disp.mark("draft")
        vlens = np.where(st.active > 0, 1 + draft_lens, 0).astype(np.int32)
        verify_tokens = np.zeros((S, K + 1), np.int64)
        verify_tokens[:, 0] = st.last_tokens
        verify_tokens[:, 1:] = draft_tokens
        for s in slots:
            ctx = int(st.context_lens[s])
            last = ctx + max(int(vlens[s]), 1) - 1
            for bi in range(ctx // bs, last // bs + 1):
                self._writable(st, s, bi)
        traces = sorted({r.trace_id for r in decoding if r.trace_id})
        temps = self._sampling_temps(st, slots)
        disp.mark("build_inputs")
        t0 = time.perf_counter()
        with tracing.span("decode_step", "serve", batch=len(slots),
                          traces=traces, drafted=int(draft_lens.sum())):
            emit, finite = self._verify_impl(
                self.params, st.pages, verify_tokens, st.context_lens,
                st.blocks.tables.copy(), vlens, temps, st.top_ks,
                st.top_ps, st.ban_a, st.ban_b, st.generators)
        finite = finite.copy()
        disp.mark("device")
        if st is not self._st:
            self.loop_profiler.finish(disp)
            return          # engine restarted mid-dispatch: stale state
        inj = self.fault_injector if self.warmed_up else None
        if slots and inj is not None \
                and inj.poison_nonfinite(self._dispatches):
            finite[min(slots)] = False
        step_secs = time.perf_counter() - t0
        self.decode_secs += step_secs
        self.decode_steps += 1
        self.occupancy_sum += len(slots)
        share = step_secs / max(len(decoding), 1)
        for req in decoding:
            req.decode_amortized_secs += share
        for s in slots:
            req = st.scheduler.active.get(s)
            if req is None or req.state != RequestState.DECODE:
                continue
            if not finite[s]:
                self._evict_nonfinite(st, req)
                continue
            L = int(draft_lens[s])
            g = emit[s]
            # accept rule: the longest prefix with draft_i equal to the
            # token the verified logits emit at position i (row i's
            # logits are exact whenever drafts 1..i all matched)
            a = 0
            while a < L and int(draft_tokens[s, a]) == int(g[a]):
                a += 1
            self.drafted_tokens += L
            req.spec_drafted += L
            sp = req.sampling
            committed = 0
            for i in range(a + 1):
                # the cursor moves BEFORE the emit: _retire (through a
                # stop or length finish) reads context_lens[s] as the
                # count of tokens with KV written
                st.context_lens[s] += 1
                tok = int(g[i])
                st.last_tokens[s] = tok
                req.decode_tokens += 1
                committed += 1
                if sp.top_p_decay > 0.0:
                    st.top_ps[s] = sp.top_p_at(len(req.out_tokens) + 1)
                self._emit_and_check(st, req, tok)
                if req.state == RequestState.DONE:
                    break       # stop token mid-chain: drop the rest
            # committed - 1 of the commits were drafts (the bonus token is
            # the engine's own); KV of rejected drafts beyond the cursor
            # is stale but unread (valid_lens gates every read)
            self.accepted_tokens += committed - 1
            req.spec_accepted += committed - 1
        self.loop_profiler.finish(disp)

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
        sampling and decode (the verify program when ``speculative`` is
        on), the copy-on-write copy and, with the host tier, its two page
        copies, before ``start()``: this builds the CUDA kernels and warms
        the matmul libraries, so the first real request pays neither."""
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
        if self.host_cache is not None:
            # the host tier's pair the same way: the garbage page to the
            # host and straight back
            garbage = self._fetch_block_impl(st.pages, 0)
            st.pages = self._host_load_impl(st.pages, garbage, 0)
        self._sync()
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
            "speculative": self.speculative,
            "draft_k": self.draft_k,
            "drafted_tokens": self.drafted_tokens,
            "accepted_tokens": self.accepted_tokens,
            "engine_restarts": self.engine_restarts,
            "slots_evicted_nonfinite": self.slots_evicted_nonfinite,
            "loop": self.loop_profiler.stats(),
            "cache": self.cache_observatory.stats(),
        })
        return s
