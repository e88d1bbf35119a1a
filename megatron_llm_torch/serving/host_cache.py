"""Host-RAM spill tier for the paged prefix cache.

The HBM pool (kv_blocks.py) holds one fixed set of KV pages; at fleet
scale its LRU evicts exactly the shared system prompts that make prefix
caching pay — the cache observatory's ``miss_evicted`` regret counter
and its 10x ghost tier measure how much.  This module is the tier that
projection justifies: a budget-bounded (``--serve_host_cache_bytes``)
LRU of page *copies* in host RAM, one level down the memory hierarchy.

Design:

* **Spill is asynchronous and off the dispatch hot path.**  When the
  BlockManager registers a page under its chain digest (commit) or
  parks it refcount-zero in the HBM LRU (free), it enqueues a spill;
  a background thread copies the page device→host (through the
  engine's fixed-shape jitted gather, compiled at warmup) and installs
  it here.  The engine loop never waits on a spill.
* **Correctness without holding locks across device reads.**  A
  registered page's content is frozen (full-block sharing means
  registered blocks are never rewritten; eviction unregisters before
  reuse), so the spill thread validates ``digest -> (block, epoch)``
  against the manager *before and after* the device fetch — the
  per-block epoch counter (bumped every time a physical block is
  handed to a new owner) closes the ABA window where the same digest
  could transiently re-map to a recycled block mid-read.  A lost race
  is counted (``spills_dropped``) and the copy discarded.
* **Admission is tier-agnostic.**  ``BlockManager._match_prefix_locked``
  extends its digest walk into this tier: digests that miss HBM but
  are resident here are *pinned* (so the host LRU cannot drop them
  mid-admission), counted as host-tier hits, and handed to the engine
  as pending swap-ins.  The engine replays them with one fixed-shape
  host→device scatter per block (also compiled at warmup) before the
  uncached-tail prefill, then the manager registers the pages back
  into the HBM cache — so only truly-cold tokens recompute and the
  zero-steady-state-recompile invariant holds.

Like the cache observatory, this object is engine-lifetime: restarts
swap BlockManager instances, the host tier and its counters survive
(``on_pool_reset`` clears pins and queued spills whose source pool is
gone).  Lock order is strictly ``BlockManager._lock ->
HostKVCache._lock``; the spill thread only takes the manager lock (via
``host_spill_check``) while holding neither.
"""

from __future__ import annotations

import queue
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


class _HostEntry:
    """One spilled page: the host-side per-layer arrays plus a pin
    count (admissions holding this digest for an in-flight swap-in;
    pinned entries are exempt from the host LRU)."""

    __slots__ = ("data", "pins")

    def __init__(self, data: Any):
        self.data = data
        self.pins = 0


class HostKVCache:
    """Budget-bounded host-RAM LRU of spilled KV pages, keyed by the
    same chained prefix digests as the HBM cache."""

    # lint-enforced (graft-lint locks/LD002 + graft-race TH001): the
    # spill thread installs entries while engine/HTTP threads match,
    # pin and consume them through the BlockManager's hooks — every
    # field mutates under _lock (the work queue itself is a
    # queue.Queue, thread-safe by contract; _queued is the dedup
    # shadow of its digests)
    _lock_protected_ = {
        "_entries": "_lock",
        "_queued": "_lock",
        "_closed": "_lock",
        "spills_queued": "_lock",
        "spills_completed": "_lock",
        "spills_dropped": "_lock",
        "evictions": "_lock",
        "swap_ins": "_lock",
        "swap_in_blocks": "_lock",
        "swap_in_secs_total": "_lock",
        "pool_resets": "_lock",
    }

    def __init__(self, capacity_bytes: int, block_bytes: int,
                 fetch: Callable[[Any, int], Optional[Any]],
                 max_queue: int = 256):
        assert block_bytes > 0
        self.capacity_bytes = int(capacity_bytes)
        self.block_bytes = int(block_bytes)
        self.capacity_blocks = max(self.capacity_bytes // self.block_bytes,
                                   0)
        # fetch(manager, block) -> host page pytree, or None when the
        # manager is no longer the live pool (engine restart).  Set
        # once at construction (the engine's device→host gather);
        # called by the spill thread with NO locks held.
        self._fetch = fetch
        self._lock = threading.Lock()
        self._entries: "OrderedDict[bytes, _HostEntry]" = OrderedDict()
        self._queued: set = set()
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(max_queue, 1))
        self._closed = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.spills_queued = 0
        self.spills_completed = 0
        self.spills_dropped = 0     # lost the eviction race / budget full
        self.evictions = 0          # host-LRU drops
        self.swap_ins = 0           # swap-in events (one per admission)
        self.swap_in_blocks = 0
        self.swap_in_secs_total = 0.0
        self.pool_resets = 0

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "HostKVCache":
        assert self._thread is None, "spill thread already started"
        self._thread = threading.Thread(target=self._spill_loop,
                                        name="kv-host-spill", daemon=True)
        self._thread.start()
        return self

    def close(self, timeout: float = 10.0) -> None:
        with self._lock:
            self._closed = True
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout)

    def on_pool_reset(self) -> None:
        """Engine restart: the HBM pool was rebuilt, so every queued
        spill's source page is gone (its manager is abandoned) and no
        live slot can still be waiting on a pinned entry.  Entries and
        counters survive — the tier outlives the pool."""
        with self._lock:
            self.pool_resets += 1
            for e in self._entries.values():
                e.pins = 0
            dropped = 0
            while True:
                try:
                    self._queue.get_nowait()
                    self._queue.task_done()
                    dropped += 1
                except queue.Empty:
                    break
            self._queued.clear()
            self.spills_dropped += dropped

    # -- spill (producer: BlockManager under its lock) ------------------

    def enqueue_spill(self, manager: Any, digest: bytes, block: int,
                      epoch: int) -> bool:
        """Queue a device→host copy of ``block`` (registered under
        ``digest`` with the given allocation epoch).  Deduped against
        resident entries and already-queued digests; a full queue
        drops the spill (counted) rather than stalling the caller —
        the BlockManager calls this inside its locked sections."""
        with self._lock:
            if (self._closed or self.capacity_blocks <= 0
                    or digest in self._queued
                    or digest in self._entries):
                return False
            self._queued.add(digest)
            self.spills_queued += 1
        try:
            self._queue.put_nowait((manager, digest, block, epoch))
        except queue.Full:
            with self._lock:
                self._queued.discard(digest)
                self.spills_dropped += 1
            return False
        return True

    def _spill_loop(self) -> None:
        while True:
            try:
                item = self._queue.get(timeout=0.2)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            try:
                self._process_spill(*item)
            finally:
                self._queue.task_done()
            if self._stop.is_set():
                return

    def _process_spill(self, manager: Any, digest: bytes, block: int,
                      epoch: int) -> None:
        """One queued spill: validate → device fetch → re-validate →
        install.  The double validation brackets the (lock-free) device
        read; the epoch comparison makes it exact — see module doc."""
        with self._lock:
            self._queued.discard(digest)
            if self._closed or digest in self._entries:
                return
        if manager.host_spill_check(digest) != (block, epoch):
            with self._lock:
                self.spills_dropped += 1
            return
        data = self._fetch(manager, block)
        if data is None or \
                manager.host_spill_check(digest) != (block, epoch):
            with self._lock:
                self.spills_dropped += 1
            return
        with self._lock:
            if self._closed or digest in self._entries:
                return
            while len(self._entries) >= self.capacity_blocks:
                victim = next((d for d, e in self._entries.items()
                               if e.pins == 0), None)
                if victim is None:      # everything pinned: drop spill
                    self.spills_dropped += 1
                    return
                del self._entries[victim]
                self.evictions += 1
            self._entries[digest] = _HostEntry(data)
            self.spills_completed += 1

    # -- admission / swap-in (BlockManager + engine) --------------------

    def match_and_pin(self, digests: Sequence[bytes]) -> List[bytes]:
        """Longest run of resident digests continuing an HBM match.
        Each matched entry is pinned (host-LRU-exempt) until the
        engine's swap-in consumes it via :meth:`take_for_swap_in` or
        the admission fails and :meth:`unpin` releases it.  Called by
        the BlockManager under its lock (lock order manager -> host)."""
        out: List[bytes] = []
        with self._lock:
            for d in digests:
                e = self._entries.get(d)
                if e is None:
                    break
                e.pins += 1
                self._entries.move_to_end(d)
                out.append(d)
        return out

    def unpin(self, digests: Sequence[bytes]) -> None:
        with self._lock:
            for d in digests:
                e = self._entries.get(d)
                if e is not None and e.pins > 0:
                    e.pins -= 1

    def take_for_swap_in(self, digest: bytes) -> Optional[Any]:
        """The engine is about to scatter this digest's page back to
        device: unpin and return the host data (the entry stays
        resident — the tier keeps its copy even once HBM has one
        again).  None only if the entry vanished, which pinning
        prevents short of an engine restart."""
        with self._lock:
            e = self._entries.get(digest)
            if e is None:
                return None
            if e.pins > 0:
                e.pins -= 1
            self._entries.move_to_end(digest)
            return e.data

    def note_swap_in(self, n_blocks: int, secs: float) -> None:
        with self._lock:
            self.swap_ins += 1
            self.swap_in_blocks += int(n_blocks)
            self.swap_in_secs_total += float(secs)

    # -- observability --------------------------------------------------

    def contains(self, digest: bytes) -> bool:
        with self._lock:
            return digest in self._entries

    def drain(self, timeout: float = 30.0) -> bool:
        """Test helper: block until every queued spill has been
        processed (installed or dropped).  Returns False on timeout."""
        import time
        deadline = time.monotonic() + timeout
        while self._queue.unfinished_tasks > 0:
            if time.monotonic() > deadline:
                return False
            time.sleep(0.005)
        return True

    def stats(self) -> Dict[str, Any]:
        """The ``host`` sub-block of the engine's ``cache`` stats:
        scalar leaves fleet-sum through the router's _sum_numeric like
        every other serving counter."""
        with self._lock:
            return {
                "enabled": 1,
                "capacity_blocks": self.capacity_blocks,
                "block_bytes": self.block_bytes,
                "entries": len(self._entries),
                "bytes_used": len(self._entries) * self.block_bytes,
                "pinned": sum(1 for e in self._entries.values()
                              if e.pins > 0),
                "spills_queued": self.spills_queued,
                "spills_completed": self.spills_completed,
                "spills_dropped": self.spills_dropped,
                "evictions": self.evictions,
                "swap_ins": self.swap_ins,
                "swap_in_blocks": self.swap_in_blocks,
                "swap_in_secs": round(self.swap_in_secs_total, 6),
                "pool_resets": self.pool_resets,
            }

    def check_invariants(self) -> None:
        with self._lock:
            assert len(self._entries) <= max(self.capacity_blocks, 0), \
                "host tier over budget"
            for d, e in self._entries.items():
                assert e.pins >= 0, f"negative pin count for {d.hex()}"
                assert e.data is not None
            # accounting: every completed or dropped spill was queued
            # first (deduped enqueues never increment spills_queued)
            assert (self.spills_completed + self.spills_dropped
                    <= self.spills_queued), "spill accounting underflow"
