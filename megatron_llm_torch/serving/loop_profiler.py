"""Engine-loop goodput profiler: per-dispatch host/device attribution.

Request tracing attributes *per-request* phases; this module attributes the serve
loop's own wall-clock.  Every dispatch of the engine's jitted programs
(prefill chunk / decode step / verify step) is accounted into host
phases —

* ``schedule``     admission + preemption + slot bookkeeping,
* ``draft``        prompt-lookup proposals (speculative only),
* ``build_inputs`` traced host-numpy array assembly + COW barriers,
* ``device``       dispatch -> block on the fetched outputs,
* ``emit``         token commits, stream writes, telemetry,

— so ``device_busy_pct`` / ``host_bubble_pct`` say where the loop's
time actually goes, which is the before/after baseline any
double-buffering of the host loop must beat (ROADMAP "Raw speed").

Everything here is host-side python: the profiler never touches a
traced value, so the zero-steady-state-recompile invariant holds with
it on (guarded by ``test_engine_zero_recompiles_after_warmup``).

Surfaces:

* bounded ring of per-dispatch records + cumulative per-phase seconds
  (``stats()`` — embedded in the engine block of ``/metrics``; the
  phase histograms ride the mergeable-Histogram shape, so the
  Prometheus exposition and the router's bucket-wise fleet merge get
  them for free),
* windowed rollups over the ring (recent ``device_busy_pct``),
* a periodic ``engine_loop_stats`` JSONL record (telemetry schema 10),
* SpanTracer ``loop.<phase>`` sub-spans on the Perfetto timeline,
* a dispatch-gap detector: a gap between consecutive busy dispatches
  beyond ``stall_threshold_secs`` is a loop stall — counted and
  written to the flight recorder (armed after warmup so compile gaps
  never count).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from megatron_llm_torch import telemetry, tracing

# Canonical phase order (also the order the sub-spans tile a dispatch).
LOOP_PHASES = ("schedule", "draft", "build_inputs", "device", "emit")

# Host phases run far below DEFAULT_LATENCY_BUCKETS' 1 ms floor, so the
# loop histograms get their own fixed bounds (fleet-mergeable: fixed
# across replicas like every other telemetry histogram).
LOOP_PHASE_BUCKETS = (
    0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
)


class DispatchRecord:
    """One dispatch's accounting, owned by the engine thread until
    ``LoopProfiler.finish``.  ``mark(phase)`` attributes everything
    since the previous mark to ``phase``, so the marks tile
    ``[start, finish]`` exactly and the phase times sum to the
    dispatch wall-clock by construction."""

    __slots__ = ("kind", "start", "gap_secs", "phases", "_last", "_clock")

    def __init__(self, clock, start: float, gap_secs: float):
        self.kind = "decode"
        self.start = start
        self.gap_secs = gap_secs
        self.phases: Dict[str, float] = {}
        self._last = start
        self._clock = clock

    def mark(self, phase: str) -> None:
        now = self._clock()
        self.phases[phase] = (self.phases.get(phase, 0.0)
                              + max(now - self._last, 0.0))
        self._last = now


class LoopProfiler:
    """Per-dispatch host/device accounting for the engine loop.

    ``clock`` is injectable (the GoodputAccounter pattern) so tests
    script exact phase durations.  All mutation happens on the engine
    loop thread; ``stats()`` is read from HTTP handler threads, so the
    cumulative counters and the ring live under ``_lock``.
    """

    # lint-enforced (graft-race TH001): the rollup counters are written
    # by the engine loop (finish) and read by /metrics handler threads
    # (stats), so every access goes through _lock.  _last_end and
    # stall_armed are engine-loop/warmup-thread only (single writer,
    # never read across roots).
    _lock_protected_ = {
        "dispatches": "_lock",
        "dispatches_by_kind": "_lock",
        "wall_secs": "_lock",
        "gap_secs": "_lock",
        "device_secs": "_lock",
        "phase_secs": "_lock",
        "stalls": "_lock",
        "_ring": "_lock",
        "_emitted_at_dispatches": "_lock",
        "_emitted_at_time": "_lock",
    }

    def __init__(self, ring_size: int = 512,
                 stall_threshold_secs: float = 0.5,
                 emit_every_dispatches: int = 256,
                 emit_interval_secs: float = 15.0,
                 clock=time.perf_counter):
        self._clock = clock
        self.stall_threshold_secs = float(stall_threshold_secs)
        self.emit_every_dispatches = int(emit_every_dispatches)
        self.emit_interval_secs = float(emit_interval_secs)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(int(ring_size), 1))
        self._hist = {p: telemetry.Histogram(LOOP_PHASE_BUCKETS)
                      for p in LOOP_PHASES}
        self.dispatches = 0
        self.dispatches_by_kind = {"prefill": 0, "decode": 0, "verify": 0}
        self.wall_secs = 0.0        # sum of dispatch wall-clocks
        self.gap_secs = 0.0         # between consecutive busy dispatches
        self.device_secs = 0.0
        self.phase_secs = {p: 0.0 for p in LOOP_PHASES}
        self.stalls = 0
        # armed by the engine after warmup(): compile-time gaps between
        # warmup dispatches are expected, not stalls
        self.stall_armed = False
        self._last_end: Optional[float] = None
        self._emitted_at_dispatches = 0
        self._emitted_at_time = self._clock()

    # -- per-dispatch protocol (engine loop thread only) ----------------

    def begin(self) -> DispatchRecord:
        """Open a dispatch record; the gap since the previous dispatch's
        finish is the loop's dead time (zero when ``idle()`` broke the
        chain — an empty engine is not a stall)."""
        now = self._clock()
        last = self._last_end
        gap = max(now - last, 0.0) if last is not None else 0.0
        return DispatchRecord(self._clock, now, gap)

    def idle(self) -> None:
        """The scheduler had no action: break the gap chain so the wait
        for new work never reads as a dispatch gap."""
        self._last_end = None

    def finish(self, d: DispatchRecord, final_phase: str = "emit") -> None:
        """Close the record: the tail since the last mark goes to
        ``final_phase``, rollups update, and the stall / sub-span /
        periodic-emission side effects fire.  Never raises — the engine
        loop must survive any telemetry trouble."""
        now = self._clock()
        d.phases[final_phase] = (d.phases.get(final_phase, 0.0)
                                 + max(now - d._last, 0.0))
        d._last = now
        wall = max(now - d.start, 0.0)
        device = d.phases.get("device", 0.0)
        stalled = (self.stall_armed
                   and d.gap_secs > self.stall_threshold_secs)
        with self._lock:
            self.dispatches += 1
            n = self.dispatches
            self.dispatches_by_kind[d.kind] = (
                self.dispatches_by_kind.get(d.kind, 0) + 1)
            self.wall_secs += wall
            self.gap_secs += d.gap_secs
            self.device_secs += device
            for p, v in d.phases.items():
                self.phase_secs[p] = self.phase_secs.get(p, 0.0) + v
            if stalled:
                self.stalls += 1
            self._ring.append({
                "kind": d.kind,
                "wall_secs": wall,
                "gap_secs": d.gap_secs,
                "device_secs": device,
                "phases": dict(d.phases),
            })
        self._last_end = now
        for p, v in d.phases.items():
            h = self._hist.get(p)
            if h is not None:
                h.observe(v)
        if stalled:
            try:
                fr = telemetry.get_flight_recorder()
                if fr is not None:
                    fr.record({"kind": "loop_stall",
                               "time_unix": time.time(),
                               "gap_secs": round(d.gap_secs, 6),
                               "threshold_secs": self.stall_threshold_secs,
                               "dispatch": n,
                               "dispatch_kind": d.kind})
            except Exception:   # noqa: BLE001 - diagnostics never kill
                pass
        tracer = tracing.get_tracer()
        if tracer is not None:
            try:
                t = d.start
                for p in LOOP_PHASES:
                    v = d.phases.get(p, 0.0)
                    if v > 0.0:
                        tracer.completed(f"loop.{p}", "serve_loop",
                                         start=t, dur_secs=v, kind=d.kind)
                        t += v
            except Exception:   # noqa: BLE001
                pass
        self.maybe_emit(now=now)

    # -- rollups --------------------------------------------------------

    @staticmethod
    def _busy_pcts(device: float, wall: float, gap: float):
        """(device_busy_pct, host_bubble_pct) over a busy window of
        ``wall + gap`` seconds; (None, None) on an empty window."""
        busy = wall + gap
        if busy <= 0.0:
            return None, None
        dev = 100.0 * min(device / busy, 1.0)
        return round(dev, 3), round(100.0 - dev, 3)

    def ring_records(self) -> List[Dict[str, Any]]:
        """Copy of the per-dispatch ring — the raw material postmortem
        bundles freeze when an alert fires (serving/alerts.py)."""
        with self._lock:
            return list(self._ring)

    def stats(self) -> Dict[str, Any]:
        """JSON-able rollup for the engine's ``/metrics`` block.  The
        phase histograms carry the mergeable ``Histogram.snapshot()``
        shape, so the Prometheus exposition renders them as real
        histogram series and the router's fleet merge bucket-sums
        them."""
        with self._lock:
            ring: List[Dict[str, Any]] = list(self._ring)
            dispatches = self.dispatches
            by_kind = dict(self.dispatches_by_kind)
            wall = self.wall_secs
            gap = self.gap_secs
            device = self.device_secs
            phase_secs = dict(self.phase_secs)
            stalls = self.stalls
        dev_pct, bubble_pct = self._busy_pcts(device, wall, gap)
        w_wall = sum(r["wall_secs"] for r in ring)
        w_gap = sum(r["gap_secs"] for r in ring)
        w_dev = sum(r["device_secs"] for r in ring)
        w_dev_pct, w_bubble_pct = self._busy_pcts(w_dev, w_wall, w_gap)
        snaps = {p: h.snapshot() for p, h in self._hist.items()}
        p50 = {p: telemetry.histogram_percentile(s, 0.50)
               for p, s in snaps.items()}
        p95 = {p: telemetry.histogram_percentile(s, 0.95)
               for p, s in snaps.items()}
        return {
            "dispatches": dispatches,
            "dispatches_by_kind": by_kind,
            "wall_secs": round(wall, 6),
            "gap_secs": round(gap, 6),
            "device_secs": round(device, 6),
            "host_secs": round(max(wall - device, 0.0), 6),
            "phase_secs": {p: round(v, 6) for p, v in phase_secs.items()},
            "device_busy_pct": dev_pct,
            "host_bubble_pct": bubble_pct,
            "stalls": stalls,
            "stall_threshold_secs": self.stall_threshold_secs,
            "window": {
                "dispatches": len(ring),
                "wall_secs": round(w_wall, 6),
                "device_busy_pct": w_dev_pct,
                "host_bubble_pct": w_bubble_pct,
            },
            "phase_p50_secs": p50,
            "phase_p95_secs": p95,
            "histograms": {f"loop_{p}_secs": s for p, s in snaps.items()},
        }

    def loop_stats_record(self) -> Dict[str, Any]:
        """The periodic ``engine_loop_stats`` JSONL record (schema 10):
        the ``stats()`` rollup minus the bulky histogram snapshots —
        scalar p50/p95 travel instead."""
        s = self.stats()
        s.pop("histograms", None)
        return {"kind": "serve", "event": "engine_loop_stats", **s}

    def maybe_emit(self, now: Optional[float] = None,
                   force: bool = False) -> bool:
        """Emit ``engine_loop_stats`` to the telemetry stream when due
        (every ``emit_every_dispatches`` dispatches or
        ``emit_interval_secs`` seconds with at least one new dispatch),
        or unconditionally with ``force``.  True when a record was
        written."""
        stream = telemetry.get_stream()
        if stream is None:
            return False
        if now is None:
            now = self._clock()
        with self._lock:
            fresh = self.dispatches - self._emitted_at_dispatches
            due = force or fresh >= self.emit_every_dispatches or (
                fresh > 0
                and now - self._emitted_at_time >= self.emit_interval_secs)
            if not due:
                return False
            self._emitted_at_dispatches = self.dispatches
            self._emitted_at_time = now
        try:
            stream.emit(self.loop_stats_record())
        except Exception:       # noqa: BLE001 - engine loop must survive
            return False
        return True
