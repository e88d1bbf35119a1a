"""Span tracing, goodput accounting, and straggler/recompile diagnostics
(the counterpart of ``megatron_llm_tpu/tracing.py``).

Motivation (MegaScale, arXiv:2402.15627 §5; Megatron-LM scaling,
arXiv:2104.04473): telemetry (telemetry.py) tells you *how fast* the run
is; it does not tell you *where the wall-clock went*, *which host is
slow*, or *why step time spiked*.  This module is that attribution
layer — host-side only, nothing enters the jitted step:

* **SpanTracer** — a thread-safe, ring-buffered span recorder with a
  context-manager API (``with tracer.span("checkpoint_save",
  "checkpoint"): ...``) and Chrome ``trace_event`` JSON export, loadable
  in Perfetto (ui.perfetto.dev) or ``chrome://tracing``.  The training
  loop, checkpointing, resilience rewinds, eval, and data iteration all
  open spans; the whole run nests under one root ``train`` span so the
  trace covers (essentially) every second of wall-clock.

* **GoodputAccounter** — classifies wall-clock into
  productive-``step`` / ``compile`` / ``checkpoint`` / ``eval`` /
  ``rewind`` (restart-recovery) / ``data`` (input stall) / other, fed by
  span closes (outermost goodput-category span wins, so nesting never
  double-counts).  ``goodput_pct`` = productive step seconds over total
  wall seconds — MegaScale's headline reliability metric — and surfaces
  in the JSONL stream, ``run_summary()``, the wandb/TB finish summary,
  and ``bench.py``'s BENCH json.

* **RecompileDetector** — PyTorch runs eagerly and emits no compile
  event, so the detector runs the JAX module's step-time-outlier path
  (``use_monitoring=False``, ``observe_step_time``): a steady-state step
  beyond ``outlier_factor`` x the rolling median is a *suspected*
  recompile.  The port's one compile is the first-use build (or load)
  of the CUDA kernels' library (``ops/kernels/build.py``): it opens a
  ``kernel_build`` span in category ``compile`` and reports its seconds
  through ``note_compile``, so goodput attributes it to ``compile`` as
  the JAX package attributes an XLA compile.  Recompiles count in
  ``counters['recompiles']`` and emit trace events + flight-recorder
  entries.

* **StragglerDetector** — at log boundaries the train loop gathers
  per-host section times (the ``timers.py`` ``process_allgather`` path)
  and hands them here; any host exceeding ``threshold`` x the median is
  flagged as a structured straggler event (trace instant + flight
  recorder + ``counters['straggler_events']`` + a printed line).
  Single-host runs can never flag (median of one).

``tools/trace_report.py`` renders the goodput breakdown, top-N slowest
spans, and the recompile/straggler timelines from the exported trace
(plus the JSONL stream) — pure stdlib, runs anywhere the files do.

The port trains in one process: the process index is 0 and the
straggler detector, given one value per section, never flags.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass
from statistics import median
from typing import Any, Dict, List, Optional

from megatron_llm_torch.global_vars import get_counters

# wall-clock categories the goodput accounting attributes time to; spans
# in any other category (e.g. the root "run" span) are trace-only
GOODPUT_CATEGORIES = ("step", "compile", "checkpoint", "eval", "rewind",
                      "data")
_GOODPUT_SET = frozenset(GOODPUT_CATEGORIES)

TRACE_FILENAME = "trace.json"


# ---------------------------------------------------------------------------
# Goodput accounting
# ---------------------------------------------------------------------------

class GoodputAccounter:
    """Seconds of wall-clock per category + the goodput ratio.

    ``clock`` is injectable for tests; production uses ``perf_counter``
    so the wall denominator and the span durations share a clock."""

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self._secs: Dict[str, float] = {c: 0.0 for c in GOODPUT_CATEGORIES}
        self._lock = threading.Lock()
        # multi-slice: seconds the fleet spent waiting on each slice
        # (fed from the per-slice step-time lag at log boundaries) — the
        # slice dimension of goodput, aggregated offline by
        # tools/telemetry_report.py
        self._slice_stall: Dict[int, float] = {}

    def add_slice_stall(self, slice_id: int, secs: float) -> None:
        """Attribute fleet wait time to the slice that caused it (its
        step-time lag over the median of the others)."""
        with self._lock:
            self._slice_stall[int(slice_id)] = \
                self._slice_stall.get(int(slice_id), 0.0) \
                + max(float(secs), 0.0)

    def add(self, category: str, secs: float) -> None:
        with self._lock:
            self._secs[category] = self._secs.get(category, 0.0) \
                + max(float(secs), 0.0)

    def move(self, src: str, dst: str, secs: float) -> float:
        """Reattribute up to ``secs`` from ``src`` to ``dst`` (e.g. a
        compile observed inside a step span belongs to 'compile', not
        'step').  Clamped at what ``src`` holds; returns the moved
        amount."""
        with self._lock:
            m = min(max(float(secs), 0.0), self._secs.get(src, 0.0))
            self._secs[src] -= m
            self._secs[dst] = self._secs.get(dst, 0.0) + m
            return m

    def wall_secs(self) -> float:
        return max(self._clock() - self._t0, 1e-9)

    def summary(self) -> Dict[str, float]:
        """Per-category seconds, the unattributed remainder, and
        ``goodput_pct`` (productive-step share of total wall-clock)."""
        wall = self.wall_secs()
        with self._lock:
            secs = dict(self._secs)
        out = {f"{c}_secs": secs.get(c, 0.0) for c in GOODPUT_CATEGORIES}
        out["other_secs"] = max(wall - sum(secs.values()), 0.0)
        out["wall_secs"] = wall
        out["goodput_pct"] = 100.0 * secs.get("step", 0.0) / wall
        with self._lock:
            if self._slice_stall:
                out["slice_stall_secs"] = {
                    str(s): round(v, 6)
                    for s, v in sorted(self._slice_stall.items())}
        return out


# ---------------------------------------------------------------------------
# Span tracer
# ---------------------------------------------------------------------------

class _SpanHandle:
    """Yielded by ``span()`` so the body can attach attributes
    (``s.args["bytes"] = n``) that land in the trace event."""

    __slots__ = ("name", "category", "args")

    def __init__(self, name: str, category: str, args: Dict[str, Any]):
        self.name = name
        self.category = category
        self.args = args


class SpanTracer:
    """Thread-safe ring buffer of Chrome ``trace_event`` records.

    Durations ride ``perf_counter``; the epoch offset is stamped once so
    the export also carries absolute time.  The ring (``capacity``
    events) bounds memory on long runs — eviction drops the *oldest*
    events and counts them in ``dropped``, so a multi-day run keeps its
    freshest history like the flight recorder does."""

    def __init__(self, capacity: int = 100_000):
        self.capacity = max(int(capacity), 1)
        self.goodput = GoodputAccounter()
        self.dropped = 0
        self._events: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._t0 = time.perf_counter()
        self._unix0 = time.time()

    # -- recording ------------------------------------------------------

    def _stack(self) -> List[_SpanHandle]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _append(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(ev)

    @contextmanager
    def span(self, name: str, category: str = "other", **attrs):
        """Record one complete ('X') event around the body.  Goodput is
        fed by the *outermost* span whose category is a goodput
        category, so nested phases (a checkpoint_write inside a
        checkpoint_save inside an eval) never double-count."""
        stack = self._stack()
        enclosed = any(s.category in _GOODPUT_SET for s in stack)
        h = _SpanHandle(name, category, dict(attrs))
        stack.append(h)
        start = time.perf_counter()
        try:
            yield h
        finally:
            dur = time.perf_counter() - start
            stack.pop()
            counted = category in _GOODPUT_SET and not enclosed
            if counted:
                self.goodput.add(category, dur)
                h.args["goodput"] = category
            self._append({
                "ph": "X", "name": name, "cat": category,
                "ts": (start - self._t0) * 1e6, "dur": dur * 1e6,
                "tid": threading.get_ident(), "args": h.args,
            })

    def completed(self, name: str, category: str, start: float,
                  dur_secs: float, **attrs) -> None:
        """Record an already-finished interval (``start`` on the
        perf_counter clock) — how the recompile listener logs a compile
        it only hears about at its end."""
        self._append({
            "ph": "X", "name": name, "cat": category,
            "ts": (start - self._t0) * 1e6,
            "dur": max(dur_secs, 0.0) * 1e6,
            "tid": threading.get_ident(), "args": dict(attrs),
        })

    def instant(self, name: str, category: str = "other", **attrs) -> None:
        """A zero-duration marker ('i' event — Perfetto draws a flag)."""
        self._append({
            "ph": "i", "name": name, "cat": category, "s": "p",
            "ts": (time.perf_counter() - self._t0) * 1e6,
            "tid": threading.get_ident(), "args": dict(attrs),
        })

    def __len__(self) -> int:
        return len(self._events)

    def enclosed(self) -> bool:
        """Whether this thread is inside a goodput-category span (whose
        close will count the time)."""
        return any(s.category in _GOODPUT_SET for s in self._stack())

    # -- export ---------------------------------------------------------

    def chrome_trace(self, reason: str = "") -> Dict[str, Any]:
        """The Chrome ``trace_event`` JSON object (Perfetto-loadable)."""
        pid = 0
        with self._lock:
            events = list(self._events)
        # map raw thread idents to small tids + name metadata rows
        names = {t.ident: t.name for t in threading.enumerate()}
        tids: Dict[int, int] = {}
        out_events: List[Dict[str, Any]] = [{
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": f"host{pid}"},
        }]
        for ev in events:
            ident = ev["tid"]
            if ident not in tids:
                tids[ident] = len(tids)
                out_events.append({
                    "ph": "M", "name": "thread_name", "pid": pid,
                    "tid": tids[ident],
                    "args": {"name": names.get(ident, f"thread-{ident}")},
                })
            out_events.append({**ev, "pid": pid, "tid": tids[ident]})
        return {
            "displayTimeUnit": "ms",
            "otherData": {
                "reason": reason,
                "process_index": pid,
                "trace_start_unix": self._unix0,
                "dropped_events": self.dropped,
                "goodput": self.goodput.summary(),
                "recompiles": int(get_counters().get("recompiles", 0)),
                "straggler_events":
                    int(get_counters().get("straggler_events", 0)),
            },
            "traceEvents": out_events,
        }

    def write(self, path: str, reason: str = "") -> str:
        """Atomic (tmp + rename): the caller may be a watchdog thread
        racing ``os._exit``."""
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.chrome_trace(reason=reason), f)
        os.replace(tmp, path)
        return path


# ---------------------------------------------------------------------------
# Recompile detection
# ---------------------------------------------------------------------------

class RecompileDetector:
    """Counts and timestamps compiles; compiles after ``mark_steady()``
    are recompiles (MegaScale's "why did step time spike" class).
    ``pause()``/``resume()`` bracket phases where a fresh compile is
    *expected* so they never count as recompiles.

    PyTorch has no compile event to listen to, so ``use_monitoring`` is
    off by default and the detector flags steady-state step times beyond
    ``outlier_factor`` x the rolling median as *suspected* recompiles.
    ``on_compile`` hears the kernels' library build (``note_compile``)."""

    def __init__(self, tracer: Optional[SpanTracer] = None,
                 max_events: int = 256,
                 use_monitoring: Optional[bool] = None,
                 outlier_factor: float = 3.0,
                 outlier_window: int = 32):
        if use_monitoring is None:
            use_monitoring = False
        self.use_monitoring = bool(use_monitoring)
        self.tracer = tracer
        self.outlier_factor = float(outlier_factor)
        self.compiles = 0                   # every compile heard
        self.recompiles = 0                 # compiles while steady
        self.compile_secs_total = 0.0
        self.events: deque = deque(maxlen=max(int(max_events), 1))
        self._steady = False
        self._paused = 0
        self._pending_n = 0
        self._pending_secs = 0.0
        self._recent: deque = deque(maxlen=max(int(outlier_window), 4))
        self._lock = threading.Lock()

    # -- compile events -------------------------------------------------

    def on_compile(self, duration_secs: float, record: bool = True) -> None:
        """One finished compile of ``duration_secs``; ``record`` adds
        its trace event (``note_compile`` passes False: the build
        already opened its span)."""
        now = time.perf_counter()
        with self._lock:
            if self._paused:
                return
            self.compiles += 1
            self.compile_secs_total += duration_secs
            self._pending_n += 1
            self._pending_secs += duration_secs
            is_recompile = self._steady
            if is_recompile:
                self.recompiles += 1
                get_counters()["recompiles"] += 1
                self.events.append({
                    "kind": "recompile", "secs": float(duration_secs),
                    "time_unix": time.time(),
                })
        if self.tracer is not None and record:
            self.tracer.completed(
                "recompile" if is_recompile else "backend_compile",
                "compile", start=now - duration_secs,
                dur_secs=duration_secs)
        if is_recompile:
            print(f" [tracing] RECOMPILE detected: backend compile "
                  f"{duration_secs:.2f}s after steady state — a shape/"
                  f"layout change retraced the step", flush=True)
            try:
                from megatron_llm_torch import telemetry

                fr = telemetry.get_flight_recorder()
                if fr is not None:
                    fr.record({"kind": "recompile", "time_unix": time.time(),
                               "secs": float(duration_secs)})
            except Exception:
                pass

    # -- step-time outlier path -----------------------------------------

    def observe_step_time(self, secs: float) -> bool:
        """Outlier fallback: a steady-state step beyond
        ``outlier_factor`` x the rolling median is a *suspected*
        recompile.  No-op (False) when the exact listener is active."""
        if self.use_monitoring:
            return False
        with self._lock:
            baseline = list(self._recent)
            suspected = (self._steady and not self._paused
                         and len(baseline) >= 4
                         and secs > self.outlier_factor * median(baseline))
            if suspected:
                self.recompiles += 1
                get_counters()["recompiles"] += 1
                self.events.append({
                    "kind": "suspected_recompile", "secs": float(secs),
                    "time_unix": time.time(),
                })
            else:
                self._recent.append(float(secs))
        if suspected:
            if self.tracer is not None:
                self.tracer.instant("suspected_recompile", "compile",
                                    step_secs=float(secs))
            print(f" [tracing] suspected recompile: step took {secs:.2f}s "
                  f"vs rolling median {median(baseline):.2f}s", flush=True)
        return suspected

    # -- train-loop hooks ---------------------------------------------------

    def mark_steady(self) -> None:
        """The first step has compiled; compiles from here on are
        recompiles."""
        self._steady = True

    def pause(self) -> None:
        with self._lock:
            self._paused += 1

    def resume(self) -> None:
        with self._lock:
            self._paused = max(self._paused - 1, 0)

    def drain(self):
        """(count, seconds) of compiles since the last drain — the loop
        uses this to reattribute a step span's compile time to the
        'compile' goodput category."""
        with self._lock:
            n, secs = self._pending_n, self._pending_secs
            self._pending_n, self._pending_secs = 0, 0.0
        return n, secs


# the detector the kernels' build reports to (install_tracing sets it)
_ACTIVE_DETECTOR: Optional[RecompileDetector] = None


def install_detector(detector: Optional[RecompileDetector]) -> None:
    global _ACTIVE_DETECTOR
    _ACTIVE_DETECTOR = detector


def note_compile(duration_secs: float) -> None:
    """The kernels' library build took ``duration_secs`` (its
    ``kernel_build`` span has just closed).  Inside a goodput span (the
    first step) the span counted nothing, so the detector holds the
    seconds for the loop's ``drain`` to move from ``step`` to
    ``compile``; outside one the span itself counted them."""
    d, t = _ACTIVE_DETECTOR, _ACTIVE
    if d is None:
        return
    if t is not None and not t.tracer.enclosed():
        return
    d.on_compile(float(duration_secs), record=False)


# ---------------------------------------------------------------------------
# Straggler detection
# ---------------------------------------------------------------------------

class StragglerDetector:
    """Flags hosts whose per-section time exceeds ``threshold`` x the
    cross-host median (MegaScale §5.2's automated straggler hunt).  The
    caller supplies already-gathered per-host values (the ``timers.py``
    ``process_allgather`` path) at deterministic log boundaries — this
    class performs no collective itself."""

    def __init__(self, threshold: float = 1.5, min_secs: float = 0.005,
                 tracer: Optional[SpanTracer] = None,
                 max_events: int = 256,
                 printer=print,
                 host_slice_map: Optional[List[int]] = None):
        self.threshold = float(threshold)
        self.min_secs = float(min_secs)     # ignore sub-noise spreads
        self.tracer = tracer
        self.printer = printer
        self.events: deque = deque(maxlen=max(int(max_events), 1))
        self.total = 0
        # host index -> slice id (multislice.host_slice_map); when set,
        # every event names the slice the straggling host belongs to —
        # the MegaScale "which slice is the fleet waiting on" dimension
        self.host_slice_map = host_slice_map

    def check(self, per_host: Dict[str, List[float]],
              iteration: int) -> List[Dict[str, Any]]:
        """One boundary's straggler scan; returns (and records) the
        structured events.  ``per_host`` maps section name -> one value
        per host (e.g. ``timers.report()``'s gathered snapshot)."""
        found: List[Dict[str, Any]] = []
        for section in sorted(per_host):
            values = per_host[section]
            if len(values) < 2:
                continue                    # single host: no medians to lag
            med = median(values)
            if med <= 0:
                continue
            for host, v in enumerate(values):
                if v > self.threshold * med and (v - med) >= self.min_secs:
                    ev = {
                        "kind": "straggler", "iteration": int(iteration),
                        "section": section, "host": int(host),
                        "secs": float(v), "median_secs": float(med),
                        "ratio": float(v / med),
                        "time_unix": time.time(),
                    }
                    hsm = self.host_slice_map
                    if hsm is not None and host < len(hsm):
                        ev["slice"] = int(hsm[host])
                    found.append(ev)
        if found:
            self.total += len(found)
            get_counters()["straggler_events"] += len(found)
            for ev in found:
                self.events.append(ev)
                if self.tracer is not None:
                    keys = ("iteration", "section", "host",
                            "secs", "median_secs", "ratio")
                    if "slice" in ev:
                        keys = keys + ("slice",)
                    self.tracer.instant("straggler", "straggler",
                                        **{k: ev[k] for k in keys})
                who = (f"slice {ev['slice']} host {ev['host']}"
                       if "slice" in ev else f"host {ev['host']}")
                self.printer(
                    f" [tracing] STRAGGLER {who} at iteration "
                    f"{ev['iteration']}: {ev['section']} "
                    f"{ev['secs'] * 1000:.1f} ms = {ev['ratio']:.2f}x the "
                    f"median ({ev['median_secs'] * 1000:.1f} ms)")
            try:
                from megatron_llm_torch import telemetry

                fr = telemetry.get_flight_recorder()
                if fr is not None:
                    for ev in found:
                        fr.record(dict(ev))
            except Exception:
                pass
        return found


# ---------------------------------------------------------------------------
# Bundle + CLI wiring + module-level access
# ---------------------------------------------------------------------------

@dataclass
class Tracing:
    """Everything the observability layer needs, in one bundle."""

    tracer: SpanTracer
    recompile: Optional[RecompileDetector] = None
    straggler: Optional[StragglerDetector] = None
    trace_dir: Optional[str] = None

    def goodput_summary(self) -> Dict[str, float]:
        return self.tracer.goodput.summary()

    def trace_path(self) -> Optional[str]:
        if not self.trace_dir:
            return None
        return os.path.join(self.trace_dir, TRACE_FILENAME)

    def write_trace(self, reason: str = "") -> Optional[str]:
        path = self.trace_path()
        if path is None:
            return None
        os.makedirs(self.trace_dir, exist_ok=True)
        return self.tracer.write(path, reason=reason)

    def close(self) -> None:
        try:
            self.write_trace(reason="close")
        except Exception:
            pass
        if get_tracing() is self:
            install_tracing(None)


_ACTIVE: Optional[Tracing] = None


def install_tracing(tracing: Optional[Tracing]) -> None:
    """Register the run's Tracing so checkpointing/resilience/telemetry
    reach it without threading it through every call chain (same pattern
    as telemetry.install_stream)."""
    global _ACTIVE
    _ACTIVE = tracing
    install_detector(tracing.recompile if tracing is not None else None)


def get_tracing() -> Optional[Tracing]:
    return _ACTIVE


def get_tracer() -> Optional[SpanTracer]:
    return _ACTIVE.tracer if _ACTIVE is not None else None


@contextmanager
def span(name: str, category: str = "other", **attrs):
    """Module-level span that no-ops when no tracer is installed — how
    checkpointing / resilience / the train loop open spans without
    caring whether tracing is on."""
    t = _ACTIVE
    if t is None:
        yield None
        return
    with t.tracer.span(name, category, **attrs) as h:
        yield h


def instant(name: str, category: str = "other", **attrs) -> None:
    t = _ACTIVE
    if t is not None:
        t.tracer.instant(name, category, **attrs)


def goodput_summary() -> Optional[Dict[str, float]]:
    return _ACTIVE.goodput_summary() if _ACTIVE is not None else None


def dump_trace(reason: str = "") -> Optional[str]:
    """Write the active trace (crash/watchdog path — never raises)."""
    try:
        if _ACTIVE is None:
            return None
        return _ACTIVE.write_trace(reason=reason)
    except Exception:
        return None


def new_trace_id() -> str:
    """A fleet-unique request trace id (the ``X-Request-Trace`` value).
    16 hex chars: short enough to read in logs, unique enough for any
    realistic request volume.  The serving router mints one per inbound
    request; replicas mint their own only for direct (router-less)
    traffic."""
    return uuid.uuid4().hex[:16]


def start_trace_flusher(bundle: Tracing,
                        interval_secs: float = 5.0) -> threading.Thread:
    """Periodically write ``bundle``'s trace file from a daemon thread.

    Long-lived serving processes never reach the trainer's clean
    ``close()`` boundary — without a flusher the Chrome trace only
    exists after graceful shutdown, which is exactly when you don't
    need it.  The returned thread carries a ``stop`` Event; set it (and
    optionally join) to stop flushing."""
    stop = threading.Event()

    def loop():
        while not stop.wait(interval_secs):
            try:
                bundle.write_trace(reason="periodic")
            except Exception:
                pass

    t = threading.Thread(target=loop, name="trace-flusher", daemon=True)
    t.stop = stop           # type: ignore[attr-defined]
    t.start()
    return t


def build_tracing(args) -> Optional[Tracing]:
    """CLI wiring: a Tracing bundle from parsed args, or None when
    ``--trace_dir`` is unset."""
    trace_dir = getattr(args, "trace_dir", None)
    if not trace_dir:
        return None
    tracer = SpanTracer(
        capacity=getattr(args, "trace_buffer_size", 100_000) or 100_000)
    t = Tracing(
        tracer=tracer,
        recompile=RecompileDetector(tracer=tracer),
        straggler=StragglerDetector(
            threshold=getattr(args, "straggler_threshold", 1.5) or 1.5,
            tracer=tracer),
        trace_dir=trace_dir,
    )
    install_tracing(t)
    return t
