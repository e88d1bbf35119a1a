"""Serving-side resilience: deterministic fault injection and the engine
watchdog.

The training stack got its resilience layer first (resilience.py: NaN
sentinel + rewind, ``HangWatchdog``, ``FaultInjector``); this module is
the serving counterpart, built on the same principles:

* **Everything is host-side.**  The non-finite sentinel reads per-slot
  finite flags that ride the already-dispatched decode/prefill programs
  (engine.py adds a ``jnp.isfinite(...).all()`` output — same compiled
  program, fetched with the sampled tokens), the watchdog is a plain
  daemon thread, and fault injection flips host state.  Enabling all of
  it keeps the zero-steady-state-recompile invariant intact.
* **Faults are injected deterministically**, keyed on the engine's
  dispatch counter with a spec grammar shared with the training
  injector (``FaultInjector.from_spec``): each trigger fires exactly
  once, so a chaos run is reproducible.

Spec grammar (comma-separated, 1-based dispatch indices)::

    nan@N       flip the non-finite flag of the lowest busy slot at the
                first decode/prefill completion at-or-after dispatch N
    hang@N[:S]  sleep S seconds (default 30) inside the engine loop at
                dispatch N — trips the watchdog
    slow@N:MS   sleep MS milliseconds at dispatch N (latency spike that
                must NOT trip a sanely configured watchdog)
    oom@N       report pool exhaustion to admission at dispatch N (the
                queued head stays queued and retries next step)

Watchdog semantics differ from training's ``HangWatchdog`` on purpose:
a serving watchdog must be **re-armable** — after it fires and the
engine restarts in-process, it goes back to watching the new engine
thread instead of staying spent.
"""

from __future__ import annotations

import threading
import time
import traceback
from dataclasses import dataclass
from typing import Callable, Optional


@dataclass
class ServingFaultInjector:
    """Deterministic serving fault injection (off unless a spec is
    given).  Indices are 1-based over the engine's dispatch counter
    (each prefill chunk or decode step is one dispatch); every trigger
    fires once and then disarms, mirroring the training injector."""

    nan_at: Optional[int] = None
    hang_at: Optional[int] = None
    hang_secs: float = 30.0
    slow_at: Optional[int] = None
    slow_ms: float = 100.0
    oom_at: Optional[int] = None

    @classmethod
    def from_spec(cls, spec: str) -> Optional["ServingFaultInjector"]:
        """Parse ``--serve_fault_inject`` (e.g. ``nan@12,hang@30:5``).
        Returns None for an empty spec."""
        spec = (spec or "").strip()
        if not spec:
            return None
        inj = cls()
        for tok in spec.split(","):
            tok = tok.strip()
            if not tok:
                continue
            if tok.startswith("nan@"):
                inj.nan_at = int(tok[4:])
            elif tok.startswith("hang@"):
                body, _, secs = tok[5:].partition(":")
                inj.hang_at = int(body)
                if secs:
                    inj.hang_secs = float(secs)
            elif tok.startswith("slow@"):
                body, _, ms = tok[5:].partition(":")
                inj.slow_at = int(body)
                if ms:
                    inj.slow_ms = float(ms)
            elif tok.startswith("oom@"):
                inj.oom_at = int(tok[4:])
            else:
                raise ValueError(
                    f"bad fault spec token {tok!r} (grammar: nan@N, "
                    f"hang@N[:S], slow@N:MS, oom@N)")
        return inj

    # -- hooks called by the engine loop --------------------------------

    def before_dispatch(self, index: int) -> None:
        """Called right before dispatch ``index``; sleeps through an
        armed hang/slow window (the hang is what the watchdog sees as a
        wedged jitted call)."""
        if self.hang_at is not None and index >= self.hang_at:
            secs, self.hang_at = self.hang_secs, None
            self._mark("hang", index, secs=secs)
            time.sleep(secs)
        if self.slow_at is not None and index >= self.slow_at:
            ms, self.slow_at = self.slow_ms, None
            self._mark("slow", index, ms=ms)
            time.sleep(ms / 1000.0)

    def poison_nonfinite(self, index: int) -> bool:
        """True exactly once, at the first completion check at-or-after
        the armed index — the engine flips the fetched finite flag of
        one busy slot, simulating a NaN logit without touching device
        state (so batch-mates are trivially unaffected)."""
        if self.nan_at is not None and index >= self.nan_at:
            self.nan_at = None
            self._mark("nan", index)
            return True
        return False

    def maybe_oom(self, index: int) -> bool:
        """True exactly once at the armed index: admission treats the
        pool as exhausted for this step."""
        if self.oom_at is not None and index >= self.oom_at:
            self.oom_at = None
            self._mark("oom", index)
            return True
        return False

    @staticmethod
    def _mark(kind: str, index: int, **detail) -> None:
        try:
            from megatron_llm_torch import tracing

            tracing.instant(f"fault_{kind}", "chaos", dispatch=index,
                            **detail)
        except Exception:
            pass
        print(f" [chaos] injecting {kind} at dispatch {index} {detail}",
              flush=True)


class EngineWatchdog:
    """Detects a wedged engine: no dispatch progress within
    ``timeout_secs`` while ``has_work()`` says there is work to do.

    On fire it dumps thread stacks / device memory / the telemetry
    flight recorder (resilience.dump_stacks_and_memory) plus the trace
    buffer, then invokes ``on_fire`` — the engine's in-process
    ``restart()``.  Unlike the training ``HangWatchdog`` it then
    re-arms: the restarted engine gets the same protection."""

    # lint-enforced (graft-lint threads/TH001): the heartbeat is
    # written by the engine loop (progress()) and read/re-armed by the
    # watchdog's own daemon thread — a torn/stale read here is a
    # spurious restart of a healthy engine
    _lock_protected_ = {"_last_progress": "_lock"}

    def __init__(self, timeout_secs: float,
                 has_work: Callable[[], bool],
                 on_fire: Callable[[], None],
                 printer: Callable[[str], None] = print):
        assert timeout_secs > 0
        self.timeout_secs = float(timeout_secs)
        self.has_work = has_work
        self.on_fire = on_fire
        self.printer = printer
        self.fires = 0
        self._lock = threading.Lock()
        self._last_progress = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._poll = max(min(self.timeout_secs / 4.0, 1.0), 0.02)

    def start(self) -> "EngineWatchdog":
        assert self._thread is None, "watchdog already started"
        self.progress()
        self._thread = threading.Thread(target=self._run,
                                        name="engine-watchdog", daemon=True)
        self._thread.start()
        return self

    def progress(self) -> None:
        """Engine loop heartbeat: called after every completed dispatch
        (and on restart, to re-arm)."""
        now = time.monotonic()
        with self._lock:
            self._last_progress = now

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            try:
                if not self.has_work():
                    # idle engines make no progress by design
                    self.progress()
                    continue
            except Exception:
                continue
            with self._lock:
                last = self._last_progress
            stalled = time.monotonic() - last
            if stalled > self.timeout_secs:
                self._fire(stalled)
                self.progress()         # re-arm for the restarted engine

    def _fire(self, stalled: float) -> None:
        self.fires += 1
        self.printer(
            f" [engine-watchdog] no dispatch completed in {stalled:.1f}s "
            f"(timeout {self.timeout_secs:.1f}s) — dumping diagnostics "
            f"and restarting the engine in-process")
        try:
            from megatron_llm_torch import resilience, tracing

            tracing.instant("engine_watchdog_fire", "watchdog",
                            stalled_secs=float(stalled),
                            timeout_secs=self.timeout_secs)
            resilience.dump_stacks_and_memory(self.printer)
        except Exception:
            pass
        try:
            self.on_fire()
        except Exception:
            self.printer(" [engine-watchdog] restart callback failed:\n"
                         + traceback.format_exc())
