"""Span tracing for the serving engine: a ring-buffered recorder of
Chrome ``trace_event`` records, loadable in Perfetto.

The subset of ``megatron_llm_tpu/tracing.py`` that the engine and
``serving/loop_profiler.py`` call (``span``, ``instant``,
``get_tracer``, ``new_trace_id``).  The recompile detector is left out:
the port runs eagerly and compiles nothing at serve time.  Goodput
accounting and straggler detection belong to the training slice.
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
from typing import Any, Dict, List, Optional

TRACE_FILENAME = "trace.json"


class SpanTracer:
    """Thread-safe ring buffer of Chrome ``trace_event`` records; the
    oldest events drop first and are counted in ``dropped``."""

    def __init__(self, capacity: int = 100_000):
        self.capacity = max(int(capacity), 1)
        self.dropped = 0
        self._events: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._unix0 = time.time()

    def _append(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(ev)

    @contextmanager
    def span(self, name: str, category: str = "other", **attrs):
        """Record one complete ('X') event around the body."""
        args = dict(attrs)
        start = time.perf_counter()
        try:
            yield args
        finally:
            self.completed(name, category, start,
                           time.perf_counter() - start, **args)

    def completed(self, name: str, category: str, start: float,
                  dur_secs: float, **attrs) -> None:
        """Record an already-finished interval (``start`` on the
        perf_counter clock)."""
        self._append({
            "ph": "X", "name": name, "cat": category,
            "ts": (start - self._t0) * 1e6,
            "dur": max(dur_secs, 0.0) * 1e6,
            "tid": threading.get_ident(), "args": dict(attrs),
        })

    def instant(self, name: str, category: str = "other", **attrs) -> None:
        """A zero-duration marker ('i' event)."""
        self._append({
            "ph": "i", "name": name, "cat": category, "s": "p",
            "ts": (time.perf_counter() - self._t0) * 1e6,
            "tid": threading.get_ident(), "args": dict(attrs),
        })

    def __len__(self) -> int:
        return len(self._events)

    def chrome_trace(self, reason: str = "") -> Dict[str, Any]:
        with self._lock:
            events = list(self._events)
        names = {t.ident: t.name for t in threading.enumerate()}
        tids: Dict[int, int] = {}
        out: List[Dict[str, Any]] = [{
            "ph": "M", "name": "process_name", "pid": 0, "tid": 0,
            "args": {"name": "host0"}}]
        for ev in events:
            ident = ev["tid"]
            if ident not in tids:
                tids[ident] = len(tids)
                out.append({
                    "ph": "M", "name": "thread_name", "pid": 0,
                    "tid": tids[ident],
                    "args": {"name": names.get(ident, f"thread-{ident}")}})
            out.append({**ev, "pid": 0, "tid": tids[ident]})
        return {"displayTimeUnit": "ms",
                "otherData": {"reason": reason,
                              "trace_start_unix": self._unix0,
                              "dropped_events": self.dropped},
                "traceEvents": out}

    def write(self, path: str, reason: str = "") -> str:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.chrome_trace(reason=reason), f)
        os.replace(tmp, path)
        return path


@dataclass
class Tracing:
    """The installed tracer and where its trace file goes."""

    tracer: SpanTracer
    trace_dir: Optional[str] = None

    def write_trace(self, reason: str = "") -> Optional[str]:
        if not self.trace_dir:
            return None
        os.makedirs(self.trace_dir, exist_ok=True)
        return self.tracer.write(os.path.join(self.trace_dir,
                                              TRACE_FILENAME), reason=reason)


_ACTIVE: Optional[Tracing] = None


def install_tracing(tracing: Optional[Tracing]) -> None:
    global _ACTIVE
    _ACTIVE = tracing


def get_tracing() -> Optional[Tracing]:
    return _ACTIVE


def get_tracer() -> Optional[SpanTracer]:
    return _ACTIVE.tracer if _ACTIVE is not None else None


@contextmanager
def span(name: str, category: str = "other", **attrs):
    """Module-level span that no-ops when no tracer is installed."""
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


def new_trace_id() -> str:
    """A fleet-unique request trace id (the ``X-Request-Trace`` value)."""
    return uuid.uuid4().hex[:16]
