"""Serving telemetry: the JSONL record stream, its flight recorder, and the
fixed-bucket latency histograms behind ``/metrics``.

The subset of ``megatron_llm_tpu/telemetry.py`` that the serving engine
and its host-side modules (``serving/loop_profiler.py``,
``serving/cache_observatory.py``) call.  Record shapes, bucket bounds and
the schema version are the same, so the stdlib report tools
(``tools/serve_report.py``, ``tools/telemetry_report.py``) read a port
replica's stream unchanged.  The trainer's MFU accounting, status server
and profiler session belong to the training slice.
"""

from __future__ import annotations

import bisect
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

TELEMETRY_SCHEMA_VERSION = 13
STREAM_FILENAME = "telemetry.jsonl"


class FlightRecorder:
    """Bounded deque of the most recent records (the record consulted
    when a run dies)."""

    def __init__(self, capacity: int = 64):
        self.capacity = int(capacity)
        self._records: deque = deque(maxlen=max(self.capacity, 1))

    def record(self, rec: Dict[str, Any]) -> None:
        self._records.append(rec)

    def records(self) -> List[Dict[str, Any]]:
        return list(self._records)

    def __len__(self) -> int:
        return len(self._records)


# Prometheus-style latency buckets (seconds).  Fixed across the fleet so
# replica histograms merge by bucket-sum in the router's /metrics.
DEFAULT_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)

_INF_LABEL = "+Inf"


def _bucket_label(bound: float) -> str:
    return format(bound, "g")


class Histogram:
    """Stdlib fixed-bucket histogram, mergeable by bucket-sum.

    Snapshots carry per-bucket (non-cumulative) counts keyed by the
    bucket's upper bound, plus ``count`` and ``sum`` — all additive, so a
    sum over replica snapshots is the fleet histogram."""

    def __init__(self, bounds=DEFAULT_LATENCY_BUCKETS):
        self.bounds = tuple(sorted(float(b) for b in bounds))
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._counts = [0] * (len(self.bounds) + 1)     # last = +Inf
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value) -> None:
        if value is None:
            return
        v = float(value)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        buckets = {_bucket_label(b): counts[i]
                   for i, b in enumerate(self.bounds)}
        buckets[_INF_LABEL] = counts[-1]
        return {"buckets": buckets, "count": total, "sum": round(s, 9)}


def is_histogram_snapshot(d: Any) -> bool:
    return (isinstance(d, dict) and "count" in d and "sum" in d
            and isinstance(d.get("buckets"), dict))


def histogram_percentile(snap: Dict[str, Any], q: float) -> Optional[float]:
    """Estimate the q-quantile from a (possibly merged) histogram
    snapshot: linear interpolation within the winning bucket; the +Inf
    bucket answers with the largest finite bound.  None when empty."""
    if not is_histogram_snapshot(snap):
        return None
    total = snap.get("count") or 0
    if total <= 0:
        return None
    items = []
    for k, v in snap["buckets"].items():
        bound = float("inf") if k in (_INF_LABEL, "inf") else float(k)
        items.append((bound, int(v)))
    items.sort()
    target = max(min(float(q), 1.0), 0.0) * total
    cum = 0
    lo = 0.0
    for bound, c in items:
        if c > 0 and cum + c >= target:
            if bound == float("inf"):
                return lo
            frac = (target - cum) / c if c else 1.0
            return lo + (bound - lo) * max(min(frac, 1.0), 0.0)
        cum += c
        if bound != float("inf"):
            lo = bound
    return lo


class TelemetryStream:
    """Schema-13 JSONL records under ``log_dir`` (one line per record),
    each also kept in the flight recorder."""

    def __init__(self, log_dir: Optional[str] = None,
                 flight_recorder_size: int = 64):
        self.log_dir = log_dir
        self.flight_recorder = FlightRecorder(flight_recorder_size)
        self._file = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(os.path.join(log_dir, STREAM_FILENAME),
                              "a", buffering=1)

    def emit(self, record: Dict[str, Any]) -> Dict[str, Any]:
        rec = {"schema": TELEMETRY_SCHEMA_VERSION, "kind": "log",
               "time_unix": time.time(), **record}
        if self._file is not None:
            try:
                self._file.write(json.dumps(rec) + "\n")
            except ValueError:
                pass    # closed mid-shutdown while the engine retires
        self.flight_recorder.record(rec)
        return rec

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


_ACTIVE_STREAM: Optional[TelemetryStream] = None


def install_stream(stream: Optional[TelemetryStream]) -> None:
    global _ACTIVE_STREAM
    _ACTIVE_STREAM = stream


def get_stream() -> Optional[TelemetryStream]:
    return _ACTIVE_STREAM


def get_flight_recorder() -> Optional[FlightRecorder]:
    return _ACTIVE_STREAM.flight_recorder if _ACTIVE_STREAM else None
