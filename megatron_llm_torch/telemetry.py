"""Telemetry: the trainer's throughput and MFU accounting, and for
serving the JSONL record stream, its flight recorder and the
fixed-bucket latency histograms behind ``/metrics``.

The subset of ``megatron_llm_tpu/telemetry.py`` that the port's trainer
(``training.py``), the serving engine and its host-side modules
(``serving/loop_profiler.py``, ``serving/cache_observatory.py``) call.
Record shapes, bucket bounds and the schema version are the same, so the
stdlib report tools (``tools/serve_report.py``,
``tools/telemetry_report.py``) read a port replica's stream unchanged.
The server's Prometheus text exposition
(``prometheus_exposition``, ``_wants_prometheus``) and the postmortem
bundle writers of the SLO sentinel (``atomic_write_json``,
``capture_thread_stacks``, ``write_snapshot_bundle``) are copies of the
JAX package's.  The peak table is the H100's; it has no TPU entry, and a
CPU has no peak, so no MFU is ever made up for one.  The trainer's JSONL
stream, status server and profiler session are later slices.
"""

from __future__ import annotations

import bisect
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import torch

TELEMETRY_SCHEMA_VERSION = 13

# ---------------------------------------------------------------------------
# Peak FLOPs / MFU
# ---------------------------------------------------------------------------

# dense bf16 tensor-core peak per card, keyed by substrings of
# torch.cuda.get_device_name() (NVIDIA's H100 data sheet: SXM 989
# TFLOP/s, PCIe 756 TFLOP/s; the SXM part names itself "H100 80GB HBM3")
PEAK_FLOPS = {
    "H100 80GB HBM3": 989e12,
    "H100 SXM": 989e12,
    "H100 PCIe": 756e12,
}

# MFU above this is physically impossible: the timing failed to wait for
# the device.  The throughput record then reports null.
MFU_SANITY_LIMIT = 0.95


def peak_flops_for_kind(device_kind: str) -> Optional[float]:
    """Peak bf16 FLOP/s for a device name, or None when the table has no
    entry for it (a CPU, an unknown card): a null peak means the MFU is
    never fabricated."""
    for k, v in PEAK_FLOPS.items():
        if k in device_kind:
            return v
    return None


def peak_flops_for_device(device) -> Optional[float]:
    """Peak FLOP/s of ``device`` (None for the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return peak_flops_for_kind(torch.cuda.get_device_name(device))


class ThroughputCalculator:
    """Tokens/sec(/device), achieved TFLOPs/device and MFU from wall time.

    ``flops_per_token`` is the model-level fwd+bwd estimate
    (``model.flops_per_token()``, models/language_model.py); ``peak_flops``
    the per-card bf16 peak (None => MFU is always null)."""

    def __init__(self, flops_per_token: Optional[float] = None,
                 device_count: int = 1,
                 peak_flops: Optional[float] = None):
        self.flops_per_token = flops_per_token
        self.device_count = device_count
        self.peak_flops = peak_flops

    @classmethod
    def from_model(cls, model, device_count: int = 1,
                   peak_flops: Optional[float] = "auto"):
        """Build from a model exposing ``flops_per_token()`` and
        ``device`` (the port trains on one device)."""
        fn = getattr(model, "flops_per_token", None)
        fpt = float(fn()) if callable(fn) else None
        if peak_flops == "auto":
            peak_flops = peak_flops_for_device(model.device)
        return cls(flops_per_token=fpt, device_count=device_count,
                   peak_flops=peak_flops)

    def compute(self, tokens: float, elapsed_secs: float) -> Dict[str, Any]:
        """One log boundary's throughput record.  ``tokens`` is the token
        count per iteration, ``elapsed_secs`` the per-iteration wall time.
        MFU is null when the peak is unknown (CPU) or the number trips the
        fabrication guard."""
        n = max(self.device_count, 1)
        tps = tokens / max(elapsed_secs, 1e-9)
        out: Dict[str, Any] = {
            "tokens_per_sec": tps,
            "tokens_per_sec_per_device": tps / n,
            "tflops_per_device": None,
            "mfu": None,
        }
        if self.flops_per_token:
            achieved = tps * self.flops_per_token / n
            out["tflops_per_device"] = achieved / 1e12
            if self.peak_flops:
                mfu = achieved / self.peak_flops
                out["mfu"] = mfu if mfu <= MFU_SANITY_LIMIT else None
        return out
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



# ---------------------------------------------------------------------------
# Atomic snapshot writing (shared by the flight recorder, the crash
# path's stack dump, and the serving alert engine's postmortem bundles)
# ---------------------------------------------------------------------------

def atomic_write_json(path: str, payload: Any, indent: int = 1) -> str:
    """Write JSON atomically (tmp + rename): a reader — or a scraper
    racing process death — sees either the old file or the complete new
    one, never a truncated write."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=indent, default=str)
    os.replace(tmp, path)
    return path


def capture_thread_stacks() -> str:
    """All-thread stack report (the watchdog/crash dump and the alert
    bundles share this): one block per thread with name/daemon flag and
    the formatted frames from ``sys._current_frames``."""
    import sys
    import traceback

    frames = sys._current_frames()
    names = {t.ident: t for t in threading.enumerate()}
    out = []
    for ident, frame in sorted(frames.items()):
        t = names.get(ident)
        label = f"{t.name}{' (daemon)' if t.daemon else ''}" \
            if t is not None else "unknown"
        out.append(f"--- thread {label} (ident {ident}) ---")
        out.append("".join(traceback.format_stack(frame)))
    return "\n".join(out)


def write_snapshot_bundle(dir_path: str, parts: Dict[str, Any],
                          max_bytes_per_part: int = 2_000_000,
                          manifest_extra: Optional[Dict[str, Any]] = None
                          ) -> str:
    """Write a postmortem bundle as an atomically-published directory.

    ``parts`` maps part name -> payload: a str becomes ``<name>.txt``,
    anything else JSON-serializes to ``<name>.json``.  Every part is
    size-bounded (oversize payloads are truncated with a marker, never
    dropped silently) and the bundle carries a ``manifest.json`` listing
    what landed.  The whole directory is staged under a pid-suffixed tmp
    name and published with one ``os.replace`` so a reader never sees a
    half-written bundle — the same tmp+rename discipline as
    :func:`atomic_write_json`, at directory granularity."""
    tmp = f"{dir_path}.tmp.{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    manifest: Dict[str, Any] = {
        "written_at_unix": time.time(),
        "parts": {},
    }
    if manifest_extra:
        manifest.update(manifest_extra)
    for name, payload in sorted(parts.items()):
        try:
            if isinstance(payload, str):
                fname, data = f"{name}.txt", payload
            else:
                fname, data = f"{name}.json", json.dumps(
                    payload, indent=1, default=str)
            truncated = False
            if len(data) > max_bytes_per_part:
                data = data[:max_bytes_per_part] \
                    + "\n...[truncated by bundle size bound]"
                truncated = True
            with open(os.path.join(tmp, fname), "w") as f:
                f.write(data)
            manifest["parts"][name] = {"file": fname,
                                       "bytes": len(data),
                                       "truncated": truncated}
        except Exception as exc:    # noqa: BLE001 - forensics: best effort
            manifest["parts"][name] = {"error": repr(exc)}
    atomic_write_json(os.path.join(tmp, "manifest.json"), manifest)
    if os.path.isdir(dir_path):     # an older bundle with the same name
        os.replace(os.path.join(tmp, "manifest.json"),
                   os.path.join(dir_path, "manifest.json"))
        for f in os.listdir(tmp):
            os.replace(os.path.join(tmp, f), os.path.join(dir_path, f))
        os.rmdir(tmp)
    else:
        os.replace(tmp, dir_path)
    return dir_path


# ---------------------------------------------------------------------------
# Prometheus text exposition (shared by serving /metrics, the router's
# fleet /metrics, and the trainer's --status_port endpoint)
# ---------------------------------------------------------------------------

def _metric_name(name: str) -> str:
    name = "".join(c if (c.isalnum() and c.isascii()) or c == "_"
                   else "_" for c in name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def prometheus_exposition(snapshot: dict,
                          prefix: str = "megatron_serve_") -> str:
    """Render a metrics snapshot dict as Prometheus text exposition
    format (0.0.4) so standard scrapers can hit ``/metrics`` without a
    JSON-translating sidecar.  Nested dicts (the ``engine`` block, its
    per-reason completion counts) flatten into underscore-joined names;
    None values (e.g. empty-window percentiles) are omitted; numbers are
    exported as gauges — the scraper cannot tell a monotone counter from
    a level, and gauge is always safe.  Histogram snapshots (the
    ``Histogram.snapshot()`` shape) render as proper Prometheus
    histograms: cumulative ``_bucket{le=...}`` series plus ``_sum`` and
    ``_count``.  An ``alerts`` block (the serving alert engine's
    snapshot shape) renders its firing list as the labeled gauge
    ``megatron_alert_firing{rule=...,scope=...} 1`` — the one labeled
    series in the exposition, with a fixed unprefixed name so the same
    alerting config scrapes replica and fleet endpoints alike — and its
    numeric counters as ordinary gauges."""
    lines = []

    def esc(v):
        return str(v).replace("\\", "\\\\").replace('"', '\\"')

    def emit_alert_block(path, block):
        lines.append("# TYPE megatron_alert_firing gauge")
        for entry in block.get("firing") or []:
            if not isinstance(entry, dict):
                continue
            lines.append(
                f'megatron_alert_firing{{rule="{esc(entry.get("rule"))}"'
                f',scope="{esc(entry.get("scope"))}"'
                f',severity="{esc(entry.get("severity"))}"}} 1')
        rest = {k: v for k, v in block.items()
                if k not in ("firing", "pending")}
        walk(rest, path)

    def emit(name, value):
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            return
        name = _metric_name(name)
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {float(value):g}")

    def emit_histogram(name, snap):
        name = _metric_name(name)
        items = []
        for k, v in snap["buckets"].items():
            bound = float("inf") if k in (_INF_LABEL, "inf") else float(k)
            items.append((bound, k, int(v)))
        items.sort()
        lines.append(f"# TYPE {name} histogram")
        cum = 0
        for bound, label, c in items:
            cum += c
            lines.append(f'{name}_bucket{{le="{label}"}} {cum}')
        lines.append(f"{name}_sum {float(snap.get('sum') or 0.0):g}")
        lines.append(f"{name}_count {int(snap.get('count') or 0)}")

    def walk(d, path):
        for k, v in sorted(d.items()):
            if is_histogram_snapshot(v):
                emit_histogram(f"{path}{k}", v)
            elif k == "alerts" and isinstance(v, dict) \
                    and isinstance(v.get("firing"), list):
                emit_alert_block(f"{path}{k}_", v)
            elif isinstance(v, dict):
                walk(v, f"{path}{k}_")
            else:
                emit(f"{path}{k}", v)

    walk(snapshot, prefix)
    return "\n".join(lines) + "\n"


def _wants_prometheus(path: str, accept: str) -> bool:
    """Content negotiation for /metrics: an explicit ?format=prometheus
    query wins; otherwise an Accept header preferring text/plain (what
    the Prometheus scraper sends) selects the text exposition."""
    query = path.partition("?")[2]
    for pair in query.split("&"):
        if pair.partition("=")[::2] == ("format", "prometheus"):
            return True
    accept = accept.lower()
    return ("text/plain" in accept or "openmetrics" in accept) \
        and "application/json" not in accept


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
