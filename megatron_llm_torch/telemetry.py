"""Runtime telemetry (the counterpart of ``megatron_llm_tpu/telemetry.py``):
the throughput and MFU accounting, the schema-13 JSONL stream and its
flight recorder, the fixed-bucket latency histograms and Prometheus text
behind ``/metrics``, the trainer's live status endpoint and the in-loop
profiler window.

Record shapes, bucket bounds and the schema version are the JAX
package's, so the stdlib report tools (``tools/telemetry_report.py``,
``tools/serve_report.py``, ``tools/health_report.py``,
``tools/trace_report.py``) read the port's files unchanged.  Where the
JAX module calls JAX, this one calls its torch counterpart:

* the peak table is the H100's; it has no TPU entry, and a CPU has no
  peak, so no MFU is ever made up for one;
* ``device_memory_stats`` reads ``torch.cuda.memory_stats`` (which never
  synchronizes) under the JAX key names;
* ``ProfilerSession`` wraps ``torch.profiler.profile`` (CPU and CUDA
  activities) over the iteration window and writes a Chrome trace into
  the profile directory where the JAX package writes an xplane.  JAX's
  live-capture server (``--profiler_port``) has no PyTorch counterpart
  and is refused by the argument tables.

The port trains in one process, so the stream always writes (the JAX
package writes from process 0) and there is one device.
"""

from __future__ import annotations

import bisect
import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from megatron_llm_torch.global_vars import get_counters

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
FLIGHT_RECORDER_FILENAME = "flight_recorder.json"


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

    def dump(self, path: str, reason: str = "") -> str:
        """Write the recorder as JSON (atomic: tmp + rename — the caller
        may be a watchdog thread racing process death)."""
        payload = {
            "dumped_at_unix": time.time(),
            "reason": reason,
            "capacity": self.capacity,
            "records": self.records(),
        }
        return atomic_write_json(path, payload)


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
    """One schema-13 JSONL record per log boundary under ``log_dir``,
    each also kept in the flight recorder.  Tracks running aggregates
    for the end-of-run summary (mean MFU etc. — percentiles are the
    offline ``tools/telemetry_report.py``'s job)."""

    def __init__(self, log_dir: Optional[str] = None,
                 flight_recorder_size: int = 64):
        self.log_dir = log_dir
        self.flight_recorder = FlightRecorder(flight_recorder_size)
        self._file = None
        # a StatusServer (--status_port) sees every emitted record; None
        # when no live endpoint is attached
        self.status_server: Optional["StatusServer"] = None
        self._sums = {"steps": 0, "mfu": 0.0, "mfu_n": 0,
                      "tokens_per_sec_per_device": 0.0, "step_time": 0.0}
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(os.path.join(log_dir, STREAM_FILENAME),
                              "a", buffering=1)

    def emit(self, record: Dict[str, Any]) -> Dict[str, Any]:
        """Stamp, persist, and flight-record one log-boundary record."""
        rec = {"schema": TELEMETRY_SCHEMA_VERSION, "kind": "log",
               "time_unix": time.time(), **record}
        if self._file is not None:
            try:
                self._file.write(json.dumps(rec) + "\n")
            except ValueError:
                pass    # closed mid-shutdown while the engine retires
        if self.status_server is not None:
            self.status_server.update(rec)
        self.flight_recorder.record(rec)
        s = self._sums
        s["steps"] += 1
        s["step_time"] += float(rec.get("step_time_secs") or 0.0)
        s["tokens_per_sec_per_device"] += float(
            rec.get("tokens_per_sec_per_device") or 0.0)
        if rec.get("mfu") is not None:
            s["mfu"] += float(rec["mfu"])
            s["mfu_n"] += 1
        return rec

    def record_dispatch(self, rec: Dict[str, Any]) -> None:
        """Lightweight per-iteration entry — host-side fields only, never
        a device sync, so it is safe (and cheap) every step."""
        self.flight_recorder.record({"kind": "dispatch",
                                     "time_unix": time.time(), **rec})

    def summary(self) -> Dict[str, Any]:
        s = self._sums
        n = max(s["steps"], 1)
        return {
            "log_boundaries": s["steps"],
            "mean_step_time_secs": s["step_time"] / n,
            "mean_tokens_per_sec_per_device":
                s["tokens_per_sec_per_device"] / n,
            "mean_mfu": (s["mfu"] / s["mfu_n"]) if s["mfu_n"] else None,
        }

    def dump_flight_recorder(self, reason: str = "") -> Optional[str]:
        if self.log_dir is None or not len(self.flight_recorder):
            return None
        path = os.path.join(self.log_dir, FLIGHT_RECORDER_FILENAME)
        return self.flight_recorder.dump(path, reason=reason)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


# Active stream registry: the watchdog/crash path (resilience.py) and the
# wandb finish() summary reach the run's telemetry without threading it
# through every call chain — same pattern as resilience's save-fault hook.
_ACTIVE_STREAM: Optional[TelemetryStream] = None


def install_stream(stream: Optional[TelemetryStream]) -> None:
    global _ACTIVE_STREAM
    _ACTIVE_STREAM = stream


def get_stream() -> Optional[TelemetryStream]:
    return _ACTIVE_STREAM


def get_flight_recorder() -> Optional[FlightRecorder]:
    return _ACTIVE_STREAM.flight_recorder if _ACTIVE_STREAM else None


def dump_flight_recorder(reason: str = "") -> Optional[str]:
    """Dump the active run's flight recorder next to its JSONL stream
    (no-op without an installed stream or records).  Diagnostics path —
    never raises."""
    try:
        if _ACTIVE_STREAM is None:
            return None
        return _ACTIVE_STREAM.dump_flight_recorder(reason=reason)
    except Exception:
        return None


def run_summary() -> Optional[Dict[str, Any]]:
    """The active stream's aggregate summary (wandb finish() pulls this),
    merged with the active tracer's goodput breakdown + recompile /
    straggler counts when tracing is on."""
    out = _ACTIVE_STREAM.summary() if _ACTIVE_STREAM else None
    from megatron_llm_torch import tracing

    g = tracing.goodput_summary()
    if g is not None:
        out = dict(out or {})
        out["goodput_pct"] = g["goodput_pct"]
        out["goodput"] = g
        out["recompiles"] = int(get_counters().get("recompiles", 0))
        out["straggler_events"] = int(
            get_counters().get("straggler_events", 0))
    return out


# ---------------------------------------------------------------------------
# Device memory
# ---------------------------------------------------------------------------

# JAX memory_stats() key -> torch.cuda.memory_stats() key
_CUDA_MEMORY_KEYS = {
    "bytes_in_use": "allocated_bytes.all.current",
    "peak_bytes_in_use": "allocated_bytes.all.peak",
    "bytes_reserved": "reserved_bytes.all.current",
    "largest_alloc_size": "active_bytes.all.peak",
    "num_allocs": "allocation.all.allocated",
}


def device_memory_stats(device=None) -> Dict[str, int]:
    """The CUDA caching allocator's counters of one device under the JAX
    package's ``memory_stats()`` key names (``bytes_in_use``,
    ``peak_bytes_in_use``, ``bytes_limit``, ``largest_alloc_size``,
    ``num_allocs``, and ``bytes_reserved``), so the report tools read
    them unchanged.  The allocator's counters are host-side and never
    synchronize the device, so a watchdog thread may read them while the
    main thread is wedged.  {} without a card (the JAX CPU backend's
    answer too)."""
    try:
        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return {}
        if device is None:
            device = torch.cuda.current_device()
        stats = torch.cuda.memory_stats(device)
        out = {k: int(stats[v]) for k, v in _CUDA_MEMORY_KEYS.items()
               if v in stats}
        out["bytes_limit"] = int(
            torch.cuda.get_device_properties(device).total_memory)
        return out
    except Exception:
        return {}


# ---------------------------------------------------------------------------
# In-loop profiler capture
# ---------------------------------------------------------------------------

PROFILE_TRACE_FILENAME = "trace_iter{start}-{end}.json"


class ProfilerSession:
    """Wraps a chosen iteration window ``[step_start, step_end]`` in
    ``torch.profiler`` capture (CPU and, with a card, CUDA activities)
    during real training.  The loop calls ``maybe_start(upcoming
    iteration)`` before the step and ``maybe_stop(completed_iteration,
    sync=...)`` after; ``sync`` waits for the step's device work (the
    loop passes ``torch.cuda.synchronize``) so the window holds it, not
    just its launches.  On stop the Chrome trace is written into
    ``profile_dir`` (``PROFILE_TRACE_FILENAME``) and ``key_averages()``
    stays readable on ``self.profile``.  One-shot: the window fires once
    per run.  A failed start raises."""

    def __init__(self, profile_dir: str, step_start: int, step_end: int,
                 cuda: Optional[bool] = None):
        if step_end < step_start:
            raise ValueError(
                f"profile_step_end ({step_end}) < profile_step_start "
                f"({step_start})")
        self.profile_dir = profile_dir
        self.step_start = int(step_start)
        self.step_end = int(step_end)
        self.cuda = torch.cuda.is_available() if cuda is None else cuda
        self.active = False
        self.done = False
        self.profile = None
        self.trace_path: Optional[str] = None

    def maybe_start(self, upcoming_iteration: int) -> bool:
        if self.done or self.active \
                or upcoming_iteration != self.step_start:
            return False
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(self.profile_dir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.profile = profile(activities=acts)
        self.profile.__enter__()
        self.active = True
        print(f" [profiler] trace started at iteration "
              f"{upcoming_iteration} -> {self.profile_dir}", flush=True)
        return True

    def maybe_stop(self, completed_iteration: int,
                   sync: Optional[Callable[[], Any]] = None) -> bool:
        if not self.active or completed_iteration < self.step_end:
            return False
        if sync is not None:
            sync()      # device work of the window lands inside the trace
        elif self.cuda:
            torch.cuda.synchronize()
        self._stop()
        print(f" [profiler] trace stopped after iteration "
              f"{completed_iteration} -> {self.trace_path} (Chrome "
              f"trace: Perfetto or chrome://tracing)", flush=True)
        return True

    def _stop(self) -> None:
        self.profile.__exit__(None, None, None)
        self.active = False
        self.done = True
        self.trace_path = os.path.join(
            self.profile_dir, PROFILE_TRACE_FILENAME.format(
                start=self.step_start, end=self.step_end))
        self.profile.export_chrome_trace(self.trace_path)

    def close(self) -> None:
        """Stop an in-flight window on any exit path (a truncated window
        still yields a usable trace)."""
        if self.active:
            self._stop()


# ---------------------------------------------------------------------------
# Trainer live-status endpoint (--status_port)
# ---------------------------------------------------------------------------

class StatusServer:
    """Stdlib HTTP ``/health`` + ``/metrics`` over the latest telemetry
    record — the trainer-side twin of the serving server's endpoints, so
    the same scraper config covers both halves of the system.  Runs as a
    daemon thread; ``update()`` is called from the stream's ``emit()``
    so it costs one dict assignment per log boundary.

    ``/health``  -> {"status": "ok", "iteration", "secs_since_last_record",
                     "uptime_secs"}
    ``/metrics`` -> the latest record as JSON, or Prometheus text
                    exposition under the usual negotiation
                    (?format=prometheus or an Accept preferring
                    text/plain), prefix ``megatron_train_``.
    """

    def __init__(self, port: int, host: str = "0.0.0.0"):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self._latest: Optional[Dict[str, Any]] = None
        self._latest_at: Optional[float] = None
        self._t_start = time.time()
        self._lock = threading.Lock()
        status = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *a):     # silence per-request noise
                pass

            def _send(self, code, payload, content_type="application/json"):
                body = payload if isinstance(payload, bytes) \
                    else json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path
                if path.partition("?")[0] == "/health":
                    self._send(200, status.health())
                elif path.partition("?")[0] == "/metrics":
                    latest = status.latest() or {}
                    if _wants_prometheus(path,
                                         self.headers.get("Accept", "")):
                        text = prometheus_exposition(
                            latest, prefix="megatron_train_")
                        self._send(200, text.encode(),
                                   content_type="text/plain; version=0.0.4")
                    else:
                        self._send(200, latest)
                else:
                    self._send(404, {"message": "not found"})

        self.httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]    # resolved when port=0
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="status-server",
            daemon=True)
        self._thread.start()

    def update(self, rec: Dict[str, Any]) -> None:
        # keep only JSON-serializable leaves; the record already is
        with self._lock:
            self._latest = rec
            self._latest_at = time.time()

    def latest(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return dict(self._latest) if self._latest else None

    def health(self) -> Dict[str, Any]:
        with self._lock:
            latest, at = self._latest, self._latest_at
        return {
            "status": "ok",
            "iteration": (latest or {}).get("iteration"),
            "secs_since_last_record":
                (round(time.time() - at, 3) if at else None),
            "uptime_secs": round(time.time() - self._t_start, 3),
        }

    def close(self) -> None:
        try:
            self.httpd.shutdown()
            self.httpd.server_close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# Bundle + CLI wiring
# ---------------------------------------------------------------------------

@dataclass
class Telemetry:
    """Everything the train loop needs, in one optional argument."""

    throughput: Optional[ThroughputCalculator] = None
    stream: Optional[TelemetryStream] = None
    profiler: Optional[ProfilerSession] = None
    tracing: Optional[Any] = None       # a tracing.Tracing bundle
    status: Optional[StatusServer] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def default(cls, model) -> "Telemetry":
        """Throughput-only telemetry (free): every run reports
        tokens/sec/device + MFU at log boundaries even with no flags."""
        return cls(throughput=ThroughputCalculator.from_model(model))

    def close(self) -> None:
        if self.profiler is not None:
            self.profiler.close()
        if self.tracing is not None:
            # writes the trace file, then uninstalls the module registry
            self.tracing.close()
        if self.status is not None:
            self.status.close()
        if self.stream is not None:
            if get_stream() is self.stream:
                install_stream(None)
            self.stream.close()


def recovery_counters() -> Dict[str, int]:
    from megatron_llm_torch.resilience import recovery_counters as rc

    return rc()


def build_telemetry(args, model) -> Telemetry:
    """CLI wiring: a Telemetry bundle from parsed args.  Always returns a
    bundle (throughput accounting is free); the stream/profiler members
    exist only when their flags ask for them."""
    t = Telemetry.default(model)
    log_dir = getattr(args, "structured_log_dir", None)
    if log_dir:
        t.stream = TelemetryStream(
            log_dir,
            flight_recorder_size=getattr(args, "flight_recorder_size", 64))
        install_stream(t.stream)
    if getattr(args, "profile", False):
        profile_dir = getattr(args, "profile_dir", None) \
            or (os.path.join(log_dir, "profile") if log_dir
                else "profile_trace")
        t.profiler = ProfilerSession(
            profile_dir,
            step_start=getattr(args, "profile_step_start", 10),
            step_end=getattr(args, "profile_step_end", 12),
            cuda=torch.device(model.device).type == "cuda",
        )
    status_port = getattr(args, "status_port", None)
    if status_port is not None:
        if t.stream is None:
            # in-memory stream: the endpoint needs emit() records even
            # when nothing asked for the JSONL file
            t.stream = TelemetryStream(
                None,
                flight_recorder_size=getattr(
                    args, "flight_recorder_size", 64))
            install_stream(t.stream)
        t.status = StatusServer(int(status_port))
        t.stream.status_server = t.status
        print(f" [telemetry] status endpoint on port {t.status.port} "
              f"(/health, /metrics)", flush=True)
    from megatron_llm_torch import tracing as _tracing

    t.tracing = _tracing.build_tracing(args)    # None without --trace_dir
    return t
