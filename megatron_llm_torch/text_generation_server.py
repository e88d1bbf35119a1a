"""REST text-generation server (the counterpart of
``megatron_llm_tpu/text_generation_server.py``), with its two dispatch
paths behind one contract:

* legacy (no engine): one ``generate_and_post_process`` (or
  ``beam_search_and_post_process``) call a request under a lock, so one
  generation is in flight and the others wait on the lock.  Beam search,
  logprobs and ``tokens_to_generate == 0`` always take it;
* engine (an ``InferenceEngine`` passed in, by ``--serve_engine``):
  requests are co-batched token by token by the continuous-batching
  engine, a full queue answers 429, and ``PUT /api/stream`` serves
  tokens as they come.

The contract:

* ``PUT /api`` (or ``/generate``): request validation, JSON 400s, 429
  with ``Retry-After`` when the engine queue is full, ``{"text",
  "segments", "tokens"}`` bodies (``"logprobs"`` too when asked;
  ``{"text", "scores"}`` for beam search);
* ``PUT /api/stream`` (or ``/generate/stream``, engine only): one prompt
  served as server-sent events, one ``data:`` event a token and a final
  ``{"done": ...}`` record;
* graceful drain, by ``/drain`` or SIGTERM (``begin_drain``): new
  requests get 503 with ``Retry-After``, ``/health`` says
  ``"draining"``, in-flight work finishes, then the server stops;
* ``GET /health``; ``GET /metrics`` as JSON (the engine's ``stats()``
  under ``"engine"``, its ``kernel_launch_snapshot()`` under
  ``"kernel_launches"``, the mergeable SLO histograms, the SLO
  sentinel's ``"alerts"``) or, asked by ``?format=prometheus`` or an ``Accept``
  header that prefers it, as Prometheus text;
* ``GET /`` and ``/index.html``: the demo page (``static/index.html``).

``build_server_alerts`` wires the SLO sentinel (``serving/alerts.py``)
over the server's own ``/metrics`` snapshot.  Run on port 0, the server
writes ``PORT <n>`` on stdout once it accepts, the handshake that the
fleet supervisor (``serving/supervisor.py``) waits for.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from megatron_llm_torch import telemetry
from megatron_llm_torch import tracing as _tracing

from megatron_llm_torch.serving.request import (
    EngineError,
    QueueFull,
    SamplingParams,
)
from megatron_llm_torch.telemetry import (
    Histogram,
    _wants_prometheus,
    histogram_percentile,
    prometheus_exposition,
)
from megatron_llm_torch.text_generation.api import (
    beam_search_and_post_process,
    generate_and_post_process,
    resolve_stop_rules,
)
from megatron_llm_torch.tracing import new_trace_id

MAX_PROMPTS = 128       # defaults; override with --serve_max_prompts /
MAX_TOKENS = 1024       # --serve_max_tokens

TRACE_HEADER = "X-Request-Trace"


class ServerMetrics:
    """Request/error counts, p50/p95 latency over a bounded window,
    tokens generated, the SLO histograms fed by the engine's
    request_done hook, and the last finished-request records (the SLO
    sentinel's bundles embed them).  Thread-safe."""

    _lock_protected_ = {"histograms": "_lock", "drained": "_lock",
                        "recent_records": "_lock"}

    def __init__(self, window: int = 512, recent_records_size: int = 64):
        self._lock = threading.Lock()
        self._window = max(int(window), 1)
        self._latencies = []
        self.recent_records = deque(maxlen=max(int(recent_records_size), 1))
        # the SLO sentinel, attached by build_server_alerts; its snapshot
        # rides in /metrics under "alerts"
        self.alert_engine = None
        self.started_unix = time.time()
        self.requests = 0
        self.errors = 0
        self.throttled = 0
        self.streamed = 0           # SSE requests served
        self.drained = 0            # graceful-drain initiations
        self.tokens_generated = 0
        self.engine_stats_fn = None
        # the engine's kernel_launch_snapshot (a port addition, not in
        # the JAX server): /metrics "kernel_launches"
        self.kernel_launches_fn = None
        self.histograms = {
            "ttft_secs": Histogram(),
            "tpot_secs": Histogram(),
            "e2e_secs": Histogram(),
            "queue_wait_secs": Histogram(),
        }

    def observe_request_done(self, record: dict) -> None:
        """Engine ``request_done_hook``: keep the record and fold it into
        the SLO histograms.  Never raises."""
        try:
            with self._lock:
                self.recent_records.append(dict(record))
                self.histograms["ttft_secs"].observe(
                    record.get("ttft_secs"))
                self.histograms["tpot_secs"].observe(
                    record.get("tpot_secs"))
                self.histograms["e2e_secs"].observe(
                    record.get("latency_secs"))
                phases = record.get("phases") or {}
                self.histograms["queue_wait_secs"].observe(
                    phases.get("queue_secs"))
        except Exception:   # noqa: BLE001 - metrics never stop serving
            pass

    def note_drained(self) -> None:
        """Count one graceful-drain initiation (HTTP threads and the
        SIGTERM handler)."""
        with self._lock:
            self.drained += 1

    def observe(self, secs: float, status: int, tokens: int = 0,
                streamed: bool = False) -> None:
        with self._lock:
            self.requests += 1
            if status >= 400:
                self.errors += 1
            if status == 429:
                self.throttled += 1
            if streamed:
                self.streamed += 1
            self.tokens_generated += max(int(tokens), 0)
            self._latencies.append(float(secs))
            if len(self._latencies) > self._window:
                del self._latencies[:len(self._latencies) - self._window]

    @staticmethod
    def _percentile(values, q: float) -> float:
        s = sorted(values)
        return s[min(int(q * (len(s) - 1) + 0.5), len(s) - 1)]

    def snapshot(self) -> dict:
        with self._lock:
            lat = list(self._latencies)
            out = {
                "uptime_secs": time.time() - self.started_unix,
                "requests": self.requests,
                "errors": self.errors,
                "throttled": self.throttled,
                "streamed": self.streamed,
                "drained": self.drained,
                "tokens_generated": self.tokens_generated,
            }
            hist_snaps = {name: h.snapshot()
                          for name, h in self.histograms.items()}
        out["latency_p50_secs"] = self._percentile(lat, 0.50) if lat else None
        out["latency_p95_secs"] = self._percentile(lat, 0.95) if lat else None
        out["histograms"] = hist_snaps
        out["slo"] = {}
        for name, snap in hist_snaps.items():
            for q, tag in ((0.50, "p50"), (0.95, "p95"), (0.99, "p99")):
                out["slo"][f"{name}_{tag}"] = histogram_percentile(snap, q)
        fn = self.engine_stats_fn
        if fn is not None:
            try:
                out["engine"] = fn()
            except Exception:   # noqa: BLE001 - metrics never stop serving
                pass
        fn = self.kernel_launches_fn
        if fn is not None:
            out["kernel_launches"] = fn()
        alerts = self.alert_engine
        if alerts is not None:
            try:
                out["alerts"] = alerts.snapshot()
            except Exception:   # noqa: BLE001 - metrics never stop serving
                pass
        return out

    def recent_request_done(self) -> list:
        """The last finished-request records (the bundles' source)."""
        with self._lock:
            return list(self.recent_records)


def _count_tokens(body: dict) -> int:
    toks = body.get("tokens")
    if isinstance(toks, list):
        return sum(len(t) for t in toks if isinstance(t, list))
    return 0


class MegatronGenerate:
    """Request validation + dispatch to the engine or the legacy path."""

    def __init__(self, model, params, tokenizer, int8_kv_cache=False,
                 engine=None, log_requests=False, max_prompts=None,
                 max_tokens=None):
        self.model = model
        self.params = params
        self.tokenizer = tokenizer
        self.int8_kv_cache = int8_kv_cache
        self.engine = engine
        self.log_requests = bool(log_requests)
        self.max_prompts = int(max_prompts or MAX_PROMPTS)
        self.max_tokens = int(max_tokens or MAX_TOKENS)
        # the legacy path runs one generation at a time
        self.lock = threading.Lock()

    def _parse(self, payload: dict):
        """``(None, knobs)`` on success or ``((code, body), None)``."""
        if "prompts" not in payload:
            return (400, {"message": "prompts argument required"}), None
        if "max_len" in payload:
            return (400, {"message": "max_len is no longer used.  Replace "
                                     "with tokens_to_generate"}), None
        if "sentences" in payload:
            return (400, {"message": "sentences is no longer used.  "
                                     "Replace with prompts"}), None
        prompts = payload["prompts"]
        if not isinstance(prompts, list) or not prompts:
            return (400, {"message": "prompts must be a non-empty list"}), \
                None
        if len(prompts) > self.max_prompts:
            return (400, {"message": f"maximum number of prompts is "
                                     f"{self.max_prompts}"}), None
        add_BOS = bool(payload.get("add_BOS", False))
        if not add_BOS and any(len(p) == 0 for p in prompts
                               if isinstance(p, str)):
            return (400, {"message": "Empty prompts require add_BOS=true"}), \
                None
        tokens_to_generate = payload.get("tokens_to_generate", 64)
        if not isinstance(tokens_to_generate, int) or tokens_to_generate < 0:
            return (400, {"message": "tokens_to_generate must be an "
                                     "integer >= 0"}), None
        if tokens_to_generate > self.max_tokens:
            return (400, {"message": f"maximum tokens_to_generate is "
                                     f"{self.max_tokens}"}), None
        top_k = int(payload.get("top_k", 0))
        if top_k < 0 or top_k > 1000:
            return (400, {"message": "top_k must be in [0, 1000]"}), None
        top_p = float(payload.get("top_p", 0.0))
        if top_p < 0.0 or top_p > 1.0:
            return (400, {"message": "top_p must be in [0, 1]"}), None
        temperature = float(payload.get("temperature", 1.0))
        if temperature < 0.0 or temperature > 100.0:
            return (400, {"message": "temperature must be in [0, 100] "
                                     "(0 = greedy)"}), None
        top_p_decay = float(payload.get("top_p_decay", 0.0))
        if top_p_decay < 0.0 or top_p_decay > 1.0:
            return (400, {"message": "top_p_decay must be in [0, 1]"}), None
        if top_p_decay > 0.0 and top_p == 0.0:
            return (400, {"message": "top_p_decay requires top_p"}), None
        top_p_bound = float(payload.get("top_p_bound", 0.0))
        if "top_p_bound" in payload and (top_p_bound <= 0.0
                                         or top_p_bound > top_p):
            return (400, {"message": "top_p_bound must be in (0, top_p]"}), \
                None
        knobs = {
            "prompts": prompts,
            "add_BOS": add_BOS,
            "tokens_to_generate": tokens_to_generate,
            "top_k": top_k,
            "top_p": top_p,
            "temperature": temperature,
            "top_p_decay": top_p_decay,
            "top_p_bound": top_p_bound,
            "logprobs": bool(payload.get("logprobs", False)),
            "stop_on_eol": bool(payload.get("stop_on_eol", False)),
            "stop_on_double_eol": bool(payload.get("stop_on_double_eol",
                                                   False)),
            "prevent_newline_after_colon": bool(
                payload.get("prevent_newline_after_colon", False)),
            "beam_width": payload.get("beam_width", None),
            "stop_token": payload.get("stop_token", None),
            "length_penalty": float(payload.get("length_penalty", 1.0)),
            "random_seed": int(payload.get("random_seed", 0)),
            "no_log": bool(payload.get("no_log", False)),
        }
        return None, knobs

    def handle(self, payload: dict, trace_id=None):
        try:
            err, knobs = self._parse(payload)
        except (TypeError, ValueError) as exc:
            return 400, {"message": f"malformed parameter: {exc}"}
        if err is not None:
            return err
        if self.log_requests and not knobs["no_log"]:
            print(json.dumps(payload), flush=True)
        use_engine = (self.engine is not None
                      and knobs["beam_width"] is None
                      and not knobs["logprobs"]
                      and knobs["tokens_to_generate"] > 0)
        if use_engine:
            return self._handle_engine(knobs, trace_id=trace_id)
        return self._handle_legacy(knobs)

    def _handle_legacy(self, knobs: dict):
        with self.lock:
            if knobs["beam_width"] is not None:
                if len(knobs["prompts"]) > 1:
                    return 400, {"message": "beam search requires one prompt"}
                texts, scores = beam_search_and_post_process(
                    self.model, self.params, self.tokenizer,
                    knobs["prompts"],
                    tokens_to_generate=knobs["tokens_to_generate"],
                    beam_size=int(knobs["beam_width"]),
                    length_penalty=knobs["length_penalty"],
                    stop_token=(int(knobs["stop_token"])
                                if knobs["stop_token"] is not None else None))
                return 200, {"text": texts, "scores": scores.tolist()}
            texts, segments, log_probs, tokens = generate_and_post_process(
                self.model, self.params, self.tokenizer, knobs["prompts"],
                tokens_to_generate=knobs["tokens_to_generate"],
                return_output_log_probs=knobs["logprobs"],
                top_k_sampling=knobs["top_k"],
                top_p_sampling=knobs["top_p"],
                temperature=knobs["temperature"],
                random_seed=knobs["random_seed"],
                add_BOS=knobs["add_BOS"],
                top_p_decay=knobs["top_p_decay"],
                top_p_bound=knobs["top_p_bound"],
                stop_on_eol=knobs["stop_on_eol"],
                stop_on_double_eol=knobs["stop_on_double_eol"],
                prevent_newline_after_colon=knobs[
                    "prevent_newline_after_colon"],
                int8_kv_cache=self.int8_kv_cache)
            out = {"text": texts, "segments": segments, "tokens": tokens}
            if knobs["logprobs"]:
                out["logprobs"] = log_probs.tolist()
            return 200, out

    def _tokenize(self, prompt: str, add_BOS: bool):
        toks = self.tokenizer.tokenize(prompt)
        if add_BOS:
            bos = getattr(self.tokenizer, "bos_token_id", None)
            if bos is None:
                bos = self.tokenizer.eod
            toks = [bos] + list(toks)
        return list(toks)

    def _sampling_params(self, knobs: dict, index: int) -> SamplingParams:
        extra_stop, stop_pairs, ban_pairs = resolve_stop_rules(
            self.tokenizer,
            stop_on_eol=knobs["stop_on_eol"],
            stop_on_double_eol=knobs["stop_on_double_eol"],
            prevent_newline_after_colon=knobs[
                "prevent_newline_after_colon"])
        return SamplingParams(
            max_new_tokens=knobs["tokens_to_generate"],
            temperature=knobs["temperature"],
            top_k=knobs["top_k"],
            top_p=knobs["top_p"],
            top_p_decay=knobs["top_p_decay"],
            top_p_bound=knobs["top_p_bound"],
            # distinct streams for identical prompts in one batch
            seed=knobs["random_seed"] + index,
            eod_id=getattr(self.tokenizer, "eod", None),
            stop_token_ids=extra_stop,
            stop_pairs=stop_pairs,
            ban_pair=(ban_pairs[0] if ban_pairs else None),
        )

    def _submit_engine(self, knobs: dict, stream: bool = False,
                       trace_id=None):
        """Returns (None, requests) or ((code, body), None)."""
        try:
            token_lists = [self._tokenize(p, knobs["add_BOS"])
                           for p in knobs["prompts"]]
            samplings = [self._sampling_params(knobs, i)
                         for i in range(len(token_lists))]
            reqs = self.engine.submit_many(token_lists, samplings,
                                           stream=stream,
                                           trace_id=trace_id)
            return None, reqs
        except QueueFull as exc:
            body = {"message": str(exc),
                    "retry_after_secs": exc.retry_after_secs,
                    "queue_depth": self.engine.queue.depth(),
                    "estimated_wait_secs": self.engine.estimate_wait_secs()}
            return (429, body), None
        except ValueError as exc:
            return (400, {"message": str(exc)}), None

    def _result_timeout(self) -> float:
        dl = getattr(self.engine.config, "default_deadline_secs", 0) or 0
        return dl + 60.0 if dl else 600.0

    def _handle_engine(self, knobs: dict, trace_id=None):
        err, reqs = self._submit_engine(knobs, trace_id=trace_id)
        if err is not None:
            return err
        texts, segments, tokens = [], [], []
        timeout = self._result_timeout()
        for r in reqs:
            try:
                r.result(timeout=timeout)
            except EngineError as exc:
                return 500, {"message": f"engine error: {exc}"}
            except TimeoutError:
                return 500, {"message": "generation timed out"}
            if r.finish_reason == "deadline":
                return 503, {"message": "request deadline exceeded "
                                        "before completion"}
            if r.finish_reason == "nonfinite":
                return 500, {"message": r.error or "non-finite logits "
                                                   "detected; slot evicted",
                             "finish_reason": "nonfinite"}
            row = r.tokens
            tokens.append(row)
            texts.append(self.tokenizer.detokenize(row))
            segments.append([self.tokenizer.detokenize([t]) for t in row])
        return 200, {"text": texts, "segments": segments, "tokens": tokens}

    def handle_stream(self, payload: dict, trace_id=None):
        """SSE path (``PUT /api/stream``): ``(code, body, None)`` on
        rejection or ``(200, {}, events)``, where ``events`` yields one
        JSON-able dict a token and a final ``{"done": ...}`` record."""
        try:
            err, knobs = self._parse(payload)
        except (TypeError, ValueError) as exc:
            return 400, {"message": f"malformed parameter: {exc}"}, None
        if err is not None:
            return err[0], err[1], None
        if self.engine is None:
            return 400, {"message": "streaming requires the continuous-"
                                    "batching engine (start the server "
                                    "with --serve_engine)"}, None
        if len(knobs["prompts"]) != 1:
            return 400, {"message": "streaming supports a single prompt"}, \
                None
        if knobs["beam_width"] is not None or knobs["logprobs"]:
            return 400, {"message": "streaming does not support beam "
                                    "search or logprobs"}, None
        if knobs["tokens_to_generate"] == 0:
            return 400, {"message": "streaming requires "
                                    "tokens_to_generate > 0"}, None
        if self.log_requests and not knobs["no_log"]:
            print(json.dumps(payload), flush=True)
        err, reqs = self._submit_engine(knobs, stream=True,
                                        trace_id=trace_id)
        if err is not None:
            return err[0], err[1], None
        req = reqs[0]
        tokenizer = self.tokenizer
        timeout = self._result_timeout()

        def events():
            for kind, val in req.events(timeout=timeout):
                if kind == "token":
                    yield {"token": val,
                           "segment": tokenizer.detokenize([val])}
                elif kind == "done":
                    yield {"done": True, "finish_reason": val,
                           "text": tokenizer.detokenize(req.tokens),
                           "tokens": req.tokens}
                else:   # "error"
                    yield {"done": True, "finish_reason": "error",
                           "message": str(val)}

        return 200, {}, events()


class MegatronServer:
    """Stdlib HTTP server in front of the model: through ``engine`` when
    one is given, else the legacy path alone."""

    def __init__(self, model, params, tokenizer, int8_kv_cache=False,
                 engine=None, log_requests=False, max_prompts=None,
                 max_tokens=None, drain_timeout_secs: float = 600.0):
        self.generator = MegatronGenerate(
            model, params, tokenizer, int8_kv_cache=int8_kv_cache,
            engine=engine, log_requests=log_requests,
            max_prompts=max_prompts, max_tokens=max_tokens)
        self.engine = engine
        self.metrics = ServerMetrics()
        if engine is not None:
            self.metrics.engine_stats_fn = engine.stats
            self.metrics.kernel_launches_fn = engine.kernel_launch_snapshot
            # every retired request feeds the SLO histograms
            engine.request_done_hook = self.metrics.observe_request_done
        # graceful drain (SIGTERM / /drain): admission answers 503,
        # /health reports "draining", in-flight work finishes, then the
        # server stops and run() returns
        self.draining = False
        self.drain_timeout_secs = float(drain_timeout_secs)
        self._drain_lock = threading.Lock()
        self._in_flight = 0
        self._in_flight_lock = threading.Lock()
        self.httpd = None
        self._serving = False

    def _track(self, delta: int) -> None:
        with self._in_flight_lock:
            self._in_flight += delta

    def begin_drain(self, reason: str = "signal") -> bool:
        """Flip into draining mode and hand off to the waiter thread.
        The first call wins, later ones return False.  Safe to call from
        a signal handler (nothing here blocks)."""
        with self._drain_lock:
            if self.draining:
                return False
            self.draining = True
        self.metrics.note_drained()
        try:
            stream = telemetry.get_stream()
            if stream is not None:
                stream.emit({"kind": "serve", "event": "drain",
                             "reason": reason})
        except Exception:   # noqa: BLE001 - drain goes on regardless
            pass
        print(f" * draining ({reason}): admission closed, finishing "
              f"in-flight work", flush=True)
        threading.Thread(target=self._drain_and_exit, name="drain-waiter",
                         daemon=True).start()
        return True

    def _drain_and_exit(self) -> None:
        engine = self.engine
        deadline = time.monotonic() + self.drain_timeout_secs
        while time.monotonic() < deadline:
            with self._in_flight_lock:
                busy = self._in_flight > 0
            if engine is not None and not busy:
                busy = engine.scheduler.has_work()
            if not busy:
                break
            time.sleep(0.05)
        if engine is not None:
            try:
                engine.stop()
            except Exception:   # noqa: BLE001 - the server stops regardless
                pass
        if self.httpd is not None and self._serving:
            self.httpd.shutdown()   # run() returns; the process exits

    def make_httpd(self, host: str = "0.0.0.0",
                   port: int = 5000) -> ThreadingHTTPServer:
        """Bind the server (port 0 picks a free port; read it from
        ``httpd.server_address``) without serving yet."""
        generator = self.generator
        metrics = self.metrics
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def _send_json(self, code: int, body: dict, trace_id=None):
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                if trace_id:
                    self.send_header(TRACE_HEADER, trace_id)
                if code == 429 or (code == 503
                                   and "retry_after_secs" in body):
                    self.send_header("Retry-After", str(max(int(
                        body.get("retry_after_secs", 1)), 1)))
                self.end_headers()
                self.wfile.write(data)

            def _reject_draining(self, trace_id=None) -> bool:
                if not outer.draining:
                    return False
                self._send_json(503, {
                    "message": "server draining; retry another replica",
                    "draining": True,
                    "retry_after_secs": 1}, trace_id=trace_id)
                return True

            def _read_payload(self):
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n) or b"{}")

            def do_PUT(self):
                if self.path == "/drain":
                    started = outer.begin_drain("http")
                    self._send_json(200, {"status": "draining",
                                          "started": bool(started)})
                    return
                if self.path in ("/api/stream", "/generate/stream"):
                    self._do_stream()
                    return
                if self.path not in ("/api", "/generate"):
                    self.send_error(404)
                    return
                t0 = time.perf_counter()
                trace_id = self.headers.get(TRACE_HEADER) or new_trace_id()
                if self._reject_draining(trace_id=trace_id):
                    metrics.observe(time.perf_counter() - t0, 503)
                    return
                try:
                    payload = self._read_payload()
                except ValueError:      # bad length or JSON
                    metrics.observe(time.perf_counter() - t0, 400)
                    self.send_error(400, "invalid JSON")
                    return
                outer._track(+1)
                try:
                    code, body = generator.handle(payload,
                                                  trace_id=trace_id)
                finally:
                    outer._track(-1)
                metrics.observe(time.perf_counter() - t0, code,
                                tokens=(_count_tokens(body)
                                        if code == 200 else 0))
                self._send_json(code, body, trace_id=trace_id)

            def _do_stream(self):
                t0 = time.perf_counter()
                trace_id = self.headers.get(TRACE_HEADER) or new_trace_id()
                if self._reject_draining(trace_id=trace_id):
                    metrics.observe(time.perf_counter() - t0, 503)
                    return
                try:
                    payload = self._read_payload()
                except ValueError:
                    metrics.observe(time.perf_counter() - t0, 400)
                    self.send_error(400, "invalid JSON")
                    return
                code, body, events = generator.handle_stream(
                    payload, trace_id=trace_id)
                if events is None:
                    metrics.observe(time.perf_counter() - t0, code)
                    self._send_json(code, body, trace_id=trace_id)
                    return
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.send_header(TRACE_HEADER, trace_id)
                self.end_headers()
                n_tokens = 0
                outer._track(+1)
                try:
                    for ev in events:
                        if "token" in ev:
                            n_tokens += 1
                        self.wfile.write(b"data: "
                                         + json.dumps(ev).encode()
                                         + b"\n\n")
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    pass        # the client went away mid-stream
                finally:
                    outer._track(-1)
                metrics.observe(time.perf_counter() - t0, 200,
                                tokens=n_tokens, streamed=True)

            do_POST = do_PUT

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    page = os.path.join(os.path.dirname(
                        os.path.abspath(__file__)), "static", "index.html")
                    try:
                        with open(page, "rb") as f:
                            data = f.read()
                    except OSError:
                        self.send_error(404)
                        return
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif self.path == "/health":
                    # stays 200 while draining: the replica is healthy,
                    # just finishing up
                    self._send_json(200, {
                        "status": "draining" if outer.draining else "ok",
                        "uptime_secs": time.time() - metrics.started_unix})
                elif self.path == "/metrics" \
                        or self.path.startswith("/metrics?"):
                    snap = metrics.snapshot()
                    if _wants_prometheus(self.path,
                                         self.headers.get("Accept", "")):
                        data = prometheus_exposition(snap).encode()
                        self.send_response(200)
                        self.send_header(
                            "Content-Type",
                            "text/plain; version=0.0.4; charset=utf-8")
                        self.send_header("Content-Length", str(len(data)))
                        self.end_headers()
                        self.wfile.write(data)
                    else:
                        self._send_json(200, snap)
                else:
                    self.send_error(404)

            def log_message(self, fmt, *args):
                pass

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        return self.httpd

    def run(self, host: str = "0.0.0.0", port: int = 5000) -> None:
        httpd = self.httpd or self.make_httpd(host, port)
        # SIGTERM -> graceful drain; handlers install only from the main
        # thread (a server run on a worker thread drains by /drain)
        if threading.current_thread() is threading.main_thread():
            try:
                signal.signal(signal.SIGTERM,
                              lambda *_: self.begin_drain("SIGTERM"))
            except (ValueError, OSError):
                pass
        print(f" * serving on http://{host}:{httpd.server_address[1]}/ "
              f"(demo page) and /api", flush=True)
        if port == 0:
            # the replica handshake: one write and one flush, so the line
            # reaches the supervisor's reader whole
            sys.stdout.write(f"PORT {httpd.server_address[1]}\n")
            sys.stdout.flush()
        self._serving = True
        httpd.serve_forever()

    def shutdown(self) -> None:
        """Stop serving, close the socket and stop the SLO sentinel (the
        engine is the caller's to stop)."""
        alerts = self.metrics.alert_engine
        if alerts is not None:
            alerts.stop()
        if self.httpd is not None:
            if self._serving:
                self.httpd.shutdown()   # returns once serve_forever has
            self.httpd.server_close()


def build_server_alerts(server, engine=None, structured_log_dir=None,
                        alert_rules=None, alert_webhook=None,
                        clock=None, start=True):
    """Wire the SLO sentinel (``serving/alerts.py``) to a server: rules
    from ``--alert_rules`` (the built-in defaults otherwise), metrics from
    the server's own ``/metrics`` snapshot, ``alert_transition`` records
    on the JSONL stream, and postmortem bundles under
    ``<structured_log_dir>/incidents/<rule>-<seq>`` when a rule fires.
    Returns the (started) ``AlertEngine``, or None when the rules do not
    parse: the server keeps serving with a bad ``--alert_rules``."""
    from megatron_llm_torch.serving.alerts import AlertEngine, parse_rules_arg

    rules, opts = None, {}
    if alert_rules:
        try:
            rules, opts = parse_rules_arg(alert_rules)
        except (ValueError, OSError) as exc:
            print(f" * --alert_rules rejected ({exc}); alerting disabled",
                  flush=True)
            return None

    metrics = server.metrics

    def sink(payload: dict) -> None:
        stream = telemetry.get_stream()
        if stream is not None:
            # replica transitions are kind="serve"
            stream.emit({"kind": "serve", **payload})

    bundle_fn = None
    if structured_log_dir:
        incidents_dir = os.path.join(structured_log_dir, "incidents")
        max_bundles = int(opts.get("max_bundles", 8))
        seq = [0]

        def bundle_fn(transition: dict):
            # each part is captured on its own, best effort: a failing
            # capture must not lose the others
            parts: dict = {"transition": dict(transition)}
            try:
                parts["metrics"] = metrics.snapshot()
            except Exception as exc:    # noqa: BLE001 - forensics
                parts["metrics"] = {"error": str(exc)}
            try:
                parts["recent_requests"] = metrics.recent_request_done()
            except Exception as exc:    # noqa: BLE001 - forensics
                parts["recent_requests"] = {"error": str(exc)}
            try:
                parts["thread_stacks"] = telemetry.capture_thread_stacks()
            except Exception as exc:    # noqa: BLE001 - forensics
                parts["thread_stacks"] = f"capture failed: {exc}"
            if engine is not None:
                try:
                    parts["loop_ring"] = engine.loop_profiler.ring_records()
                except Exception as exc:    # noqa: BLE001 - forensics
                    parts["loop_ring"] = {"error": str(exc)}
                try:
                    parts["cache"] = engine.cache_observatory.stats()
                except Exception as exc:    # noqa: BLE001 - forensics
                    parts["cache"] = {"error": str(exc)}
            try:
                rec = telemetry.get_flight_recorder()
                if rec is not None:
                    parts["flight_recorder"] = rec.records()
            except Exception as exc:    # noqa: BLE001 - forensics
                parts["flight_recorder"] = {"error": str(exc)}
            trace_path = _tracing.dump_trace(
                reason=f"alert:{transition.get('rule')}")
            if trace_path:
                parts["trace"] = {"chrome_trace_path": trace_path}
            seq[0] += 1
            dest = os.path.join(
                incidents_dir, f"{transition.get('rule')}-{seq[0]:04d}")
            path = telemetry.write_snapshot_bundle(
                dest, parts,
                manifest_extra={"rule": transition.get("rule"),
                                "scope": transition.get("scope"),
                                "severity": transition.get("severity")})
            _prune_incident_bundles(incidents_dir, max_bundles)
            return path

    eng = AlertEngine(
        rules=rules,
        metrics_fn=metrics.snapshot,
        scope="replica",
        interval_secs=float(opts.get("interval_secs", 2.0)),
        transition_sink=sink,
        bundle_fn=bundle_fn,
        webhook_url=alert_webhook,
        max_firing=int(opts.get("max_firing", 10)),
        **({"clock": clock} if clock is not None else {}),
    )
    metrics.alert_engine = eng
    if start:
        eng.start()
    return eng


def _prune_incident_bundles(incidents_dir: str, keep: int) -> None:
    """Cap the incidents directory at ``keep`` bundles, oldest first."""
    import shutil
    try:
        names = [n for n in os.listdir(incidents_dir)
                 if os.path.isdir(os.path.join(incidents_dir, n))]
    except OSError:
        return
    if len(names) <= keep:
        return
    names.sort(key=lambda n: os.path.getmtime(
        os.path.join(incidents_dir, n)))
    for n in names[:len(names) - keep]:
        shutil.rmtree(os.path.join(incidents_dir, n), ignore_errors=True)
