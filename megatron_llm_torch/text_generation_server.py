"""REST text-generation server over the continuous-batching engine.

The engine path of ``megatron_llm_tpu/text_generation_server.py`` with
the same contract: ``PUT /api`` (request validation, JSON 400s, 429 with
``Retry-After`` when the engine queue is full, ``{"text", "segments",
"tokens"}`` bodies), ``GET /health`` and ``GET /metrics`` (JSON, with
the engine's ``stats()`` under ``"engine"`` and the mergeable SLO
histograms).  Beam search, logprobs and ``tokens_to_generate == 0`` need
the JAX package's batch generate path and answer 400 here; streaming,
graceful drain, Prometheus text and the SLO alerts are later slices.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from megatron_llm_torch.serving.request import (
    EngineError,
    QueueFull,
    SamplingParams,
)
from megatron_llm_torch.telemetry import Histogram, histogram_percentile
from megatron_llm_torch.text_generation.api import resolve_stop_rules
from megatron_llm_torch.tracing import new_trace_id

MAX_PROMPTS = 128       # defaults; override with --serve_max_prompts /
MAX_TOKENS = 1024       # --serve_max_tokens

TRACE_HEADER = "X-Request-Trace"


class ServerMetrics:
    """Request/error counts, p50/p95 latency over a bounded window,
    tokens generated, and the SLO histograms fed by the engine's
    request_done hook.  Thread-safe."""

    def __init__(self, window: int = 512):
        self._lock = threading.Lock()
        self._window = max(int(window), 1)
        self._latencies = []
        self.started_unix = time.time()
        self.requests = 0
        self.errors = 0
        self.throttled = 0
        self.streamed = 0
        self.drained = 0
        self.tokens_generated = 0
        self.engine_stats_fn = None
        self.histograms = {
            "ttft_secs": Histogram(),
            "tpot_secs": Histogram(),
            "e2e_secs": Histogram(),
            "queue_wait_secs": Histogram(),
        }

    def observe_request_done(self, record: dict) -> None:
        """Engine ``request_done_hook``: fold one finished request into
        the SLO histograms."""
        with self._lock:
            self.histograms["ttft_secs"].observe(record.get("ttft_secs"))
            self.histograms["tpot_secs"].observe(record.get("tpot_secs"))
            self.histograms["e2e_secs"].observe(record.get("latency_secs"))
            phases = record.get("phases") or {}
            self.histograms["queue_wait_secs"].observe(
                phases.get("queue_secs"))

    def observe(self, secs: float, status: int, tokens: int = 0) -> None:
        with self._lock:
            self.requests += 1
            if status >= 400:
                self.errors += 1
            if status == 429:
                self.throttled += 1
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
            out["engine"] = fn()
        return out


def _count_tokens(body: dict) -> int:
    toks = body.get("tokens")
    if isinstance(toks, list):
        return sum(len(t) for t in toks if isinstance(t, list))
    return 0


class MegatronGenerate:
    """Request validation + dispatch to the engine."""

    def __init__(self, tokenizer, engine, log_requests=False,
                 max_prompts=None, max_tokens=None):
        self.tokenizer = tokenizer
        self.engine = engine
        self.log_requests = bool(log_requests)
        self.max_prompts = int(max_prompts or MAX_PROMPTS)
        self.max_tokens = int(max_tokens or MAX_TOKENS)

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
        if (knobs["beam_width"] is not None or knobs["logprobs"]
                or knobs["tokens_to_generate"] == 0):
            return 400, {"message": "beam search, logprobs and "
                                    "tokens_to_generate=0 are not served by "
                                    "the PyTorch engine yet"}
        return self._handle_engine(knobs, trace_id=trace_id)

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

    def _submit_engine(self, knobs: dict, trace_id=None):
        """Returns (None, requests) or ((code, body), None)."""
        try:
            token_lists = [self._tokenize(p, knobs["add_BOS"])
                           for p in knobs["prompts"]]
            samplings = [self._sampling_params(knobs, i)
                         for i in range(len(token_lists))]
            reqs = self.engine.submit_many(token_lists, samplings,
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


class MegatronServer:
    """Stdlib HTTP server in front of one engine."""

    def __init__(self, tokenizer, engine, log_requests=False,
                 max_prompts=None, max_tokens=None):
        self.generator = MegatronGenerate(
            tokenizer, engine, log_requests=log_requests,
            max_prompts=max_prompts, max_tokens=max_tokens)
        self.engine = engine
        self.metrics = ServerMetrics()
        self.metrics.engine_stats_fn = engine.stats
        engine.request_done_hook = self.metrics.observe_request_done
        self.httpd = None
        self._serving = False

    def make_httpd(self, host: str = "0.0.0.0",
                   port: int = 5000) -> ThreadingHTTPServer:
        """Bind the server (port 0 picks a free port; read it from
        ``httpd.server_address``) without serving yet."""
        generator = self.generator
        metrics = self.metrics

        class Handler(BaseHTTPRequestHandler):
            def _send_json(self, code: int, body: dict, trace_id=None):
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                if trace_id:
                    self.send_header(TRACE_HEADER, trace_id)
                if code == 429:
                    self.send_header("Retry-After", str(max(int(
                        body.get("retry_after_secs", 1)), 1)))
                self.end_headers()
                self.wfile.write(data)

            def do_PUT(self):
                if self.path not in ("/api", "/generate"):
                    self.send_error(404)
                    return
                t0 = time.perf_counter()
                trace_id = self.headers.get(TRACE_HEADER) or new_trace_id()
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                except ValueError:      # bad length or JSON
                    metrics.observe(time.perf_counter() - t0, 400)
                    self.send_error(400, "invalid JSON")
                    return
                code, body = generator.handle(payload, trace_id=trace_id)
                metrics.observe(time.perf_counter() - t0, code,
                                tokens=(_count_tokens(body)
                                        if code == 200 else 0))
                self._send_json(code, body, trace_id=trace_id)

            do_POST = do_PUT

            def do_GET(self):
                if self.path == "/health":
                    self._send_json(200, {
                        "status": "ok",
                        "uptime_secs": time.time() - metrics.started_unix})
                elif self.path == "/metrics":
                    self._send_json(200, metrics.snapshot())
                else:
                    self.send_error(404)

            def log_message(self, fmt, *args):
                pass

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        return self.httpd

    def run(self, host: str = "0.0.0.0", port: int = 5000) -> None:
        httpd = self.httpd or self.make_httpd(host, port)
        print(f" * serving on http://{host}:{httpd.server_address[1]}/api",
              flush=True)
        self._serving = True
        httpd.serve_forever()

    def shutdown(self) -> None:
        """Stop serving and close the socket (the engine is the caller's
        to stop)."""
        if self.httpd is not None:
            if self._serving:
                self.httpd.shutdown()   # returns once serve_forever has
            self.httpd.server_close()
