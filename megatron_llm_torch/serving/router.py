"""Multi-replica serving router.

A stdlib HTTP front-end over N backend engine processes (each a
``MegatronServer`` started by
``python -m megatron_llm_torch.run_text_generation_server``),
turning single-replica serving into a fleet:

* **Least-loaded dispatch** — keyless requests go to the live backend
  with the fewest in-flight requests (ties broken by lifetime request
  count).
* **Rendezvous (HRW) prefix affinity** — the leading characters of the
  first prompt are folded into the same chained blake2b digest the
  replica-side prefix cache keys its KV pages by (kv_blocks.py), and the
  digest picks a replica by highest-random-weight hashing over the live
  set.  Repeated prefixes (system prompts, chat sessions) return to the
  replica whose BlockManager already holds their pages — and because
  HRW is a pure function of (digest, live URLs), **N routers agree on
  the sticky replica with no shared state**: the front door shards
  horizontally without an affinity gossip protocol.  When a replica
  joins or leaves, only ~1/N of keys move.  An LRU caches prefix ->
  digest so the hash chain runs once per distinct prefix (warm path).
  Affinity is a routing *preference*, not a pin: a dead or throttled
  sticky backend falls over to the next replica in HRW order (also
  agreed upon by every router).
* **Peer awareness** — each router can carry a list of sibling-router
  URLs (``set_peers``); any one of them answers fleet-wide ``/metrics``
  by querying its siblings' router-local snapshots and merging
  histograms bucket-wise (percentiles recomputed from merged buckets,
  never summed).  Breaker/load/draining state stays per-router,
  derived independently by each probe thread — eventual agreement, no
  consensus traffic on the dispatch path.
* **Circuit breaking** — K consecutive transport failures mark a replica
  dead for an exponentially growing cooldown (capped); the background
  health thread probes ``/health`` and revives it on first success.
* **Requeue on failure** — a request whose backend dies mid-flight is
  replayed on the next live replica (streams fail over only before the
  first byte reaches the client, so clients never see a spliced stream).
* **429 aggregation** — when every live replica is throttled, the router
  answers 429 with the *most optimistic* backend values (min queue
  depth / retry-after / estimated wait), so well-behaved clients back
  off no longer than necessary.
* **Aggregated `/metrics`** — router counters, per-backend liveness, and
  a numeric sum over the live backends' own metrics snapshots; both JSON
  and Prometheus exposition (reusing the telemetry renderer).

Everything is stdlib (http.client / http.server / threading): the router
deploys anywhere the backends do, with no extra dependencies.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import random
import threading
import time
import uuid
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple
from urllib.parse import parse_qs, urlparse

# request trace header (mirrors text_generation_server.TRACE_HEADER —
# redeclared so the router stays importable with stdlib alone)
TRACE_HEADER = "X-Request-Trace"


def _new_trace_id() -> str:
    """Router-local trace-id mint (same format as tracing.new_trace_id;
    duplicated to keep this module jax-free)."""
    return uuid.uuid4().hex[:16]


class Backend:
    """One replica and its breaker/affinity bookkeeping."""

    def __init__(self, url: str):
        if "//" not in url:
            url = "http://" + url
        p = urlparse(url)
        if not p.hostname or not p.port:
            raise ValueError(f"backend needs host:port, got {url!r}")
        self.url = f"http://{p.hostname}:{p.port}"
        self.host = p.hostname
        self.port = p.port
        self.in_flight = 0
        self.requests = 0           # completed dispatch attempts
        self.failures = 0           # transport failures, lifetime
        self.throttled = 0          # 429s seen, lifetime
        self.consecutive_failures = 0
        self.dead_until = 0.0       # monotonic; breaker cooldown end
        self.dead_marks = 0         # times the breaker tripped
        self.last_health_ok: Optional[float] = None
        # replica answered /health with status "draining": it is ALIVE
        # (no breaker involvement, in-flight streams keep relaying) but
        # must receive no new dispatches until it reports "ok" again
        self.draining = False

    def available(self, fail_threshold: int,
                  now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        if self.consecutive_failures >= fail_threshold \
                and now < self.dead_until:
            return False
        return True

    def snapshot(self, fail_threshold: int) -> Dict[str, object]:
        now = time.monotonic()
        return {
            "url": self.url,
            "alive": int(self.available(fail_threshold, now)),
            "in_flight": self.in_flight,
            "requests": self.requests,
            "failures": self.failures,
            "throttled": self.throttled,
            "consecutive_failures": self.consecutive_failures,
            "cooldown_remaining_secs": round(
                max(self.dead_until - now, 0.0), 3),
            "dead_marks": self.dead_marks,
            "draining": int(self.draining),
        }


class NoBackendAvailable(Exception):
    """Every replica is dead/unreachable (HTTP maps this to 503)."""


class AllBackendsThrottled(Exception):
    """Every live replica answered 429; carries the merged body."""

    def __init__(self, body: Dict[str, object]):
        super().__init__(body.get("message", "all replicas throttled"))
        self.body = body


def _affinity_prefix(body: bytes, max_chars: int) -> Optional[str]:
    """Leading characters of the first prompt — the raw material of the
    sticky key.  Shared prefixes map to the same digest -> same replica
    -> its prefix cache."""
    try:
        prompts = json.loads(body or b"{}").get("prompts")
        if isinstance(prompts, list) and prompts \
                and isinstance(prompts[0], str):
            return prompts[0][:max_chars]
    except (ValueError, AttributeError):
        pass
    return None


# --- prompt-affinity digest -------------------------------------------------
# Structural twin of kv_blocks.digest_link / prompt_affinity_digest, kept
# local so the router imports nothing beyond stdlib (kv_blocks pulls in
# numpy).  tests/test_router_rendezvous.py pins the two byte-identical.

_AFFINITY_CHAR_BLOCK = 64


def _digest_link(prev: bytes, payload: bytes) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(prev)
    h.update(payload)
    return h.digest()


def _prompt_affinity_digest(prompt: str, max_chars: int = 256,
                            char_block: int = _AFFINITY_CHAR_BLOCK) -> str:
    """Chained 128-bit digest over char-blocks of the prompt prefix —
    the same rolling construction BlockManager keys its prefix cache
    with, so router stickiness and replica cache locality stay aligned
    by construction.  Hex output: stable across processes and hosts."""
    prefix = prompt[:max_chars]
    prev = b""
    for i in range(0, max(len(prefix), 1), char_block):
        prev = _digest_link(prev, prefix[i:i + char_block].encode("utf-8"))
    return prev.hex()


def rendezvous_order(digest_hex: str, urls: Sequence[str]) -> List[str]:
    """Highest-random-weight order of ``urls`` for one affinity digest.

    Every router computes this identically from (digest, URL) alone —
    no shared state, no coordination — so N routers send a given prefix
    to the same replica AND agree on the failover order.  Removing a URL
    leaves the relative order of the rest untouched (the HRW property:
    only the removed replica's keys move, ~1/N of the keyspace)."""
    raw = bytes.fromhex(digest_hex)

    def score(url: str) -> Tuple[int, str]:
        h = hashlib.blake2b(digest_size=8)
        h.update(raw)
        h.update(url.encode("utf-8"))
        return int.from_bytes(h.digest(), "big"), url

    return sorted(urls, key=score, reverse=True)


# Twin of telemetry.DEFAULT_LATENCY_BUCKETS / Histogram (non-cumulative
# per-bucket counts keyed by format(bound, "g") + "+Inf"), so the
# router-side dispatch-latency histogram merges bucket-wise with the
# replica histograms under _sum_numeric and telemetry.histogram_percentile
# reads it unchanged.
_LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                    0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)
_INF_LABEL = "+Inf"


class _Hist:
    """Stdlib histogram with a telemetry-compatible snapshot shape."""

    def __init__(self, bounds: Sequence[float] = _LATENCY_BUCKETS):
        self.bounds = tuple(float(b) for b in bounds)
        self.labels = [format(b, "g") for b in self.bounds] + [_INF_LABEL]
        self.counts = [0] * len(self.labels)
        self.count = 0
        self.total = 0.0

    def observe(self, value: float) -> None:
        i = 0
        while i < len(self.bounds) and value > self.bounds[i]:
            i += 1
        self.counts[i] += 1
        self.count += 1
        self.total += value

    def snapshot(self) -> Dict[str, object]:
        return {"count": self.count, "sum": self.total,
                "buckets": dict(zip(self.labels, self.counts))}


def _histogram_percentile(snap: Optional[dict], q: float
                          ) -> Optional[float]:
    """Structural twin of telemetry.histogram_percentile (linear
    interpolation in the winning bucket, +Inf answers its lower edge),
    redeclared — like supervisor.py's copy — so stdlib-only deployments
    still get recomputed (never summed) fleet percentiles."""
    if not _is_histogram(snap):
        return None
    total = snap.get("count") or 0
    if total <= 0:
        return None
    items = []
    for k, v in snap["buckets"].items():
        try:
            bound = float(k)
        except ValueError:
            bound = float("inf")
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


def _sum_numeric(dst: Dict[str, object], src: Dict[str, object]) -> None:
    """Recursively sum numeric leaves of src into dst (metric dicts from
    different replicas share a schema)."""
    for k, v in src.items():
        if isinstance(v, bool):
            continue
        if isinstance(v, (int, float)):
            cur = dst.get(k, 0)
            if isinstance(cur, (int, float)) and not isinstance(cur, bool):
                dst[k] = cur + v
        elif isinstance(v, dict):
            sub = dst.setdefault(k, {})
            if isinstance(sub, dict):
                _sum_numeric(sub, v)


def _collect_non_numeric(dst: Dict[str, Dict[str, object]],
                         src: Dict[str, object], replica: str,
                         path: str = "") -> None:
    """Collect non-numeric leaves (e.g. ``engine.paged_kernel:
    "pallas"``) as a dotted-path -> {replica: value} map.  These can't
    be summed, but a fleet where one replica runs the XLA fallback is
    exactly the situation the aggregated /metrics must surface instead
    of silently dropping."""
    for k, v in src.items():
        dotted = f"{path}{k}"
        if isinstance(v, dict):
            _collect_non_numeric(dst, v, replica, path=f"{dotted}.")
        elif isinstance(v, str):
            dst.setdefault(dotted, {})[replica] = v


def _is_histogram(d: object) -> bool:
    """Structural twin of telemetry.is_histogram_snapshot, kept local so
    the router imports nothing beyond stdlib."""
    return (isinstance(d, dict) and "count" in d and "sum" in d
            and isinstance(d.get("buckets"), dict))


def _numeric_only(d: Dict[str, object]) -> Dict[str, object]:
    """Drop non-numeric leaves (URLs etc.) so the dict is safe for the
    Prometheus text renderer."""
    out: Dict[str, object] = {}
    for k, v in d.items():
        if isinstance(v, bool):
            out[k] = int(v)
        elif isinstance(v, (int, float)):
            out[k] = v
        elif isinstance(v, dict):
            out[k] = _numeric_only(v)
    return out


class ReplicaRouter:
    """Routing core, independent of the HTTP front-end (unit-testable
    against stub backends)."""

    # lint-enforced (graft-lint locks/LD002): the HTTP worker threads,
    # the relay generators, the health prober, the peer gossip paths and
    # the fleet supervisor all touch these; every mutation must hold
    # self._lock
    _lock_protected_ = (
        "requests_total", "failovers_total", "mid_stream_failures_total",
        "throttled_total", "no_backend_total", "affinity_hits",
        "_affinity", "backends", "_brownout_until", "brownout_429s_total",
        "peers", "_fleet_stats_data", "_dispatch_hist", "_peer_cache",
    )

    def __init__(self, backend_urls: Sequence[str],
                 fail_threshold: int = 3,
                 cooldown_secs: float = 1.0,
                 max_cooldown_secs: float = 30.0,
                 affinity_chars: int = 256,
                 affinity_max: int = 4096,
                 health_interval_secs: float = 2.0,
                 request_timeout_secs: float = 600.0,
                 router_id: Optional[str] = None,
                 tracer=None):
        # an empty initial list is legal: a fleet supervisor registers
        # replicas at runtime via add_backend (tools/serve_router.py
        # still requires --backends for the static-fleet deployment)
        self.backends = [Backend(u) for u in backend_urls]
        # duck-typed span recorder (tracing.SpanTracer when the process
        # runs with --trace_dir; anything with completed()/instant()):
        # injected rather than imported so the router stays stdlib-pure
        self.tracer = tracer
        self.fail_threshold = int(fail_threshold)
        self.cooldown_secs = float(cooldown_secs)
        self.max_cooldown_secs = float(max_cooldown_secs)
        self.affinity_chars = int(affinity_chars)
        self.affinity_max = int(affinity_max)
        self.health_interval_secs = float(health_interval_secs)
        self.request_timeout_secs = float(request_timeout_secs)
        # stable identity in fleet events / peer-merged metrics; routers
        # are stateless, so the id is purely observational
        self.router_id = router_id or f"router-{_new_trace_id()[:8]}"
        # warm-path LRU: prompt prefix -> affinity digest hex (the chain
        # runs once per distinct prefix; routing itself derives from the
        # digest, so the cache is an optimization, never the truth)
        self._affinity: "OrderedDict[str, str]" = OrderedDict()
        # sibling-router URLs (never containing this router) for the
        # peer-merged fleet /metrics view
        self.peers: List[str] = []
        # last good one-hop snapshot per peer URL -> (snapshot, scraped
        # monotonic): a transient scrape failure serves the cached view
        # with its age visible (router_tier.last_scrape_age_secs)
        # instead of silently dropping the peer from the merge
        self._peer_cache: Dict[str, Tuple[Dict[str, object], float]] = {}
        self._lock = threading.Lock()
        self.requests_total = 0
        self.failovers_total = 0
        self.mid_stream_failures_total = 0
        self.throttled_total = 0
        self.no_backend_total = 0
        self.affinity_hits = 0
        # brownout: while a scale-up is in flight and every replica is
        # throttled, 429s carry an honest retry_after derived from the
        # spawn ETA instead of the replicas' (saturated) own estimates
        self._brownout_until = 0.0      # monotonic; 0 = inactive
        self.brownout_429s_total = 0
        # optional supervisor stats hook: a callable returning a dict
        # merged into snapshot()["fleet"], so supervisor counters ride
        # the router's /metrics (JSON and Prometheus) for free
        self._fleet_stats_fn = None
        # out-of-process variant: a supervisor running elsewhere pushes
        # its stats dict via POST /admin/fleet_stats instead of a hook
        self._fleet_stats_data: Optional[Dict[str, object]] = None
        # dispatch-loop latency (request arrival -> response headers /
        # first stream byte): the front-door saturation signal the
        # supervisor scales the router tier on
        self._dispatch_hist = _Hist()
        self._health_thread: Optional[threading.Thread] = None
        self._health_stop = threading.Event()

    # -- dynamic membership ---------------------------------------------

    def add_backend(self, url: str) -> Backend:
        """Register a replica at runtime (fleet supervisor scale-up /
        respawn).  Idempotent on URL: re-adding an existing address
        returns the live Backend untouched (its breaker state is the
        truth about that address)."""
        nb = Backend(url)
        with self._lock:
            for b in self.backends:
                if b.url == nb.url:
                    return b
            self.backends.append(nb)
        return nb

    def remove_backend(self, url: str) -> bool:
        """Deregister a replica (scale-down after drain, or a dead
        process reaped by the supervisor).  In-flight relays holding the
        Backend object finish against it harmlessly; sticky keys remap
        by themselves — rendezvous hashing over the remaining URLs never
        resurrects a removed address, and only the removed replica's
        share (~1/N) of keys moves.  Returns False when the URL is
        unknown."""
        nb = Backend(url)
        with self._lock:
            victim = None
            for b in self.backends:
                if b.url == nb.url:
                    victim = b
                    break
            if victim is None:
                return False
            self.backends.remove(victim)
        return True

    def backends_list(self) -> List[Backend]:
        """Membership snapshot: iterate this, never self.backends, from
        probe/metrics paths — add/remove may reshape the list mid-walk."""
        with self._lock:
            return list(self.backends)

    # -- peer awareness -------------------------------------------------

    def set_peers(self, urls: Sequence[str]) -> List[str]:
        """Replace the sibling-router list (supervisor rebroadcasts it
        whenever the tier reshapes).  URLs are normalized the same way
        backend URLs are, so comparisons are canonical."""
        normalized = []
        for u in urls:
            if u and u.strip():
                normalized.append(Backend(u.strip()).url)
        with self._lock:
            self.peers = normalized
        return normalized

    def peers_list(self) -> List[str]:
        with self._lock:
            return list(self.peers)

    # -- brownout --------------------------------------------------------

    def begin_brownout(self, eta_secs: float) -> None:
        """Enter brownout until ``eta_secs`` from now (the supervisor's
        spawn ETA).  Extends, never shortens, an active brownout."""
        until = time.monotonic() + max(float(eta_secs), 0.0)
        with self._lock:
            self._brownout_until = max(self._brownout_until, until)

    def end_brownout(self) -> None:
        """Leave brownout (the spawned replica registered, or the spawn
        was abandoned)."""
        with self._lock:
            self._brownout_until = 0.0

    def brownout_remaining(self) -> float:
        with self._lock:
            return max(self._brownout_until - time.monotonic(), 0.0)

    def set_fleet_stats(self, fn) -> None:
        """Attach a supervisor stats callable (() -> dict); its counters
        appear under ``snapshot()["fleet"]`` on /metrics."""
        self._fleet_stats_fn = fn

    def set_fleet_stats_data(self, data: Optional[Dict[str, object]]
                             ) -> None:
        """Out-of-process variant of ``set_fleet_stats``: a supervisor
        running in another process pushes its stats dict here (POST
        /admin/fleet_stats) so this router's /metrics still carries the
        fleet block.  The in-process hook, when set, wins."""
        with self._lock:
            self._fleet_stats_data = dict(data) if data else None

    # -- candidate selection --------------------------------------------

    def _affinity_digest(self, body: Optional[bytes]) -> Optional[str]:
        """Affinity digest of a request body, through the warm-path LRU
        (prefix -> digest; the chain runs once per distinct prefix).
        ``affinity_hits`` counts cache hits — i.e. repeated prefixes —
        which is what makes affinity-hit parity comparable across
        independently-running routers."""
        prefix = _affinity_prefix(body or b"", self.affinity_chars)
        if prefix is None:
            return None
        with self._lock:
            cached = self._affinity.get(prefix)
            if cached is not None:
                self.affinity_hits += 1
                self._affinity.move_to_end(prefix)
                return cached
        digest = _prompt_affinity_digest(prefix, self.affinity_chars)
        with self._lock:
            self._affinity[prefix] = digest
            self._affinity.move_to_end(prefix)
            while len(self._affinity) > self.affinity_max:
                self._affinity.popitem(last=False)
        return digest

    def _candidates(self, digest: Optional[str]) -> List[Backend]:
        """Live backends in dispatch order.  Keyed requests follow the
        rendezvous order of the affinity digest — a pure function of
        (digest, live URLs), so every router in the tier independently
        agrees on both the sticky replica and the failover sequence.
        Keyless requests stay least-loaded.  Draining replicas are alive
        but excluded — they are finishing their in-flight work on the
        way to a clean exit."""
        now = time.monotonic()
        with self._lock:
            live = [b for b in self.backends
                    if b.available(self.fail_threshold, now)
                    and not b.draining]
            if digest is not None and live:
                order = {u: i for i, u in enumerate(
                    rendezvous_order(digest, [b.url for b in live]))}
                live.sort(key=lambda b: order[b.url])
            else:
                live.sort(key=lambda b: (b.in_flight, b.requests))
        return live

    # -- breaker --------------------------------------------------------

    def _record_failure(self, b: Backend) -> None:
        with self._lock:
            b.failures += 1
            b.consecutive_failures += 1
            if b.consecutive_failures >= self.fail_threshold:
                cooldown = min(
                    self.cooldown_secs * (2 ** b.dead_marks),
                    self.max_cooldown_secs)
                b.dead_until = time.monotonic() + cooldown
                b.dead_marks += 1

    def _record_success(self, b: Backend) -> None:
        with self._lock:
            b.consecutive_failures = 0
            b.dead_until = 0.0
            b.dead_marks = 0

    # -- backend IO -----------------------------------------------------

    def _open(self, b: Backend, method: str, path: str,
              body: Optional[bytes],
              timeout: Optional[float] = None,
              trace_id: Optional[str] = None) -> http.client.HTTPConnection:
        conn = http.client.HTTPConnection(
            b.host, b.port,
            timeout=self.request_timeout_secs if timeout is None
            else timeout)
        headers = {"Content-Type": "application/json"} if body else {}
        if trace_id:
            headers[TRACE_HEADER] = trace_id
        conn.request(method, path, body=body, headers=headers)
        return conn

    # -- dispatch -------------------------------------------------------

    def dispatch(self, method: str, path: str, body: Optional[bytes],
                 trace_id: Optional[str] = None
                 ) -> Tuple[int, Dict[str, str], bytes]:
        """Route one buffered (non-streaming) request.  Transport
        failures fail over to the next live replica; 429s collect and
        merge.  Raises ``NoBackendAvailable`` / ``AllBackendsThrottled``.

        The trace id is minted *before* the candidate loop, so a request
        replayed on another replica after a failover keeps one identity
        across the fleet."""
        if trace_id is None:
            trace_id = _new_trace_id()
        t_route = time.perf_counter()
        attempts = 0
        digest = self._affinity_digest(body) \
            if method in ("PUT", "POST") else None
        cands = self._candidates(digest)
        throttle_bodies: List[dict] = []
        for b in cands:
            attempts += 1
            with self._lock:
                b.in_flight += 1
            conn = None
            try:
                conn = self._open(b, method, path, body,
                                  trace_id=trace_id)
                resp = conn.getresponse()
                data = resp.read()
                headers = dict(resp.getheaders())
                status = resp.status
            except (OSError, http.client.HTTPException):
                # replica unreachable or died mid-flight: requeue the
                # request on the next live replica
                self._record_failure(b)
                if conn is not None:
                    conn.close()
                with self._lock:
                    b.in_flight -= 1
                    self.failovers_total += 1
                if self.tracer is not None:
                    self.tracer.instant("failover", "serve",
                                        trace=trace_id, backend=b.url)
                continue
            conn.close()
            with self._lock:
                b.in_flight -= 1
                b.requests += 1
                self.requests_total += 1
            self._record_success(b)     # transport worked -> replica alive
            if status == 429:
                with self._lock:
                    b.throttled += 1
                try:
                    throttle_bodies.append(json.loads(data or b"{}"))
                except ValueError:
                    throttle_bodies.append({})
                continue
            secs = time.perf_counter() - t_route
            with self._lock:
                self._dispatch_hist.observe(secs)
            if self.tracer is not None:
                self.tracer.completed(
                    "route_request", "serve", t_route, secs,
                    trace=trace_id, backend=b.url, status=status,
                    attempts=attempts)
            return status, headers, data
        if throttle_bodies:
            raise AllBackendsThrottled(
                self._throttled_body(throttle_bodies))
        with self._lock:
            self.no_backend_total += 1
        raise NoBackendAvailable(
            f"no live backend ({len(self.backends)} configured)")

    @staticmethod
    def _merge_throttle(bodies: List[dict]) -> Dict[str, object]:
        """Most-optimistic merge across throttled replicas: the client
        should wait only as long as the *least* loaded one asks."""
        def best(field, default):
            vals = [b.get(field) for b in bodies
                    if isinstance(b.get(field), (int, float))]
            return min(vals) if vals else default
        return {
            "message": "all replicas throttled",
            "backends_throttled": len(bodies),
            "retry_after_secs": best("retry_after_secs", 1.0),
            "queue_depth": best("queue_depth", None),
            "estimated_wait_secs": best("estimated_wait_secs", None),
        }

    def _throttled_body(self, bodies: List[dict]) -> Dict[str, object]:
        """Merge throttle bodies, counting the shed; under brownout the
        retry_after is raised to the remaining spawn ETA — the saturated
        replicas' own (optimistic) estimates are dishonest while the
        capacity the client is waiting for is still booting."""
        merged = self._merge_throttle(bodies)
        now = time.monotonic()
        with self._lock:
            self.throttled_total += 1
            remaining = self._brownout_until - now
            if remaining > 0:
                self.brownout_429s_total += 1
        if remaining > 0:
            merged["brownout"] = True
            merged["retry_after_secs"] = max(
                float(merged.get("retry_after_secs") or 0.0),
                round(remaining, 3), 0.1)
        return merged

    def dispatch_stream(self, method: str, path: str, body: Optional[bytes],
                        trace_id: Optional[str] = None
                        ) -> Tuple[int, Dict[str, str], Iterator[bytes]]:
        """Route a streaming (SSE) request.  Fails over while no byte has
        been forwarded; once the response starts, a mid-stream death
        surfaces to the client (the engine has already consumed the
        request's sampling state, so a silent replay could diverge).
        As in ``dispatch``, the trace id predates the candidate loop —
        a pre-first-byte failover replays under the same id."""
        if trace_id is None:
            trace_id = _new_trace_id()
        t_route = time.perf_counter()
        attempts = 0
        digest = self._affinity_digest(body)
        cands = self._candidates(digest)
        throttle_bodies: List[dict] = []
        for b in cands:
            attempts += 1
            with self._lock:
                b.in_flight += 1
            try:
                conn = self._open(b, method, path, body,
                                  trace_id=trace_id)
                resp = conn.getresponse()
            except (OSError, http.client.HTTPException):
                self._record_failure(b)
                with self._lock:
                    b.in_flight -= 1
                    self.failovers_total += 1
                if self.tracer is not None:
                    self.tracer.instant("failover", "serve",
                                        trace=trace_id, backend=b.url)
                continue
            self._record_success(b)
            if resp.status == 429:
                data = resp.read()
                conn.close()
                with self._lock:
                    b.in_flight -= 1
                    b.requests += 1
                    b.throttled += 1
                    self.requests_total += 1
                try:
                    throttle_bodies.append(json.loads(data or b"{}"))
                except ValueError:
                    throttle_bodies.append({})
                continue
            headers = dict(resp.getheaders())
            # headers are out: first-byte latency is the router's
            # dispatch cost for a stream (the relay itself is replica
            # decode time, not front-door saturation)
            with self._lock:
                self._dispatch_hist.observe(
                    time.perf_counter() - t_route)
            tracer = self.tracer
            n_attempts = attempts

            def relay(resp=resp, conn=conn, b=b) -> Iterator[bytes]:
                try:
                    while True:
                        try:
                            # read1: what the replica has sent, at most
                            # 1 KiB.  read(1024) would wait for a full
                            # KiB (about 20 SSE events) or EOF, so tokens
                            # would reach the client in bursts
                            chunk = resp.read1(1024)
                        except (OSError, http.client.HTTPException) as e:
                            # replica died after the first byte: too late
                            # to fail over (a replay could diverge), so
                            # flush whatever made it out of the replica,
                            # then close the stream with a well-formed SSE
                            # error event and let the breaker see it
                            partial = getattr(e, "partial", b"")
                            if partial:
                                yield partial
                            self._record_failure(b)
                            with self._lock:
                                self.mid_stream_failures_total += 1
                            if tracer is not None:
                                tracer.instant(
                                    "mid_stream_failure", "serve",
                                    trace=trace_id, backend=b.url)
                            payload = json.dumps({
                                "message": "replica died mid-stream",
                                "backend": b.url,
                                "trace_id": trace_id})
                            yield ("event: error\ndata: "
                                   + payload + "\n\n").encode()
                            break
                        if not chunk:
                            break
                        yield chunk
                finally:
                    conn.close()
                    with self._lock:
                        b.in_flight -= 1
                        b.requests += 1
                        self.requests_total += 1
                    if tracer is not None:
                        # the routed span closes when the stream drains:
                        # it covers the whole relay, not just connect
                        tracer.completed(
                            "route_stream", "serve", t_route,
                            time.perf_counter() - t_route, trace=trace_id,
                            backend=b.url, attempts=n_attempts)

            return resp.status, headers, relay()
        if throttle_bodies:
            raise AllBackendsThrottled(
                self._throttled_body(throttle_bodies))
        with self._lock:
            self.no_backend_total += 1
        raise NoBackendAvailable(
            f"no live backend ({len(self.backends)} configured)")

    # -- health ---------------------------------------------------------

    def probe_once(self) -> int:
        """Probe every backend's /health; returns the live count.  A
        success closes the breaker immediately, a failure counts toward
        it — so replicas revive without waiting for client traffic.

        The body distinguishes *draining* from *dead*: a replica
        answering 200 with ``{"status": "draining"}`` is healthy (no
        breaker count, in-flight streams keep relaying) but is skipped
        for new dispatches until it reports ``"ok"`` again."""
        alive = 0
        for b in self.backends_list():
            status_field = None
            try:
                conn = self._open(b, "GET", "/health", None,
                                  timeout=min(self.request_timeout_secs,
                                              5.0))
                resp = conn.getresponse()
                raw = resp.read()
                ok = resp.status == 200
                conn.close()
                if ok:
                    try:
                        status_field = json.loads(raw or b"{}").get(
                            "status")
                    except ValueError:
                        status_field = None
            except (OSError, http.client.HTTPException):
                ok = False
            if ok:
                b.last_health_ok = time.monotonic()
                b.draining = status_field == "draining"
                self._record_success(b)
                alive += 1
            else:
                # an unreachable replica is dead, not draining — the
                # breaker owns it from here
                b.draining = False
                self._record_failure(b)
        return alive

    def start_health_thread(self) -> None:
        if self._health_thread is not None:
            return

        def loop():
            # jittered period (±50%): N routers each probe every replica,
            # and identical intervals would lock their probe bursts into
            # a thundering herd hitting all replicas at once — desynced
            # phases spread the load and the detection latency stays
            # health_interval_secs in expectation
            while not self._health_stop.wait(
                    self.health_interval_secs * random.uniform(0.5, 1.5)):
                try:
                    self.probe_once()
                except Exception:   # noqa: BLE001 - probe must survive
                    pass

        self._health_thread = threading.Thread(
            target=loop, name="router-health", daemon=True)
        self._health_thread.start()

    def stop(self) -> None:
        self._health_stop.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=5.0)
            self._health_thread = None

    # -- observability --------------------------------------------------

    def alive_count(self) -> int:
        now = time.monotonic()
        with self._lock:
            return sum(b.available(self.fail_threshold, now)
                       for b in self.backends)

    def affinity_counts(self) -> Dict[str, int]:
        """Sticky keys per backend URL — the supervisor's coldness
        signal (fewest entries = coldest, cheapest to drain).  Derived,
        not stored: each warm digest is assigned to its current
        rendezvous winner among the live backends, so the counts track
        membership changes the way real dispatches would."""
        now = time.monotonic()
        with self._lock:
            counts: Dict[str, int] = {b.url: 0 for b in self.backends}
            live = [b.url for b in self.backends
                    if b.available(self.fail_threshold, now)
                    and not b.draining]
            for digest in self._affinity.values():
                if not live:
                    break
                counts[rendezvous_order(digest, live)[0]] += 1
        return counts

    def snapshot(self) -> Dict[str, object]:
        backends = self.backends_list()
        counts = self.affinity_counts()
        with self._lock:
            affinity_entries = len(self._affinity)
            brownout_remaining = max(
                self._brownout_until - time.monotonic(), 0.0)
            dispatch_hist = self._dispatch_hist.snapshot()
            peers_total = len(self.peers)
        snap = {
            "router_id": self.router_id,
            "peers_total": peers_total,
            "backends_total": len(backends),
            "backends_alive": self.alive_count(),
            "backends_draining": sum(int(b.draining) for b in backends),
            "requests_total": self.requests_total,
            "failovers_total": self.failovers_total,
            "mid_stream_failures_total": self.mid_stream_failures_total,
            "throttled_total": self.throttled_total,
            "no_backend_total": self.no_backend_total,
            "affinity_hits": self.affinity_hits,
            "affinity_entries": affinity_entries,
            "brownout_active": int(brownout_remaining > 0),
            "brownout_remaining_secs": round(brownout_remaining, 3),
            "brownout_429s_total": self.brownout_429s_total,
            "inflight_requests": sum(b.in_flight for b in backends),
            # telemetry-shaped, so a peer merge sums these bucket-wise
            # exactly like replica histograms (and percentiles get
            # recomputed from the merged buckets, never summed)
            "histograms": {"router_dispatch_secs": dispatch_hist},
            "backends": {
                f"backend_{i}": dict(
                    b.snapshot(self.fail_threshold),
                    affinity_entries=counts.get(b.url, 0))
                for i, b in enumerate(backends)},
        }
        fn = self._fleet_stats_fn
        if fn is not None:
            try:
                fleet = fn()
            except Exception:   # noqa: BLE001 - metrics must not 500
                fleet = None
            if isinstance(fleet, dict):
                snap["fleet"] = fleet
        if "fleet" not in snap:
            with self._lock:
                pushed = self._fleet_stats_data
            if isinstance(pushed, dict):
                snap["fleet"] = pushed
        return snap

    def aggregated_metrics(self) -> Dict[str, object]:
        """Router snapshot + per-backend /metrics + a numeric sum over
        the replicas that answered (fleet totals: tokens/sec columns add,
        cache hit counters add, histogram buckets add — which makes the
        summed ``histograms`` the true fleet distributions).  Non-numeric
        leaves land in ``aggregate.per_replica`` as per-replica maps, and
        fleet SLO percentiles are recomputed from the merged buckets
        (percentiles never sum)."""
        per_backend: Dict[str, object] = {}
        aggregate: Dict[str, object] = {}
        per_replica: Dict[str, Dict[str, object]] = {}
        heat_tables: List[object] = []
        alert_blocks: Dict[str, object] = {}
        for i, b in enumerate(self.backends_list()):
            snap = None
            try:
                conn = self._open(b, "GET", "/metrics", None,
                                  timeout=min(self.request_timeout_secs,
                                              5.0))
                resp = conn.getresponse()
                if resp.status == 200:
                    snap = json.loads(resp.read() or b"{}")
                else:
                    resp.read()
                conn.close()
            except (OSError, http.client.HTTPException, ValueError):
                snap = None
            per_backend[f"backend_{i}"] = snap
            if isinstance(snap, dict):
                # alert states are facts about one replica: excluded
                # from the numeric sum (which would add counters and
                # drop the firing lists) and merged explicitly below
                if isinstance(snap.get("alerts"), dict):
                    alert_blocks[b.url] = snap["alerts"]
                summable = {k: v for k, v in snap.items()
                            if k != "alerts"}
                _sum_numeric(aggregate, summable)
                _collect_non_numeric(per_replica, summable, f"backend_{i}")
                cache = snap.get("engine", {})
                cache = cache.get("cache") if isinstance(cache, dict) else None
                if isinstance(cache, dict) and cache.get("heat_top"):
                    heat_tables.append(cache["heat_top"])
        if alert_blocks:
            try:
                from megatron_llm_torch.serving.alerts import (
                    merge_alert_blocks)

                aggregate["alerts"] = merge_alert_blocks(alert_blocks)
            except ImportError:
                pass  # stdlib-only vendored router without the package
        if heat_tables:
            # _sum_numeric drops list leaves, so the fleet heat table is
            # merged explicitly: same salted prefix (fleet-stable
            # MEGATRON_CACHE_SALT) sums, distinct keys compete for top-K.
            try:
                from megatron_llm_torch.serving.cache_observatory import (
                    merge_heat_tops)

                eng = aggregate.setdefault("engine", {})
                if isinstance(eng, dict):
                    sub = eng.setdefault("cache", {})
                    if isinstance(sub, dict):
                        sub["heat_top"] = merge_heat_tops(heat_tables)
            except ImportError:
                pass  # stdlib-only deployment: no fleet heat table
        hists = aggregate.get("histograms")
        if isinstance(hists, dict):
            try:
                from megatron_llm_torch.telemetry import histogram_percentile

                slo: Dict[str, object] = {}
                for name, h in hists.items():
                    if not _is_histogram(h):
                        continue
                    for q, tag in ((0.50, "p50"), (0.95, "p95"),
                                   (0.99, "p99")):
                        slo[f"{name}_{tag}"] = histogram_percentile(h, q)
                aggregate["slo"] = slo
            except ImportError:
                # stdlib-only deployment without the package on path:
                # drop the (meaninglessly summed) percentiles instead
                aggregate.pop("slo", None)
        if per_replica:
            aggregate["per_replica"] = per_replica
        return {"router": self.snapshot(), "aggregate": aggregate,
                "backends": per_backend}

    def _get_json(self, url: str, path: str) -> Optional[dict]:
        """GET a JSON document from a sibling router; None on any
        transport/parse trouble (a dead peer must not fail the view)."""
        p = urlparse(url)
        conn = http.client.HTTPConnection(
            p.hostname, p.port,
            timeout=min(self.request_timeout_secs, 5.0))
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            if resp.status != 200:
                resp.read()
                return None
            return json.loads(resp.read() or b"{}")
        except (OSError, http.client.HTTPException, ValueError):
            return None
        finally:
            conn.close()

    @staticmethod
    def _tier_view(rsnap: Dict[str, object]) -> Dict[str, object]:
        """A router snapshot reduced to what merges meaningfully across
        the tier: counters and histograms.  Per-backend breaker detail
        stays in the per-router views — every router watches the SAME
        replicas, so summing those across siblings would double-count."""
        return {k: v for k, v in rsnap.items()
                if k not in ("backends", "fleet")}

    def fleet_metrics(self) -> Dict[str, object]:
        """Fleet-wide view answerable at ANY single router.

        The replica ``aggregate`` is computed locally — every router
        probes every replica, so the block is identical at each sibling
        (up to probe skew) and merging it across peers would
        double-count.  What DOES merge is the router tier itself: each
        sibling's router-local snapshot (``?scope=router`` — one hop,
        never fans out again, so there is no gossip recursion), counters
        summed and histograms merged bucket-wise with the same
        ``_sum_numeric`` the replica aggregate uses, tier percentiles
        recomputed from the merged buckets (percentiles never sum)."""
        out = self.aggregated_metrics()
        local = out["router"]
        per_router: Dict[str, object] = {"router_0": local}
        merged: Dict[str, object] = {}
        _sum_numeric(merged, self._tier_view(local))
        peers = self.peers_list()
        reporting = 1
        now = time.monotonic()
        # the local view is by definition fresh; peers report their
        # scrape age so a cache-served (stale) snapshot is visible in
        # the merged tier view instead of passing as current
        ages: Dict[str, object] = {"router_0": 0.0}
        for i, url in enumerate(peers):
            key = f"router_{i + 1}"
            snap = self._get_json(url, "/metrics?scope=router")
            rsnap = snap.get("router") if isinstance(snap, dict) else None
            if isinstance(rsnap, dict):
                with self._lock:
                    self._peer_cache[url] = (rsnap, now)
                ages[key] = 0.0
                reporting += 1
            else:
                with self._lock:
                    cached = self._peer_cache.get(url)
                if cached is not None:
                    rsnap = cached[0]
                    ages[key] = round(now - cached[1], 3)
                else:
                    ages[key] = None    # never answered: nothing to age
            per_router[key] = rsnap
            if isinstance(rsnap, dict):
                _sum_numeric(merged, self._tier_view(rsnap))
        with self._lock:
            # bound the cache to the current peer set (scale-downs and
            # dead routers must not pin their final snapshot forever)
            live = set(peers)
            for url in [u for u in self._peer_cache if u not in live]:
                self._peer_cache.pop(url, None)
        hists = merged.get("histograms")
        if isinstance(hists, dict):
            try:
                from megatron_llm_torch.telemetry import (
                    histogram_percentile as pctl,
                )
            except ImportError:
                pctl = _histogram_percentile
            slo: Dict[str, object] = {}
            for name, h in hists.items():
                if not _is_histogram(h):
                    continue
                for q, tag in ((0.50, "p50"), (0.95, "p95"),
                               (0.99, "p99")):
                    slo[f"{name}_{tag}"] = pctl(h, q)
            merged["slo"] = slo
        out["router_tier"] = {
            "routers_total": 1 + len(peers),
            "routers_reporting": reporting,
            "last_scrape_age_secs": ages,
            "merged": merged,
            "per_router": per_router,
        }
        return out


class RouterServer:
    """HTTP front-end mirroring ``MegatronServer``'s surface (PUT/POST
    /api + /api/stream, GET /health + /metrics) so clients and
    ``tools/serve_bench.py`` point at the router unchanged."""

    def __init__(self, router: ReplicaRouter):
        self.router = router
        self.httpd = None

    def shutdown(self) -> None:
        """Deterministic teardown: stop the health prober, then break
        ``serve_forever``.  Safe from a signal handler — ``shutdown()``
        deadlocks when called from the serving thread itself, so it runs
        on a helper thread."""
        self.router.stop()
        httpd = self.httpd
        if httpd is not None:
            threading.Thread(target=httpd.shutdown, daemon=True).start()

    def run(self, host: str = "0.0.0.0", port: int = 8000) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        # the renderer lives in telemetry.py; imported lazily so the
        # router stays importable without the serving stack
        from megatron_llm_torch.telemetry import (
            _wants_prometheus,
            prometheus_exposition,
        )

        router = self.router

        class Handler(BaseHTTPRequestHandler):
            def _send_json(self, code: int, body: dict,
                           trace_id: str = None):
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                if trace_id:
                    self.send_header(TRACE_HEADER, trace_id)
                if code == 429:
                    self.send_header("Retry-After", str(max(int(
                        body.get("retry_after_secs") or 1), 1)))
                self.end_headers()
                self.wfile.write(data)

            def _body(self) -> bytes:
                n = int(self.headers.get("Content-Length", 0))
                return self.rfile.read(n) if n else b""

            def _trace_id(self) -> str:
                # honor a client-supplied id (an upstream gateway may
                # already own the trace), mint otherwise
                return self.headers.get(TRACE_HEADER) or _new_trace_id()

            def do_PUT(self):
                if self.path in ("/api/stream", "/generate/stream"):
                    self._do_stream()
                    return
                if self.path not in ("/api", "/generate"):
                    self.send_error(404)
                    return
                trace_id = self._trace_id()
                try:
                    status, headers, data = router.dispatch(
                        "PUT", self.path, self._body(), trace_id=trace_id)
                except AllBackendsThrottled as exc:
                    self._send_json(429, exc.body, trace_id=trace_id)
                    return
                except NoBackendAvailable as exc:
                    self._send_json(503, {"message": str(exc)},
                                    trace_id=trace_id)
                    return
                self.send_response(status)
                self.send_header("Content-Type", headers.get(
                    "Content-Type", "application/json"))
                self.send_header("Content-Length", str(len(data)))
                self.send_header(TRACE_HEADER, trace_id)
                ra = headers.get("Retry-After")
                if ra:
                    self.send_header("Retry-After", ra)
                self.end_headers()
                self.wfile.write(data)

            def _do_stream(self):
                trace_id = self._trace_id()
                try:
                    status, headers, chunks = router.dispatch_stream(
                        "PUT", self.path, self._body(), trace_id=trace_id)
                except AllBackendsThrottled as exc:
                    self._send_json(429, exc.body, trace_id=trace_id)
                    return
                except NoBackendAvailable as exc:
                    self._send_json(503, {"message": str(exc)},
                                    trace_id=trace_id)
                    return
                self.send_response(status)
                self.send_header("Content-Type", headers.get(
                    "Content-Type", "text/event-stream"))
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.send_header(TRACE_HEADER, trace_id)
                self.end_headers()
                try:
                    for chunk in chunks:
                        self.wfile.write(chunk)
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    for _ in chunks:    # drain so counters settle
                        pass

            def do_POST(self):
                if self.path.startswith("/admin/"):
                    self._do_admin()
                    return
                self.do_PUT()

            def _do_admin(self):
                """Control surface for an out-of-process supervisor:
                replica membership, sibling-peer list, brownout, and
                pushed fleet stats.  Same-trust-domain tooling — the
                router has no auth story, as with /metrics."""
                try:
                    body = json.loads(self._body() or b"{}")
                    if not isinstance(body, dict):
                        raise ValueError("body must be a JSON object")
                except ValueError as exc:
                    self._send_json(400, {"message": str(exc)})
                    return
                if self.path == "/admin/backends":
                    added = [router.add_backend(u).url
                             for u in body.get("add", [])]
                    removed = [u for u in body.get("remove", [])
                               if router.remove_backend(u)]
                    self._send_json(200, {
                        "added": added, "removed": removed,
                        "backends": [b.url
                                     for b in router.backends_list()]})
                elif self.path == "/admin/peers":
                    peers = router.set_peers(body.get("peers", []))
                    self._send_json(200, {"peers": peers})
                elif self.path == "/admin/brownout":
                    if body.get("end"):
                        router.end_brownout()
                    else:
                        router.begin_brownout(
                            float(body.get("eta_secs", 0.0)))
                    self._send_json(200, {
                        "brownout_remaining_secs": round(
                            router.brownout_remaining(), 3)})
                elif self.path == "/admin/fleet_stats":
                    router.set_fleet_stats_data(body or None)
                    self._send_json(200, {"ok": 1})
                else:
                    self.send_error(404)

            def do_GET(self):
                if self.path == "/health":
                    backends = router.backends_list()
                    alive = router.alive_count()
                    code = 200 if alive > 0 else 503
                    self._send_json(code, {
                        "status": "ok" if alive > 0 else "no_backends",
                        "backends_alive": alive,
                        "backends_draining": sum(
                            int(b.draining) for b in backends),
                        "backends_total": len(backends)})
                elif self.path == "/metrics" \
                        or self.path.startswith("/metrics?"):
                    scope = parse_qs(urlparse(self.path).query).get(
                        "scope", [""])[0]
                    if scope == "router":
                        # one-hop sibling query: the router's own
                        # snapshot only, no replica probing, no fan-out
                        snap = {"router": router.snapshot()}
                    elif scope == "local" or not router.peers_list():
                        snap = router.aggregated_metrics()
                    else:
                        snap = router.fleet_metrics()
                    if _wants_prometheus(self.path,
                                         self.headers.get("Accept", "")):
                        flat = {"router": _numeric_only(snap["router"]),
                                "aggregate": _numeric_only(
                                    snap.get("aggregate", {}))}
                        data = prometheus_exposition(
                            flat, prefix="megatron_router_").encode()
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

        server = ThreadingHTTPServer((host, port), Handler)
        self.httpd = server     # exposed for tests (port may be 0)
        router.start_health_thread()
        # one atomic PORT line: the same handshake replicas speak, so a
        # supervisor can spawn routers with --port 0 through
        # LocalProcessBackend and scrape the chosen port from stdout
        print(f"PORT {server.server_address[1]}\n"
              f" * routing {len(router.backends)} backends on "
              f"http://{host}:{server.server_address[1]}/api",
              flush=True)
        server.serve_forever()
