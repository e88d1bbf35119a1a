"""Fleet supervisor: the control loop that owns the replica set.

The fleet-resilience *primitives* (graceful drain, circuit breakers,
requeue-on-death) and the merged SLO histograms live in the server and
the router; this module drives them:

* **Lifecycle** — a pluggable :class:`ReplicaBackend` (spawn / poll /
  kill) owns replica processes; the supervisor registers each replica
  with the :class:`~megatron_llm_torch.serving.router.ReplicaRouter` the
  moment it reports ready and deregisters it the moment it dies, so
  fleet membership is dynamic instead of a startup-time list.
* **Self-healing** — a dead replica (child process exited, or breaker
  open past a confirmation window) is respawned under the same stable
  slot id with capped exponential backoff inside a restart-storm
  window; the router's existing requeue/failover covers the in-flight
  work, so a SIGKILL drops zero requests.
* **SLO-driven scaling** — the supervisor polls the router's merged
  histograms and queue depths, scales up on a sustained p95-TTFT or
  queue-depth breach (cooldown + hysteresis, never flaps) and scales
  down by draining the *coldest* replica (fewest sticky prefixes) when
  sustained-idle.  Decisions are pure functions of a
  :class:`FleetSnapshot` — the policy never reads the wall clock, so
  unit tests drive it with a fake one and zero subprocesses.
* **Brownout** — while a scale-up is in flight the router's 429s carry
  an honest ``retry_after`` derived from the spawn ETA (see
  ``ReplicaRouter.begin_brownout``), shedding load deterministically
  instead of letting streams time out.
* **Router tier** — the front door itself is supervised: with
  ``router_backend`` set, the supervisor spawns N router *processes*
  (stateless by construction — rendezvous affinity needs no shared
  state), respawns dead ones with the same storm-capped per-slot
  backoff replicas get, scales the tier on front-door saturation
  (windowed dispatch-latency p95 / summed router in-flight), and talks
  to the tier through :class:`RouterTierClient`, which fans the same
  add/remove/brownout surface out over every live router's ``/admin``
  endpoints and keeps peer lists + replica membership synchronized.

Everything here is host-side policy over already-running engines: the
zero-steady-state-recompile property of the serving stack is untouched,
and the module itself imports stdlib only (telemetry is reached lazily,
for the schema stamp on fleet events).
"""

from __future__ import annotations

import http.client
import json
import re
import subprocess
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple
from urllib.parse import urlparse

__all__ = [
    "FleetSnapshot", "FleetSupervisor", "LocalProcessBackend",
    "PolicyConfig", "ReplicaBackend", "ReplicaInfo", "Respawn",
    "RouterScaleDown", "RouterScaleUp", "RouterTierClient",
    "ScaleDown", "ScaleUp", "ScalingPolicy",
]


_UNSET = object()
_SCHEMA = _UNSET


def _schema_version() -> Optional[int]:
    """Telemetry schema stamp for fleet-event records; lazy so the
    module stays importable (and vendorable) with stdlib alone."""
    global _SCHEMA
    if _SCHEMA is _UNSET:
        try:
            from megatron_llm_torch.telemetry import TELEMETRY_SCHEMA_VERSION
            _SCHEMA = TELEMETRY_SCHEMA_VERSION
        except ImportError:
            _SCHEMA = None
    return _SCHEMA


# ---------------------------------------------------------------------------
# windowed percentiles over the router's merged histograms
# ---------------------------------------------------------------------------

def _hist_delta(cur: Optional[dict], prev: Optional[dict]
                ) -> Optional[dict]:
    """Per-bucket delta of two lifetime histogram snapshots — the
    distribution of the *last polling window*.  Lifetime percentiles
    latch: one spike keeps p95 above the SLO forever, so the scaler
    would never observe recovery.  Buckets are non-cumulative counts
    (telemetry.Histogram), so a plain per-key subtraction is exact."""
    if not isinstance(cur, dict) or not isinstance(cur.get("buckets"),
                                                   dict):
        return None
    if not isinstance(prev, dict) or not isinstance(prev.get("buckets"),
                                                    dict):
        return cur
    pb = prev["buckets"]
    buckets = {k: max(int(v) - int(pb.get(k, 0)), 0)
               for k, v in cur["buckets"].items()}
    return {
        "buckets": buckets,
        "count": max(int(cur.get("count", 0))
                     - int(prev.get("count", 0)), 0),
        "sum": float(cur.get("sum", 0.0)) - float(prev.get("sum", 0.0)),
    }


def _histogram_percentile(snap: Optional[dict], q: float
                          ) -> Optional[float]:
    """Structural twin of telemetry.histogram_percentile (linear
    interpolation in the winning bucket, +Inf answers its lower edge),
    redeclared so the supervisor needs no jax-importing module."""
    if not isinstance(snap, dict) \
            or not isinstance(snap.get("buckets"), dict):
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


# ---------------------------------------------------------------------------
# scaling policy: pure decisions over a FleetSnapshot
# ---------------------------------------------------------------------------

@dataclass
class ReplicaInfo:
    """What the policy may know about one replica."""
    slot: str                           # stable identity ("replica-0")
    url: Optional[str] = None
    state: str = "starting"   # starting|ready|draining|retiring|dead
    in_flight: int = 0
    affinity_entries: int = 0           # sticky prefixes (coldness)
    process_dead: bool = False          # child exited: confirmed dead
    dead_since: Optional[float] = None  # breaker first seen open


@dataclass
class FleetSnapshot:
    """One observation of the fleet; ``now`` is the only clock the
    policy ever sees, so tests inject whatever timeline they want."""
    now: float
    replicas: List[ReplicaInfo] = field(default_factory=list)
    ttft_p95_secs: Optional[float] = None   # windowed (last poll delta)
    queue_depth: int = 0                    # fleet-summed engine queues
    spawns_in_flight: int = 0
    # router tier (empty / defaults when the tier is unmanaged)
    routers: List[ReplicaInfo] = field(default_factory=list)
    router_dispatch_p95_secs: Optional[float] = None  # windowed
    router_inflight: int = 0            # summed across live routers
    router_spawns_in_flight: int = 0


@dataclass
class PolicyConfig:
    """Scaling/respawn knobs (serve_fleet's flags map 1:1)."""
    ttft_p95_slo_secs: float = 1.0
    queue_depth_high: int = 16
    breach_secs: float = 2.0            # breach must sustain this long
    scale_cooldown_secs: float = 30.0   # min gap between scale actions
    scale_down_idle_secs: float = 60.0  # idle must sustain this long
    scale_down_ttft_frac: float = 0.5   # hysteresis: idle iff p95 below
    #                                     frac*SLO (not merely below SLO)
    min_replicas: int = 1
    max_replicas: int = 4
    respawn_backoff_secs: float = 1.0
    respawn_backoff_max_secs: float = 30.0
    respawn_storm_window_secs: float = 60.0
    dead_confirmation_secs: float = 3.0  # breaker-open grace before a
    #                                      live-process replica is dead
    # router tier (max_routers == 0 leaves the tier unmanaged — the
    # legacy single in-process router of serve_fleet)
    min_routers: int = 0
    max_routers: int = 0
    router_dispatch_p95_slo_secs: float = 0.25  # scale up when the
    #   windowed router dispatch-loop p95 sustains above this...
    router_inflight_high: int = 64      # ...or the summed router
    #   in-flight (connection-queue proxy) sustains at/above this


@dataclass
class ScaleUp:
    reason: str


@dataclass
class ScaleDown:
    victim: str     # slot of the coldest ready replica


@dataclass
class Respawn:
    """Replace a dead replica OR router under its stable slot (router
    slots are ``router-N``); both share the storm-capped backoff."""
    slot: str
    backoff_secs: float = 0.0


@dataclass
class RouterScaleUp:
    reason: str


@dataclass
class RouterScaleDown:
    victim: str     # slot of the emptiest ready router


@dataclass
class _RespawnState:
    backoff: float
    next_allowed: float
    last: float


class ScalingPolicy:
    """Deterministic scaling decisions.  ``decide`` consumes snapshots
    in timestamp order and returns the actions due at that instant; all
    state lives here (breach/idle timers, cooldown, per-slot respawn
    backoff) and all time comes from ``snap.now``."""

    def __init__(self, config: Optional[PolicyConfig] = None):
        self.cfg = config or PolicyConfig()
        self._breach_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._last_scale: Optional[float] = None
        # router tier runs its own breach/idle/cooldown timeline; the
        # respawn backoff map is shared on purpose — "router-N" and
        # "replica-N" slots never collide and both deserve the same
        # storm capping
        self._router_breach_since: Optional[float] = None
        self._router_idle_since: Optional[float] = None
        self._last_router_scale: Optional[float] = None
        self._respawn: Dict[str, _RespawnState] = {}

    # -- respawn backoff ------------------------------------------------

    def _respawn_due(self, slot: str, now: float) -> bool:
        st = self._respawn.get(slot)
        return st is None or now >= st.next_allowed

    def _note_respawn(self, slot: str, now: float) -> float:
        """Record a respawn; doubling inside the storm window, reset to
        the base backoff outside it.  Returns the *next* backoff."""
        st = self._respawn.get(slot)
        if st is None \
                or now - st.last >= self.cfg.respawn_storm_window_secs:
            backoff = self.cfg.respawn_backoff_secs
        else:
            backoff = min(st.backoff * 2.0,
                          self.cfg.respawn_backoff_max_secs)
        self._respawn[slot] = _RespawnState(
            backoff=backoff, next_allowed=now + backoff, last=now)
        return backoff

    # -- the decision ----------------------------------------------------

    def decide(self, snap: FleetSnapshot) -> List[object]:
        cfg = self.cfg
        now = snap.now
        actions: List[object] = []

        # self-healing first: respawns are not throttled by the scale
        # cooldown (a dead replica is capacity already paid for), only
        # by their own per-slot backoff
        for r in snap.replicas:
            if r.state in ("retiring", "starting"):
                continue
            confirmed = r.process_dead or (
                r.dead_since is not None
                and now - r.dead_since >= cfg.dead_confirmation_secs)
            if r.state == "dead" and confirmed \
                    and self._respawn_due(r.slot, now):
                actions.append(Respawn(
                    r.slot, self._note_respawn(r.slot, now)))

        ready = [r for r in snap.replicas if r.state == "ready"]
        population = len(ready) + snap.spawns_in_flight

        breach = (snap.ttft_p95_secs is not None
                  and snap.ttft_p95_secs > cfg.ttft_p95_slo_secs) \
            or snap.queue_depth >= cfg.queue_depth_high
        idle = snap.queue_depth == 0 and (
            snap.ttft_p95_secs is None
            or snap.ttft_p95_secs
            < cfg.scale_down_ttft_frac * cfg.ttft_p95_slo_secs)

        # between frac*SLO and SLO neither timer runs: the hysteresis
        # band where an oscillating p95 flaps nothing
        if breach:
            self._breach_since = self._breach_since \
                if self._breach_since is not None else now
            self._idle_since = None
        elif idle:
            self._idle_since = self._idle_since \
                if self._idle_since is not None else now
            self._breach_since = None
        else:
            self._breach_since = None
            self._idle_since = None

        cooled = self._last_scale is None \
            or now - self._last_scale >= cfg.scale_cooldown_secs

        if self._breach_since is not None \
                and now - self._breach_since >= cfg.breach_secs \
                and snap.spawns_in_flight == 0 \
                and population < cfg.max_replicas \
                and cooled:
            actions.append(ScaleUp(
                "ttft_p95" if (snap.ttft_p95_secs is not None
                               and snap.ttft_p95_secs
                               > cfg.ttft_p95_slo_secs)
                else "queue_depth"))
            self._last_scale = now
            self._breach_since = None
        elif self._idle_since is not None \
                and now - self._idle_since >= cfg.scale_down_idle_secs \
                and snap.spawns_in_flight == 0 \
                and len(ready) > cfg.min_replicas \
                and cooled:
            coldest = min(ready, key=lambda r: (
                r.affinity_entries, r.in_flight, r.slot))
            actions.append(ScaleDown(coldest.slot))
            self._last_scale = now
            self._idle_since = None

        if cfg.max_routers > 0:
            actions.extend(self._decide_routers(snap))
        return actions

    def _decide_routers(self, snap: FleetSnapshot) -> List[object]:
        """Router-tier decisions: same shape as the replica logic —
        respawn first (per-slot storm-capped backoff, never throttled by
        the scale cooldown), then sustained-breach scale-up / sustained-
        idle scale-down with hysteresis.  Routers have no breaker or
        drain phase: a router is dead exactly when its process is, and
        scale-down just deregisters it (stateless by construction — the
        keys it owned re-rendezvous nowhere, affinity lives on the
        replicas)."""
        cfg = self.cfg
        now = snap.now
        actions: List[object] = []
        for r in snap.routers:
            if r.state == "dead" and r.process_dead \
                    and self._respawn_due(r.slot, now):
                actions.append(Respawn(
                    r.slot, self._note_respawn(r.slot, now)))

        ready = [r for r in snap.routers if r.state == "ready"]
        population = len(ready) + snap.router_spawns_in_flight

        p95 = snap.router_dispatch_p95_secs
        breach = (p95 is not None
                  and p95 > cfg.router_dispatch_p95_slo_secs) \
            or snap.router_inflight >= cfg.router_inflight_high
        idle = snap.router_inflight == 0 and (
            p95 is None
            or p95 < cfg.scale_down_ttft_frac
            * cfg.router_dispatch_p95_slo_secs)

        if breach:
            self._router_breach_since = self._router_breach_since \
                if self._router_breach_since is not None else now
            self._router_idle_since = None
        elif idle:
            self._router_idle_since = self._router_idle_since \
                if self._router_idle_since is not None else now
            self._router_breach_since = None
        else:
            self._router_breach_since = None
            self._router_idle_since = None

        cooled = self._last_router_scale is None \
            or now - self._last_router_scale >= cfg.scale_cooldown_secs

        if self._router_breach_since is not None \
                and now - self._router_breach_since >= cfg.breach_secs \
                and snap.router_spawns_in_flight == 0 \
                and population < cfg.max_routers \
                and cooled:
            actions.append(RouterScaleUp(
                "router_dispatch_p95" if (
                    p95 is not None
                    and p95 > cfg.router_dispatch_p95_slo_secs)
                else "router_inflight"))
            self._last_router_scale = now
            self._router_breach_since = None
        elif self._router_idle_since is not None \
                and now - self._router_idle_since \
                >= cfg.scale_down_idle_secs \
                and snap.router_spawns_in_flight == 0 \
                and len(ready) > max(cfg.min_routers, 1) \
                and cooled:
            emptiest = min(ready, key=lambda r: (r.in_flight, r.slot))
            actions.append(RouterScaleDown(emptiest.slot))
            self._last_router_scale = now
            self._router_idle_since = None
        return actions


# ---------------------------------------------------------------------------
# replica backends (pluggable spawn/poll/kill)
# ---------------------------------------------------------------------------

class ReplicaBackend:
    """Contract a real orchestrator adapter (k8s, GCE MIG, ...) must
    satisfy.  ``spawn`` must not block on the replica becoming ready —
    readiness is what ``poll`` reports."""

    #: supervisor's prior for how long spawn->ready takes, used for the
    #: brownout retry_after until observed spawns refine it
    spawn_eta_secs: float = 60.0

    def spawn(self) -> object:
        """Start one replica; returns an opaque handle."""
        raise NotImplementedError

    def poll(self, handle: object) -> Tuple[str, Optional[str]]:
        """(state, url): state is ``starting`` (booting), ``ready``
        (serving at url — and still alive), or ``dead``."""
        raise NotImplementedError

    def kill(self, handle: object) -> None:
        """Hard-stop the replica (idempotent)."""
        raise NotImplementedError


class _LocalHandle:
    def __init__(self, proc: subprocess.Popen):
        self.proc = proc
        self.port: Optional[int] = None
        self._port_seen = threading.Event()

    def wait_port(self, timeout: float) -> Optional[int]:
        self._port_seen.wait(timeout)
        return self.port


class LocalProcessBackend(ReplicaBackend):
    """Subprocess replicas for tests and single-host fleets.  Reuses
    the ``PORT <n>`` handshake of ``tests/_serve_replica.py`` /
    ``megatron_llm_torch.run_text_generation_server --port 0``: a reader
    thread scans the child's stdout (``re.search``, not ``startswith`` —
    the banner print can interleave) and keeps draining so the child
    never blocks on a full pipe."""

    def __init__(self, argv: Sequence[str], env: Optional[dict] = None,
                 cwd: Optional[str] = None, host: str = "127.0.0.1",
                 spawn_eta_secs: float = 60.0,
                 stderr: Optional[int] = subprocess.DEVNULL):
        self.argv = list(argv)
        self.env = env
        self.cwd = cwd
        self.host = host
        self.spawn_eta_secs = float(spawn_eta_secs)
        self.stderr = stderr

    def spawn(self) -> _LocalHandle:
        proc = subprocess.Popen(
            self.argv, stdout=subprocess.PIPE, stderr=self.stderr,
            env=self.env, cwd=self.cwd, text=True)
        handle = _LocalHandle(proc)

        def _scan():
            for line in proc.stdout:
                m = re.search(r"PORT (\d+)", line)
                if m and handle.port is None:
                    handle.port = int(m.group(1))
                    handle._port_seen.set()
                # keep draining: the child must never block on the pipe
            handle._port_seen.set()

        threading.Thread(target=_scan, daemon=True).start()
        return handle

    def poll(self, handle: _LocalHandle) -> Tuple[str, Optional[str]]:
        if handle.proc.poll() is not None:
            return "dead", None
        if handle.port is not None:
            return "ready", f"http://{self.host}:{handle.port}"
        return "starting", None

    def kill(self, handle: _LocalHandle) -> None:
        if handle.proc.poll() is None:
            handle.proc.kill()
        try:
            handle.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass


# ---------------------------------------------------------------------------
# router-tier client: the supervisor's view of N router processes
# ---------------------------------------------------------------------------

def _normalize_url(u: str) -> str:
    """Canonical http://host:port form (mirrors router.Backend's
    normalization so membership comparisons never miss on formatting)."""
    if "//" not in u:
        u = "http://" + u
    p = urlparse(u)
    return f"http://{p.hostname}:{p.port}"


class RouterTierClient:
    """Duck-types the ``ReplicaRouter`` surface the supervisor drives
    (add/remove backend, brownout, snapshot/aggregated_metrics, the
    fleet-stats hook) against a tier of router *processes*, by fanning
    each call out over HTTP to every live router's ``/admin`` endpoints.

    The client holds only desired state (which routers are live, which
    replicas should be registered) — the routers themselves stay
    stateless and independently derive breaker/load/draining state from
    their own probe threads.  ``sync()`` runs once per control-loop turn
    and is idempotent: peers, membership, and pushed fleet stats
    converge even if an earlier fan-out half-failed.

    All HTTP happens outside ``self._lock`` (graft-lint locks/LD001)."""

    # lint-enforced (graft-lint locks/LD002): the supervisor control
    # loop and chaos harnesses may drive this concurrently
    _lock_protected_ = ("router_urls", "backend_urls", "_brownout_eta")

    def __init__(self, timeout_secs: float = 5.0):
        self.timeout_secs = float(timeout_secs)
        self.router_urls: List[str] = []
        self.backend_urls: List[str] = []
        self._brownout_eta: Optional[float] = None
        self._stats_fn: Optional[Callable[[], dict]] = None
        self._lock = threading.Lock()

    # -- plumbing -------------------------------------------------------

    def _request(self, url: str, method: str, path: str,
                 payload: Optional[dict] = None) -> Optional[dict]:
        p = urlparse(url)
        body = json.dumps(payload).encode() if payload is not None \
            else None
        try:
            conn = http.client.HTTPConnection(
                p.hostname, p.port, timeout=self.timeout_secs)
            conn.request(method, path, body=body,
                         headers={"Content-Type": "application/json"}
                         if body else {})
            resp = conn.getresponse()
            data = resp.read()
            conn.close()
            if resp.status != 200:
                return None
            return json.loads(data or b"{}")
        except (OSError, http.client.HTTPException, ValueError):
            return None

    def _fanout(self, method: str, path: str,
                payload: Optional[dict] = None) -> int:
        """Send to every live router; returns how many acknowledged."""
        with self._lock:
            routers = list(self.router_urls)
        return sum(self._request(u, method, path, payload) is not None
                   for u in routers)

    # -- desired state --------------------------------------------------

    def set_routers(self, urls: Sequence[str]) -> None:
        """Replace the live-router list (the supervisor reconciles it
        from process reality every turn)."""
        with self._lock:
            self.router_urls = [_normalize_url(u) for u in urls]

    def routers_list(self) -> List[str]:
        with self._lock:
            return list(self.router_urls)

    def sync(self) -> None:
        """Converge every live router onto the desired state: sibling
        peer lists, replica membership (adds AND removal of stale
        entries a router learned before a half-failed turn), brownout,
        and the pushed fleet-stats block for /metrics."""
        with self._lock:
            routers = list(self.router_urls)
            backends = list(self.backend_urls)
            brownout = self._brownout_eta
        stats = None
        if self._stats_fn is not None:
            try:
                stats = self._stats_fn()
            except Exception:   # noqa: BLE001 - stats must not kill sync
                stats = None
        for u in routers:
            self._request(u, "POST", "/admin/peers",
                          {"peers": [v for v in routers if v != u]})
            resp = self._request(u, "POST", "/admin/backends",
                                 {"add": backends})
            if isinstance(resp, dict):
                stale = [x for x in resp.get("backends", [])
                         if x not in backends]
                if stale:
                    self._request(u, "POST", "/admin/backends",
                                  {"remove": stale})
            if brownout is not None:
                self._request(u, "POST", "/admin/brownout",
                              {"eta_secs": brownout})
            if isinstance(stats, dict):
                self._request(u, "POST", "/admin/fleet_stats", stats)

    # -- the ReplicaRouter surface the supervisor drives ----------------

    def set_fleet_stats(self, fn: Callable[[], dict]) -> None:
        self._stats_fn = fn

    def add_backend(self, url: str) -> None:
        norm = _normalize_url(url)
        with self._lock:
            if norm not in self.backend_urls:
                self.backend_urls.append(norm)
        self._fanout("POST", "/admin/backends", {"add": [norm]})

    def remove_backend(self, url: str) -> bool:
        norm = _normalize_url(url)
        with self._lock:
            known = norm in self.backend_urls
            if known:
                self.backend_urls.remove(norm)
        self._fanout("POST", "/admin/backends", {"remove": [norm]})
        return known

    def begin_brownout(self, eta_secs: float) -> None:
        with self._lock:
            self._brownout_eta = float(eta_secs)
        self._fanout("POST", "/admin/brownout",
                     {"eta_secs": float(eta_secs)})

    def end_brownout(self) -> None:
        with self._lock:
            active = self._brownout_eta is not None
            self._brownout_eta = None
        if active:      # avoid a per-turn fan-out in the steady state
            self._fanout("POST", "/admin/brownout", {"end": True})

    def aggregated_metrics(self) -> Dict[str, object]:
        """The replica-fleet view from the first router that answers —
        every router probes every replica, so any one of them speaks
        for the fleet (eventual agreement)."""
        for u in self.routers_list():
            snap = self._request(u, "GET", "/metrics?scope=local")
            if isinstance(snap, dict):
                return snap
        return {"router": {}, "aggregate": {}, "backends": {}}

    def snapshot(self) -> Dict[str, object]:
        router = self.aggregated_metrics().get("router")
        return router if isinstance(router, dict) else {}

    def router_snapshots(self) -> Dict[str, Optional[dict]]:
        """Each live router's own one-hop snapshot (``?scope=router``),
        keyed by URL; None for routers that did not answer."""
        out: Dict[str, Optional[dict]] = {}
        for u in self.routers_list():
            snap = self._request(u, "GET", "/metrics?scope=router")
            router = snap.get("router") if isinstance(snap, dict) \
                else None
            out[u] = router if isinstance(router, dict) else None
        return out


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------

class _Replica:
    """Supervisor-side record of one slot (stable across respawns)."""

    def __init__(self, slot: str, handle: object, spawned_at: float,
                 respawn: bool = False):
        self.slot = slot
        self.handle = handle
        self.url: Optional[str] = None
        self.state = "starting"  # starting|ready|retiring|dead
        self.spawned_at = spawned_at
        self.respawn = respawn          # replacement, not new capacity
        self.breaker_dead_since: Optional[float] = None


class FleetSupervisor:
    """Owns the replica set: spawns/kills via a :class:`ReplicaBackend`,
    registers membership with the router, heals deaths, scales on SLO
    breaches and sheds load via brownout while capacity boots.

    Thread shape: one control-loop thread calls :meth:`run_once`;
    router HTTP workers call :meth:`stats` (via the router's fleet-stats
    hook).  All shared state mutates under ``self._lock``, and no
    blocking work (spawn, kill, HTTP, file IO) happens inside it."""

    # lint-enforced (graft-lint locks/LD002): stats() is called from the
    # router's HTTP threads while the control loop mutates these
    _lock_protected_ = ("replicas", "routers", "counters", "events",
                        "_slot_seq", "_router_slot_seq")

    def __init__(self, router, backend: ReplicaBackend,
                 config: Optional[PolicyConfig] = None,
                 policy: Optional[ScalingPolicy] = None,
                 poll_interval_secs: float = 1.0,
                 event_log_path: Optional[str] = None,
                 event_sink: Optional[Callable[[dict], None]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 router_backend: Optional[ReplicaBackend] = None,
                 alert_rules: Optional[List[dict]] = None,
                 alert_webhook: Optional[str] = None):
        self.router = router
        self.backend = backend
        self.router_backend = router_backend
        self.config = config or PolicyConfig()
        self.policy = policy or ScalingPolicy(self.config)
        self.poll_interval_secs = float(poll_interval_secs)
        self.clock = clock
        self.replicas: Dict[str, _Replica] = {}
        self.routers: Dict[str, _Replica] = {}
        self.counters = {
            "spawns_total": 0, "respawns_total": 0, "deaths_total": 0,
            "scale_ups_total": 0, "scale_downs_total": 0,
            "brownouts_total": 0,
            "router_spawns_total": 0, "router_respawns_total": 0,
            "router_deaths_total": 0, "router_scale_ups_total": 0,
            "router_scale_downs_total": 0,
        }
        self.events: "deque[dict]" = deque(maxlen=256)
        self._event_sink = event_sink
        self._event_file = open(event_log_path, "a", buffering=1) \
            if event_log_path else None
        self._lock = threading.Lock()
        self._slot_seq = 0
        self._router_slot_seq = 0
        self._prev_ttft_hist: Optional[dict] = None
        self._prev_router_hist: Optional[dict] = None
        self._spawn_secs_ema: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # fleet-scope SLO sentinel: the same rule engine each replica
        # runs locally, here evaluated over the router's *merged*
        # aggregate every control-loop turn (so fleet burn rates come
        # from merged histogram buckets, never summed percentiles).
        # Pumped from observe() — no thread of its own — and emitting
        # kind="fleet" alert_transition events through _emit.  Lazy
        # import keeps this module's stdlib-only contract: alerts.py is
        # itself stdlib-only, but vendored deployments may ship
        # supervisor.py alone.
        self.alerts = None
        try:
            from megatron_llm_torch.serving.alerts import AlertEngine

            self.alerts = AlertEngine(
                rules=alert_rules, scope="fleet", clock=clock,
                transition_sink=self._emit_alert_transition,
                webhook_url=alert_webhook)
        except ImportError:
            pass
        router.set_fleet_stats(self.stats)

    # -- events ----------------------------------------------------------

    def _emit(self, event: str, **fields) -> dict:
        rec = {"schema": _schema_version(), "kind": "fleet",
               "event": event, "time_unix": time.time(), **fields}
        with self._lock:
            self.events.append(rec)
        if self._event_sink is not None:
            try:
                self._event_sink(rec)
            except Exception:   # noqa: BLE001 - events must not kill us
                pass
        if self._event_file is not None:
            try:
                self._event_file.write(json.dumps(rec) + "\n")
            except ValueError:
                pass            # closed mid-shutdown
        return rec

    def _emit_alert_transition(self, payload: dict) -> None:
        """AlertEngine transition sink: wrap the payload in the fleet
        event envelope (schema stamp, kind="fleet") and fan it out to
        the event ring / sink / JSONL like every other fleet event."""
        fields = {k: v for k, v in payload.items() if k != "event"}
        self._emit("alert_transition", **fields)

    # -- lifecycle -------------------------------------------------------

    def _new_slot(self) -> str:
        # under the lock for the same reason as the counters: called
        # from the control loop, but spawn_initial() runs on the main
        # thread and a chaos harness may drive run_once() directly
        with self._lock:
            slot = f"replica-{self._slot_seq}"
            self._slot_seq += 1
        return slot

    def _spawn(self, slot: Optional[str] = None, respawn: bool = False
               ) -> _Replica:
        handle = self.backend.spawn()       # outside the lock: blocking
        rep = _Replica(slot or self._new_slot(), handle, self.clock(),
                       respawn=respawn)
        with self._lock:
            self.replicas[rep.slot] = rep
            self.counters["spawns_total"] += 1
        return rep

    def spawn_initial(self, n: int) -> None:
        """Bootstrap the fleet (serve_fleet startup); readiness and
        router registration happen in the control loop."""
        for _ in range(max(int(n), 0)):
            self._spawn()

    def spawn_eta_secs(self) -> float:
        """Observed spawn->ready time (EMA) once we have one, else the
        backend's declared prior — the brownout's retry_after source."""
        ema = self._spawn_secs_ema
        return max(ema if ema is not None else self.backend.spawn_eta_secs,
                   1.0)

    # -- router-tier lifecycle -------------------------------------------

    def _new_router_slot(self) -> str:
        with self._lock:
            slot = f"router-{self._router_slot_seq}"
            self._router_slot_seq += 1
        return slot

    def _spawn_router(self, slot: Optional[str] = None,
                      respawn: bool = False) -> _Replica:
        handle = self.router_backend.spawn()    # outside the lock
        rep = _Replica(slot or self._new_router_slot(), handle,
                       self.clock(), respawn=respawn)
        with self._lock:
            self.routers[rep.slot] = rep
            self.counters["router_spawns_total"] += 1
        return rep

    def spawn_initial_routers(self, n: int) -> None:
        """Bootstrap the router tier (requires ``router_backend``);
        readiness + peer wiring happen in the control loop."""
        if self.router_backend is None:
            raise RuntimeError("no router_backend configured")
        for _ in range(max(int(n), 0)):
            self._spawn_router()

    def router_urls(self) -> List[str]:
        """Live (ready) router front-door URLs, for clients."""
        with self._lock:
            reps = list(self.routers.values())
        return [r.url for r in reps if r.state == "ready" and r.url]

    # -- one control-loop turn -------------------------------------------

    def run_once(self) -> List[object]:
        """Poll replicas, observe the fleet, decide, act.  Returns the
        actions executed (handy for tests and the chaos harness)."""
        now = self.clock()
        with self._lock:
            reps = list(self.replicas.values())

        # 0. reconcile the router tier first, so replica registration
        # below fans out to every router that just became ready
        if self.router_backend is not None:
            self._reconcile_routers(now)

        # 1. reconcile process reality with our records
        for rep in reps:
            state, url = self.backend.poll(rep.handle)
            if rep.state == "starting":
                if state == "ready":
                    rep.url = url
                    rep.state = "ready"
                    spawn_secs = now - rep.spawned_at
                    ema = self._spawn_secs_ema
                    self._spawn_secs_ema = spawn_secs if ema is None \
                        else 0.5 * ema + 0.5 * spawn_secs
                    self.router.add_backend(url)
                    if rep.respawn:
                        with self._lock:
                            self.counters["respawns_total"] += 1
                        self._emit("replica_respawned", slot=rep.slot,
                                   url=url,
                                   spawn_secs=round(spawn_secs, 3))
                    else:
                        self._emit("replica_spawned", slot=rep.slot,
                                   url=url,
                                   spawn_secs=round(spawn_secs, 3))
                elif state == "dead":
                    self._mark_dead(rep, now, exited_while="starting")
            elif rep.state in ("ready", "retiring"):
                if state == "dead":
                    if rep.state == "retiring":
                        # expected exit after drain: reap, don't heal
                        if rep.url:
                            self.router.remove_backend(rep.url)
                        with self._lock:
                            self.replicas.pop(rep.slot, None)
                    else:
                        self._mark_dead(rep, now, exited_while="ready")

        # once nothing is booting, the brownout window closes: capacity
        # either arrived or the spawn failed (and death handling owns it)
        with self._lock:
            starting = [r for r in self.replicas.values()
                        if r.state == "starting"]
        if not starting:
            self.router.end_brownout()

        # 2. observe: router + merged replica metrics (HTTP, no locks)
        snap = self.observe(now)

        # 3. decide + act
        actions = self.policy.decide(snap)
        for act in actions:
            if isinstance(act, ScaleUp):
                self._scale_up(act, snap)
            elif isinstance(act, ScaleDown):
                self._scale_down(act)
            elif isinstance(act, RouterScaleUp):
                self._scale_up_router(act, snap)
            elif isinstance(act, RouterScaleDown):
                self._scale_down_router(act)
            elif isinstance(act, Respawn):
                if act.slot.startswith("router-"):
                    self._respawn_router(act)
                else:
                    self._respawn(act)
        return actions

    def _reconcile_routers(self, now: float) -> None:
        """Poll router processes, mark deaths, and converge the tier
        client (live list, peer lists, membership, pushed stats)."""
        with self._lock:
            routers = list(self.routers.values())
        for rep in routers:
            state, url = self.router_backend.poll(rep.handle)
            if rep.state == "starting":
                if state == "ready":
                    rep.url = url
                    rep.state = "ready"
                    spawn_secs = now - rep.spawned_at
                    event = "router_respawned" if rep.respawn \
                        else "router_spawned"
                    if rep.respawn:
                        with self._lock:
                            self.counters["router_respawns_total"] += 1
                    self._emit(event, slot=rep.slot, url=url,
                               spawn_secs=round(spawn_secs, 3))
                elif state == "dead":
                    self._mark_router_dead(rep, exited_while="starting")
            elif rep.state == "ready" and state == "dead":
                self._mark_router_dead(rep, exited_while="ready")
        if hasattr(self.router, "set_routers"):
            self.router.set_routers(
                [r.url for r in routers
                 if r.state == "ready" and r.url])
            self.router.sync()

    def _mark_router_dead(self, rep: _Replica,
                          exited_while: str) -> None:
        rep.state = "dead"
        with self._lock:
            self.counters["router_deaths_total"] += 1
        self._emit("router_died", slot=rep.slot, url=rep.url,
                   exited_while=exited_while)

    def _mark_dead(self, rep: _Replica, now: float,
                   exited_while: str) -> None:
        rep.state = "dead"
        if rep.url:
            self.router.remove_backend(rep.url)
        with self._lock:
            self.counters["deaths_total"] += 1
        self._emit("replica_died", slot=rep.slot, url=rep.url,
                   exited_while=exited_while)

    # -- observation -----------------------------------------------------

    def observe(self, now: Optional[float] = None) -> FleetSnapshot:
        """Build the policy's world view: per-replica router state plus
        a *windowed* p95 TTFT (bucket delta of the merged lifetime
        histograms between consecutive polls) and the fleet-summed
        engine queue depth."""
        now = self.clock() if now is None else now
        try:
            agg = self.router.aggregated_metrics().get("aggregate", {})
        except Exception:   # noqa: BLE001 - observation must not die
            agg = {}
        if self.alerts is not None and agg:
            try:
                self.alerts.evaluate(snapshot=agg, now=now)
            except Exception:   # noqa: BLE001 - sentinel must not kill us
                pass
        hist = None
        hists = agg.get("histograms")
        if isinstance(hists, dict):
            hist = hists.get("ttft_secs")
        window = _hist_delta(hist, self._prev_ttft_hist)
        if isinstance(hist, dict):
            self._prev_ttft_hist = hist
        ttft_p95 = _histogram_percentile(window, 0.95)
        engine = agg.get("engine")
        queue_depth = 0
        if isinstance(engine, dict) \
                and isinstance(engine.get("queue_depth"), (int, float)):
            queue_depth = int(engine["queue_depth"])

        by_url: Dict[str, dict] = {}
        for bsnap in self.router.snapshot().get("backends", {}).values():
            if isinstance(bsnap, dict) and bsnap.get("url"):
                by_url[bsnap["url"]] = bsnap

        infos: List[ReplicaInfo] = []
        spawns_in_flight = 0
        with self._lock:
            reps = list(self.replicas.values())
        for rep in reps:
            info = ReplicaInfo(slot=rep.slot, url=rep.url,
                               state=rep.state,
                               process_dead=rep.state == "dead")
            if rep.state == "starting":
                spawns_in_flight += 1
            bsnap = by_url.get(rep.url) if rep.url else None
            if bsnap is not None:
                info.in_flight = int(bsnap.get("in_flight", 0))
                info.affinity_entries = int(
                    bsnap.get("affinity_entries", 0))
                if bsnap.get("draining"):
                    info.state = "draining" \
                        if rep.state == "ready" else rep.state
                # breaker open: start (or continue) the dead-
                # confirmation clock; alive again clears it
                if not bsnap.get("alive"):
                    if rep.breaker_dead_since is None:
                        rep.breaker_dead_since = now
                else:
                    rep.breaker_dead_since = None
                if rep.breaker_dead_since is not None \
                        and rep.state == "ready":
                    info.state = "dead"
                    info.dead_since = rep.breaker_dead_since
            infos.append(info)
        snap = FleetSnapshot(now=now, replicas=infos,
                             ttft_p95_secs=ttft_p95,
                             queue_depth=queue_depth,
                             spawns_in_flight=spawns_in_flight)
        if self.router_backend is not None:
            self._observe_routers(snap)
        return snap

    def _observe_routers(self, snap: FleetSnapshot) -> None:
        """Router-tier half of the world view: per-router process state
        + in-flight, and a *windowed* dispatch-loop p95 over the bucket-
        wise sum of every live router's ``router_dispatch_secs``."""
        per_router: Dict[str, Optional[dict]] = {}
        if hasattr(self.router, "router_snapshots"):
            try:
                per_router = self.router.router_snapshots()
            except Exception:   # noqa: BLE001 - observation must not die
                per_router = {}
        merged: Dict[str, object] = {"buckets": {}, "count": 0,
                                     "sum": 0.0}
        inflight = 0
        for rsnap in per_router.values():
            if not isinstance(rsnap, dict):
                continue
            inflight += int(rsnap.get("inflight_requests", 0))
            hist = rsnap.get("histograms", {}).get(
                "router_dispatch_secs") \
                if isinstance(rsnap.get("histograms"), dict) else None
            if isinstance(hist, dict) \
                    and isinstance(hist.get("buckets"), dict):
                for k, v in hist["buckets"].items():
                    merged["buckets"][k] = \
                        merged["buckets"].get(k, 0) + int(v)
                merged["count"] += int(hist.get("count", 0))
                merged["sum"] += float(hist.get("sum", 0.0))
        window = _hist_delta(merged, self._prev_router_hist)
        self._prev_router_hist = merged
        snap.router_dispatch_p95_secs = _histogram_percentile(
            window, 0.95)
        snap.router_inflight = inflight
        with self._lock:
            routers = list(self.routers.values())
        for rep in routers:
            info = ReplicaInfo(slot=rep.slot, url=rep.url,
                               state=rep.state,
                               process_dead=rep.state == "dead")
            if rep.state == "starting":
                snap.router_spawns_in_flight += 1
            rsnap = per_router.get(rep.url) if rep.url else None
            if isinstance(rsnap, dict):
                info.in_flight = int(rsnap.get("inflight_requests", 0))
            snap.routers.append(info)

    # -- actions ---------------------------------------------------------

    def _scale_up(self, act: ScaleUp, snap: FleetSnapshot) -> None:
        rep = self._spawn()
        with self._lock:
            self.counters["scale_ups_total"] += 1
            self.counters["brownouts_total"] += 1
        self._emit("scale_up", slot=rep.slot, reason=act.reason,
                   ttft_p95_secs=snap.ttft_p95_secs,
                   queue_depth=snap.queue_depth)
        # shed load honestly while the new replica boots
        eta = self.spawn_eta_secs()
        self.router.begin_brownout(eta)
        self._emit("brownout", eta_secs=round(eta, 3), slot=rep.slot)

    def _scale_down(self, act: ScaleDown) -> None:
        with self._lock:
            rep = self.replicas.get(act.victim)
            if rep is None or rep.state != "ready" or not rep.url:
                return
            rep.state = "retiring"
        with self._lock:
            self.counters["scale_downs_total"] += 1
        self._emit("scale_down", slot=rep.slot, url=rep.url)
        self._post_drain(rep.url)

    def _respawn(self, act: Respawn) -> None:
        with self._lock:
            old = self.replicas.get(act.slot)
        # "ready" here means breaker-declared dead with the child still
        # running (a wedged process): kill it and replace under the slot
        if old is None or old.state not in ("dead", "ready"):
            return
        self.backend.kill(old.handle)
        if old.url:
            self.router.remove_backend(old.url)
        handle = self.backend.spawn()
        now = self.clock()
        with self._lock:
            rep = _Replica(act.slot, handle, now, respawn=True)
            self.replicas[act.slot] = rep
            self.counters["spawns_total"] += 1

    def _scale_up_router(self, act: RouterScaleUp,
                         snap: FleetSnapshot) -> None:
        rep = self._spawn_router()
        with self._lock:
            self.counters["router_scale_ups_total"] += 1
        self._emit("router_scale_up", slot=rep.slot, reason=act.reason,
                   router_dispatch_p95_secs=snap.router_dispatch_p95_secs,
                   router_inflight=snap.router_inflight)

    def _scale_down_router(self, act: RouterScaleDown) -> None:
        """Routers are stateless: deregister from the peer lists (next
        sync), then kill — no drain phase.  In-flight streams on the
        victim break and clients retry a sibling, the same contract as
        a router crash."""
        with self._lock:
            rep = self.routers.get(act.victim)
            if rep is None or rep.state != "ready":
                return
            self.routers.pop(act.victim, None)
            self.counters["router_scale_downs_total"] += 1
        if hasattr(self.router, "set_routers"):
            self.router.set_routers(self.router_urls())
            self.router.sync()
        self._emit("router_scale_down", slot=rep.slot, url=rep.url)
        self.router_backend.kill(rep.handle)

    def _respawn_router(self, act: Respawn) -> None:
        with self._lock:
            old = self.routers.get(act.slot)
        if old is None or old.state != "dead":
            return
        self.router_backend.kill(old.handle)   # reap (idempotent)
        handle = self.router_backend.spawn()
        now = self.clock()
        with self._lock:
            rep = _Replica(act.slot, handle, now, respawn=True)
            self.routers[act.slot] = rep
            self.counters["router_spawns_total"] += 1

    def _post_drain(self, url: str) -> None:
        p = urlparse(url)
        try:
            conn = http.client.HTTPConnection(p.hostname, p.port,
                                              timeout=10.0)
            conn.request("POST", "/drain", body=b"{}")
            conn.getresponse().read()
            conn.close()
        except (OSError, http.client.HTTPException):
            pass    # unreachable victim: death handling will reap it

    # -- thread + teardown ----------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return

        def loop():
            while not self._stop.wait(self.poll_interval_secs):
                try:
                    self.run_once()
                except Exception:   # noqa: BLE001 - loop must survive
                    pass

        self._thread = threading.Thread(target=loop, name="fleet-super",
                                        daemon=True)
        self._thread.start()

    def stop(self, kill_replicas: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if kill_replicas:
            with self._lock:
                reps = list(self.replicas.values())
                routers = list(self.routers.values())
            for rep in reps:
                self.backend.kill(rep.handle)
            if self.router_backend is not None:
                for rep in routers:
                    self.router_backend.kill(rep.handle)
        if self._event_file is not None:
            self._event_file.close()
            self._event_file = None

    # -- observability ---------------------------------------------------

    def stats(self) -> Dict[str, object]:
        """Numeric fleet counters for the router's /metrics (JSON and
        Prometheus) via the fleet-stats hook."""
        with self._lock:
            reps = list(self.replicas.values())
            routers = list(self.routers.values())
            counters = dict(self.counters)
        out: Dict[str, object] = {
            "replicas_total": len(reps),
            "replicas_ready": sum(r.state == "ready" for r in reps),
            "replicas_starting": sum(r.state == "starting"
                                     for r in reps),
            "replicas_retiring": sum(r.state == "retiring"
                                     for r in reps),
            "routers_total": len(routers),
            "routers_ready": sum(r.state == "ready" for r in routers),
        }
        out.update(counters)
        if self.alerts is not None:
            # fleet-scope alert states ride the router's /metrics under
            # fleet.alerts (the tier merge excludes "fleet", so the
            # block is never numeric-summed across sibling routers)
            out["alerts"] = self.alerts.snapshot()
        return out
