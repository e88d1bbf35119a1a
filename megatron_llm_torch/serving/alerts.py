"""SLO sentinel: declarative alerting over the serving fleet's metrics.

PRs 17-19 made the fleet deeply observable (loop goodput, cache
observatory, host-tier attribution) and the PR-13 supervisor *reacts*
to SLO pressure, but nothing decided "this is an incident", recorded
when it started and ended, or captured the evidence needed to debug it
afterwards — the operational-diagnosis gap MegaScale (arXiv:2402.15627
§5) calls the hard part of production-scale serving.  This module is
that layer:

* **Rules** are plain JSON-able dicts (so ``--alert_rules`` can replace
  the built-in :data:`DEFAULT_RULES` wholesale) of three kinds:

  - ``burn_rate`` — Google-SRE multi-window burn-rate alerts over the
    mergeable latency Histograms (telemetry.Histogram snapshots): the
    windowed fraction of observations over ``slo_secs``, divided by the
    error budget ``1 - objective``, must exceed ``burn_threshold`` on
    BOTH a fast window (default 1m — responsive) and a slow window
    (default 15m — flap-proof) to breach.  Windows are bucket-count
    deltas between timestamped snapshots of the lifetime histograms,
    never lifetime percentiles (which latch) and never summed
    percentiles (which lie).
  - ``threshold`` — instantaneous comparison on a dotted snapshot path
    (queue depth, host bubble %), with an optional ``guard_path`` /
    ``guard_min`` so a gauge only alerts once enough traffic backs it.
  - ``rate`` — windowed increase of a counter (restart/preemption
    storms), or a windowed ratio of two counters (error rate, cache
    hit collapse, mean host-tier swap-in seconds) with a ``min_den``
    traffic floor.

* **Lifecycle** is a per-rule state machine — ok → pending (breach
  observed) → firing (breach sustained ``for_secs``) → resolved (clear
  sustained ``clear_secs``) → ok — deduplicated by construction: one
  state per (rule, scope), so a breach that persists across many
  evaluations is one incident, not an event storm.  A ``max_firing``
  storm cap keeps a fleet-wide outage from writing bundles for every
  rule at once.

* On every firing/resolved transition the engine calls its
  ``transition_sink`` with an ``alert_transition`` payload (the host
  wraps it in the schema-13 JSONL envelope), optionally POSTs it to an
  ``--alert_webhook`` URL with bounded retry/backoff, and — on firing —
  calls ``bundle_fn`` to capture a postmortem bundle (the serving host
  wires this to ``telemetry.write_snapshot_bundle``; see
  ``tools/run_text_generation_server.py``).

* **Scopes**: each replica runs its own engine (scope = the replica)
  over its local ``/metrics`` snapshot; the fleet supervisor runs a
  second engine (scope="fleet") over the router's *merged* aggregate,
  whose histograms are bucket-wise sums — so fleet burn rates are
  recomputed from merged buckets, never summed percentiles.  The
  router itself merely unions per-replica alert states for display
  (``_merge_alert_blocks`` in router.py).

Everything here is host-side dict arithmetic on an evaluator thread
(``alert-eval``) — nothing enters a jitted program, so zero steady-state
recompiles hold with the evaluator enabled, and the per-evaluation cost
is tracked (``counters.eval_secs_total``) so tests can gate it under 2%
of a measured dispatch.  The module imports stdlib only (like
``supervisor.py`` / ``router.py``) so the control plane never pays a
jax import.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "AlertEngine", "DEFAULT_RULES", "normalize_rule", "parse_rules_arg",
]


# ---------------------------------------------------------------------------
# snapshot-path + histogram arithmetic (stdlib twins of telemetry.py's
# helpers, redeclared so this module needs no jax-importing import)
# ---------------------------------------------------------------------------

def _get_path(snap: Any, path: str) -> Any:
    """Resolve a dotted path ('engine.queue_depth') in a nested dict;
    None when any hop is missing — a rule over a path the deployment
    doesn't export (no engine, no host cache) is simply inactive."""
    cur = snap
    for part in path.split("."):
        if not isinstance(cur, dict):
            return None
        cur = cur.get(part)
    return cur


def _num(v: Any) -> Optional[float]:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return float(v)


def _is_hist(d: Any) -> bool:
    return (isinstance(d, dict) and "count" in d and "sum" in d
            and isinstance(d.get("buckets"), dict))


def _hist_delta(cur: Optional[dict], prev: Optional[dict]
                ) -> Optional[dict]:
    """Per-bucket delta of two lifetime histogram snapshots — the
    distribution observed *inside the window*.  Counts clamp at zero so
    a counter reset (engine restart) reads as an empty window, not a
    negative one."""
    if not _is_hist(cur):
        return None
    if not _is_hist(prev):
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


def _frac_over(delta: dict, slo_secs: float) -> Optional[float]:
    """Fraction of a windowed histogram's observations above the SLO.
    A bucket counts as good iff its upper bound <= slo (every value in
    it met the SLO); everything else — including +Inf — is bad.  SLOs
    should sit on a bucket bound (the defaults do) so the straddling
    bucket never misattributes."""
    total = int(delta.get("count") or 0)
    if total <= 0:
        return None
    good = 0
    for k, v in delta["buckets"].items():
        try:
            bound = float(k)
        except ValueError:
            continue        # +Inf: always bad
        if bound <= float(slo_secs) + 1e-12:
            good += int(v)
    return max(total - good, 0) / total


_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

#: Built-in rule set, replaced wholesale by ``--alert_rules``.  Paths are
#: relative to the replica /metrics snapshot (which is also the shape of
#: the router's fleet-merged ``aggregate``, so the same rules evaluate at
#: both scopes).  SLO seconds match serve_report's defaults (ttft 1.0,
#: tpot 0.25); burn_threshold 14.4 is the classic SRE page threshold
#: (burning a 30-day budget in ~2 days).
DEFAULT_RULES: List[Dict[str, Any]] = [
    {"name": "ttft_burn", "kind": "burn_rate",
     "path": "histograms.ttft_secs", "slo_secs": 1.0, "objective": 0.99,
     "severity": "page"},
    {"name": "tpot_burn", "kind": "burn_rate",
     "path": "histograms.tpot_secs", "slo_secs": 0.25, "objective": 0.99,
     "severity": "page"},
    {"name": "e2e_burn", "kind": "burn_rate",
     "path": "histograms.e2e_secs", "slo_secs": 10.0, "objective": 0.999,
     "severity": "page"},
    {"name": "error_rate", "kind": "rate",
     "num_path": "errors", "den_path": "requests",
     "window_secs": 120.0, "op": ">=", "value": 0.05, "min_den": 20,
     "clear_secs": 60.0, "severity": "page"},
    {"name": "queue_depth_high", "kind": "threshold",
     "path": "engine.queue_depth", "op": ">=", "value": 64.0,
     "for_secs": 30.0, "clear_secs": 30.0, "severity": "warn"},
    {"name": "host_bubble_high", "kind": "threshold",
     "path": "engine.loop.window.host_bubble_pct", "op": ">=",
     "value": 60.0, "guard_path": "engine.loop.window.dispatches",
     "guard_min": 50.0, "for_secs": 60.0, "clear_secs": 60.0,
     "severity": "warn"},
    {"name": "cache_hit_collapse", "kind": "rate",
     "num_path": "engine.cache.hits", "den_path": "engine.cache.probes",
     "window_secs": 300.0, "op": "<", "value": 0.05, "min_den": 200,
     "for_secs": 60.0, "clear_secs": 120.0, "severity": "warn"},
    {"name": "engine_restart_storm", "kind": "rate",
     "num_path": "engine.engine_restarts", "window_secs": 600.0,
     "op": ">=", "value": 3.0, "clear_secs": 300.0, "severity": "page"},
    {"name": "preemption_storm", "kind": "rate",
     "num_path": "engine.preemptions", "window_secs": 300.0,
     "op": ">=", "value": 50.0, "clear_secs": 120.0, "severity": "warn"},
    {"name": "host_swap_in_slow", "kind": "rate",
     "num_path": "engine.cache.host.swap_in_secs",
     "den_path": "engine.cache.host.swap_ins",
     "window_secs": 300.0, "op": ">", "value": 0.5, "min_den": 5,
     "clear_secs": 120.0, "severity": "warn"},
]

_RULE_DEFAULTS: Dict[str, Dict[str, Any]] = {
    # shared across kinds
    "": {"severity": "warn", "for_secs": 0.0, "clear_secs": 60.0},
    "burn_rate": {"objective": 0.99, "fast_window_secs": 60.0,
                  "slow_window_secs": 900.0, "burn_threshold": 14.4,
                  "min_count": 20},
    "threshold": {},
    "rate": {"min_den": 1},
}

_RULE_REQUIRED: Dict[str, Tuple[str, ...]] = {
    "burn_rate": ("path", "slo_secs"),
    "threshold": ("path", "op", "value"),
    "rate": ("num_path", "window_secs", "op", "value"),
}


def normalize_rule(rule: Dict[str, Any]) -> Dict[str, Any]:
    """Validate one rule dict and fill kind-appropriate defaults.
    Raises ValueError with an actionable message on malformed input —
    a bad ``--alert_rules`` file must fail loudly at startup, not
    silently never fire."""
    if not isinstance(rule, dict):
        raise ValueError(f"alert rule must be a JSON object, got "
                         f"{type(rule).__name__}")
    kind = rule.get("kind")
    if kind not in _RULE_REQUIRED:
        raise ValueError(
            f"alert rule {rule.get('name')!r}: unknown kind {kind!r} "
            f"(expected one of {sorted(_RULE_REQUIRED)})")
    name = rule.get("name")
    if not isinstance(name, str) or not name:
        raise ValueError(f"alert rule of kind {kind!r} needs a 'name'")
    missing = [k for k in _RULE_REQUIRED[kind] if k not in rule]
    if missing:
        raise ValueError(f"alert rule {name!r} (kind {kind}): missing "
                         f"required field(s) {missing}")
    out = dict(_RULE_DEFAULTS[""])
    out.update(_RULE_DEFAULTS[kind])
    out.update(rule)
    if "op" in out and out["op"] not in _OPS:
        raise ValueError(f"alert rule {name!r}: unknown op {out['op']!r} "
                         f"(expected one of {sorted(_OPS)})")
    return out


def parse_rules_arg(text: str
                    ) -> Tuple[List[Dict[str, Any]], Dict[str, Any]]:
    """Parse a ``--alert_rules`` value: inline JSON, or a path to a JSON
    file when the value doesn't start with '[' or '{'.  Accepts either
    a bare list of rules or ``{"interval_secs": ..., "rules": [...]}``;
    returns (normalized rules, engine-option overrides)."""
    s = text.strip()
    if not s.startswith("[") and not s.startswith("{"):
        with open(s) as f:
            s = f.read().strip()
    obj = json.loads(s)
    if isinstance(obj, list):
        return [normalize_rule(r) for r in obj], {}
    if isinstance(obj, dict) and isinstance(obj.get("rules"), list):
        opts = {k: v for k, v in obj.items() if k != "rules"}
        return [normalize_rule(r) for r in obj["rules"]], opts
    raise ValueError("--alert_rules must be a JSON list of rules or an "
                     "object with a 'rules' list")


# ---------------------------------------------------------------------------
# per-rule lifecycle state
# ---------------------------------------------------------------------------

class _AlertState:
    __slots__ = ("state", "since", "since_unix", "clear_since", "value",
                 "bundle")

    def __init__(self):
        self.state = "ok"               # ok | pending | firing
        self.since: Optional[float] = None      # clock() of entry
        self.since_unix: Optional[float] = None
        self.clear_since: Optional[float] = None
        self.value: Optional[float] = None
        self.bundle: Optional[str] = None


class AlertEngine:
    """Evaluates a rule set against a metrics snapshot on a cadence and
    drives the alert lifecycle.

    Thread shape: an ``alert-eval`` daemon thread calls
    :meth:`evaluate` every ``interval_secs`` (or the host pumps it
    directly — the supervisor does, from its control loop); HTTP
    handler threads read :meth:`snapshot`.  All shared state mutates
    under ``_lock``; blocking side effects (bundle capture, webhook
    POST, sink emission) happen strictly outside it."""

    # lint-enforced (graft-lint threads/TH001): the snapshot ring and
    # lifecycle states are written by the evaluator thread and read by
    # /metrics handler threads
    _lock_protected_ = {"_ring": "_lock", "_states": "_lock",
                        "counters": "_lock"}

    def __init__(self,
                 rules: Optional[List[Dict[str, Any]]] = None,
                 metrics_fn: Optional[Callable[[], dict]] = None,
                 scope: str = "replica",
                 clock: Callable[[], float] = time.monotonic,
                 interval_secs: float = 2.0,
                 transition_sink: Optional[Callable[[dict], None]] = None,
                 bundle_fn: Optional[Callable[[dict], Optional[str]]] = None,
                 webhook_url: Optional[str] = None,
                 webhook_timeout_secs: float = 2.0,
                 webhook_retries: int = 3,
                 max_firing: int = 10,
                 ring_size: int = 1024):
        self.rules = [normalize_rule(r)
                      for r in (DEFAULT_RULES if rules is None else rules)]
        names = [r["name"] for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate alert rule names: "
                             f"{sorted(n for n in set(names) if names.count(n) > 1)}")
        self.metrics_fn = metrics_fn
        self.scope = scope
        self.clock = clock
        self.interval_secs = float(interval_secs)
        self.transition_sink = transition_sink
        self.bundle_fn = bundle_fn
        self.webhook_url = webhook_url
        self.webhook_timeout_secs = float(webhook_timeout_secs)
        self.webhook_retries = int(webhook_retries)
        self.max_firing = int(max_firing)
        self._ring: "deque[Tuple[float, dict]]" = deque(
            maxlen=max(int(ring_size), 2))
        self._states: Dict[str, _AlertState] = {
            r["name"]: _AlertState() for r in self.rules}
        self.counters = {
            "evaluations": 0,
            "transitions_total": 0,
            "firing_total": 0,
            "resolved_total": 0,
            "bundles_written": 0,
            "bundle_errors": 0,
            "webhook_sent": 0,
            "webhook_errors": 0,
            "storm_suppressed": 0,
            "eval_secs_total": 0.0,
        }
        self._last_eval_secs = 0.0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="alert-eval", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=self.interval_secs + 5.0)
        self._thread = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.evaluate()
            except Exception:   # noqa: BLE001 - the sentinel never dies
                pass
            self._stop.wait(self.interval_secs)

    # -- evaluation ------------------------------------------------------

    def evaluate(self, snapshot: Optional[dict] = None,
                 now: Optional[float] = None) -> List[dict]:
        """One evaluation turn: sample metrics, update every rule's
        state machine, fire side effects.  Returns the transition
        payloads emitted (handy for tests and the supervisor)."""
        t0 = time.perf_counter()
        if snapshot is None:
            fn = self.metrics_fn
            if fn is None:
                return []
            try:
                snapshot = fn()
            except Exception:   # noqa: BLE001 - observation must not die
                return []
        if not isinstance(snapshot, dict):
            return []
        now = self.clock() if now is None else float(now)

        with self._lock:
            self._ring.append((now, snapshot))
            ring = list(self._ring)

        # pure arithmetic outside the lock: breach verdict per rule
        verdicts = []
        for rule in self.rules:
            breach, value = self._eval_rule(rule, snapshot, ring, now)
            verdicts.append((rule, breach, value))

        transitions: List[dict] = []
        capture: List[dict] = []        # firing payloads wanting a bundle
        with self._lock:
            firing_before = sum(1 for s in self._states.values()
                                if s.state == "firing")
            for rule, breach, value in verdicts:
                st = self._states[rule["name"]]
                st.value = value
                tr = self._step(rule, st, bool(breach), value, now)
                if tr is None:
                    continue
                transitions.append(tr)
                if tr["state"] == "firing":
                    if firing_before >= self.max_firing:
                        self.counters["storm_suppressed"] += 1
                        tr["storm_suppressed"] = True
                    elif self.bundle_fn is not None:
                        capture.append(tr)
                    firing_before += 1
            self.counters["evaluations"] += 1
            self.counters["transitions_total"] += len(transitions)
            self.counters["firing_total"] += sum(
                1 for t in transitions if t["state"] == "firing")
            self.counters["resolved_total"] += sum(
                1 for t in transitions if t["state"] == "resolved")

        # side effects outside the lock: bundle capture first so the
        # emitted firing record (and the /metrics block) carries the path
        for tr in capture:
            path = None
            try:
                path = self.bundle_fn(dict(tr))
            except Exception:   # noqa: BLE001 - forensics must not kill us
                path = None
            with self._lock:
                if path:
                    self.counters["bundles_written"] += 1
                    self._states[tr["rule"]].bundle = path
                else:
                    self.counters["bundle_errors"] += 1
            tr["bundle"] = path
        for tr in transitions:
            self._deliver(tr)

        dt = time.perf_counter() - t0
        with self._lock:
            self.counters["eval_secs_total"] += dt
            self._last_eval_secs = dt
        return transitions

    def _step(self, rule: dict, st: _AlertState, breach: bool,
              value: Optional[float], now: float) -> Optional[dict]:
        """Advance one rule's state machine; returns the transition
        payload to emit, or None.  Caller holds ``_lock``."""
        if st.state == "ok":
            if not breach:
                return None
            st.since, st.since_unix = now, time.time()
            st.clear_since = None
            if float(rule["for_secs"]) <= 0.0:
                st.state = "firing"
                st.bundle = None
                return self._payload(rule, st, "firing", value)
            st.state = "pending"
            return self._payload(rule, st, "pending", value)
        if st.state == "pending":
            if not breach:
                # never fired: flap suppressed, nothing to emit
                st.state, st.since, st.since_unix = "ok", None, None
                return None
            if now - (st.since or now) >= float(rule["for_secs"]):
                st.state = "firing"
                st.bundle = None
                return self._payload(rule, st, "firing", value)
            return None
        # firing
        if breach:
            st.clear_since = None
            return None
        if st.clear_since is None:
            st.clear_since = now
        if now - st.clear_since >= float(rule["clear_secs"]):
            tr = self._payload(rule, st, "resolved", value)
            st.state, st.since, st.since_unix = "ok", None, None
            st.clear_since, st.bundle = None, None
            return tr
        return None

    def _payload(self, rule: dict, st: _AlertState, state: str,
                 value: Optional[float]) -> dict:
        threshold, window = self._rule_threshold(rule)
        return {
            "event": "alert_transition",
            "rule": rule["name"],
            "scope": self.scope,
            "state": state,
            "severity": rule["severity"],
            "value": round(value, 6) if value is not None else None,
            "threshold": threshold,
            "window_secs": window,
            "since_unix": st.since_unix,
            "bundle": st.bundle,
        }

    @staticmethod
    def _rule_threshold(rule: dict
                        ) -> Tuple[Optional[float], Optional[float]]:
        if rule["kind"] == "burn_rate":
            return float(rule["burn_threshold"]), \
                float(rule["fast_window_secs"])
        if rule["kind"] == "rate":
            return float(rule["value"]), float(rule["window_secs"])
        return float(rule["value"]), None

    # -- rule arithmetic -------------------------------------------------

    def _window_sample(self, ring: List[Tuple[float, dict]], now: float,
                       window_secs: float) -> Optional[dict]:
        """Newest ring snapshot at least ``window_secs`` old — the
        window's 'before' edge.  None until enough history exists, so a
        fresh process cannot false-fire on a partial window."""
        best = None
        for t, snap in ring:            # oldest -> newest
            if now - t >= float(window_secs):
                best = snap
            else:
                break
        return best

    def _eval_rule(self, rule: dict, snapshot: dict,
                   ring: List[Tuple[float, dict]], now: float
                   ) -> Tuple[Optional[bool], Optional[float]]:
        kind = rule["kind"]
        if kind == "threshold":
            v = _num(_get_path(snapshot, rule["path"]))
            if v is None:
                return None, None
            gp = rule.get("guard_path")
            if gp is not None:
                g = _num(_get_path(snapshot, gp))
                if g is None or g < float(rule.get("guard_min", 0)):
                    return None, v
            return _OPS[rule["op"]](v, float(rule["value"])), v
        if kind == "rate":
            return self._eval_rate(rule, snapshot, ring, now)
        return self._eval_burn(rule, snapshot, ring, now)

    def _eval_rate(self, rule, snapshot, ring, now):
        prev = self._window_sample(ring, now, rule["window_secs"])
        if prev is None:
            return None, None
        n1 = _num(_get_path(snapshot, rule["num_path"]))
        n0 = _num(_get_path(prev, rule["num_path"]))
        if n1 is None or n0 is None:
            return None, None
        dn = n1 - n0
        if dn < 0:                      # counter reset (restart)
            dn = n1
        den_path = rule.get("den_path")
        if den_path is None:
            value = dn
        else:
            d1 = _num(_get_path(snapshot, den_path))
            d0 = _num(_get_path(prev, den_path))
            if d1 is None or d0 is None:
                return None, None
            dd = d1 - d0
            if dd < 0:
                dd = d1
            if dd < float(rule["min_den"]) or dd <= 0:
                return None, None       # too little traffic to judge
            value = dn / dd
        return _OPS[rule["op"]](value, float(rule["value"])), value

    def _eval_burn(self, rule, snapshot, ring, now):
        cur = _get_path(snapshot, rule["path"])
        if not _is_hist(cur):
            return None, None
        budget = max(1.0 - float(rule["objective"]), 1e-9)
        burns = []
        for window in (rule["fast_window_secs"], rule["slow_window_secs"]):
            prev_snap = self._window_sample(ring, now, window)
            if prev_snap is None:
                return None, None       # not enough history yet
            delta = _hist_delta(cur, _get_path(prev_snap, rule["path"]))
            if delta is None or int(delta.get("count") or 0) \
                    < int(rule["min_count"]):
                return None, None       # too little traffic to judge
            frac = _frac_over(delta, rule["slo_secs"])
            if frac is None:
                return None, None
            burns.append(frac / budget)
        fast, slow = burns
        thr = float(rule["burn_threshold"])
        return (fast >= thr and slow >= thr), fast

    # -- surfaces --------------------------------------------------------

    def snapshot(self) -> dict:
        """The ``alerts`` block for /metrics: current firing/pending
        states plus engine counters.  The lists are merged explicitly by
        the router (never numeric-summed); the counters fleet-sum like
        every other serving counter."""
        with self._lock:
            firing, pending = [], []
            for rule in self.rules:
                st = self._states[rule["name"]]
                if st.state == "firing":
                    threshold, window = self._rule_threshold(rule)
                    firing.append({
                        "rule": rule["name"], "scope": self.scope,
                        "severity": rule["severity"],
                        "since_unix": st.since_unix,
                        "value": round(st.value, 6)
                        if st.value is not None else None,
                        "threshold": threshold,
                        "window_secs": window,
                        "bundle": st.bundle,
                    })
                elif st.state == "pending":
                    pending.append({
                        "rule": rule["name"], "scope": self.scope,
                        "severity": rule["severity"],
                        "since_unix": st.since_unix,
                        "value": round(st.value, 6)
                        if st.value is not None else None,
                    })
            counters = dict(self.counters)
            counters["eval_secs_total"] = round(
                counters["eval_secs_total"], 6)
            last = self._last_eval_secs
        return {
            "firing": firing,
            "pending": pending,
            "rules_total": len(self.rules),
            "firing_count": len(firing),
            "last_eval_secs": round(last, 6),
            "counters": counters,
        }

    # -- delivery --------------------------------------------------------

    def _deliver(self, payload: dict) -> None:
        """Emit one transition to the sink and (firing/resolved only)
        the webhook.  Runs outside ``_lock``; never raises."""
        sink = self.transition_sink
        if sink is not None:
            try:
                sink(dict(payload))
            except Exception:   # noqa: BLE001 - events must not kill us
                pass
        if self.webhook_url and payload["state"] in ("firing", "resolved") \
                and not payload.get("storm_suppressed"):
            self._post_webhook(payload)

    def _post_webhook(self, payload: dict) -> None:
        body = json.dumps(payload).encode()
        delay = 0.25
        for attempt in range(max(self.webhook_retries, 1)):
            try:
                req = urllib.request.Request(
                    self.webhook_url, data=body,
                    headers={"Content-Type": "application/json"},
                    method="POST")
                with urllib.request.urlopen(
                        req, timeout=self.webhook_timeout_secs):
                    pass
                with self._lock:
                    self.counters["webhook_sent"] += 1
                return
            except Exception:   # noqa: BLE001 - delivery is best-effort
                if attempt + 1 < max(self.webhook_retries, 1):
                    time.sleep(delay)
                    delay *= 2
        with self._lock:
            self.counters["webhook_errors"] += 1


def merge_alert_blocks(per_scope: Dict[str, Optional[dict]]) -> dict:
    """Union per-replica ``alerts`` blocks into one fleet view: firing/
    pending entries concatenate (each already carries its scope; the
    caller rewrites it to the replica URL), counters sum.  Used by the
    router's aggregated /metrics — alert *states* are facts about a
    replica and must never be numeric-summed or averaged."""
    firing: List[dict] = []
    pending: List[dict] = []
    counters: Dict[str, float] = {}
    rules_total = 0
    for scope, block in sorted(per_scope.items()):
        if not isinstance(block, dict):
            continue
        for entry in block.get("firing") or []:
            if isinstance(entry, dict):
                e = dict(entry)
                e["scope"] = scope
                firing.append(e)
        for entry in block.get("pending") or []:
            if isinstance(entry, dict):
                e = dict(entry)
                e["scope"] = scope
                pending.append(e)
        rules_total = max(rules_total, int(block.get("rules_total") or 0))
        for k, v in (block.get("counters") or {}).items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                counters[k] = counters.get(k, 0) + v
    firing.sort(key=lambda e: (e.get("rule") or "", e.get("scope") or ""))
    pending.sort(key=lambda e: (e.get("rule") or "", e.get("scope") or ""))
    return {
        "firing": firing,
        "pending": pending,
        "rules_total": rules_total,
        "firing_count": len(firing),
        "counters": counters,
    }
