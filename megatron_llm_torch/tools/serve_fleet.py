#!/usr/bin/env python
"""Run a supervised, autoscaling fleet of the port's replicas behind the
router (the twin of the repo's ``tools/serve_fleet.py``, with its flags,
on the port's ``serving/router.py`` and ``serving/supervisor.py``).

One process: the multi-replica router plus the fleet supervisor driving
a local subprocess backend.  Replicas are spawned from ``--replica_cmd``
— any command that prints ``PORT <n>`` on stdout once its HTTP server
accepts, as the port's server does with ``--port 0``:

    python -m megatron_llm_torch.tools.serve_fleet \\
        --replica_cmd "python -m megatron_llm_torch.run_text_generation_server \\
            --model_name llama2 --bf16 --load ckpt/ --serve_engine --port 0" \\
        --min_replicas 1 --max_replicas 4 \\
        --ttft_p95_slo_secs 0.8 --port 8000

The supervisor registers each replica with the router when it reports
ready, respawns dead ones with capped exponential backoff, scales up on
a sustained p95-TTFT / queue-depth breach, scales down by draining the
coldest replica when sustained-idle, and sheds load with honest 429s
(brownout) while new capacity boots.  Clients point at the router
exactly as at a single server: PUT /api, PUT /api/stream, GET /health,
GET /metrics (which now includes a ``fleet`` block and per-event JSONL
via --fleet_event_log).  See docs/guide/fault_tolerance.md, "Fleet
supervision & autoscaling".

With ``--routers N`` the front door itself is sharded: instead of one
in-process router, the supervisor spawns N
``megatron_llm_torch/tools/serve_router.py --dynamic`` subprocesses, keeps
their peer lists + replica membership synchronized through
``RouterTierClient``, respawns dead routers with the same storm-capped
backoff replicas get, and scales the tier on front-door saturation.  Each router prints ``ROUTER <url>`` on our
stdout as it becomes ready; clients hold the whole list and retry a
sibling on transport error (``serve_bench.py --url ... --url ...``).
See docs/guide/serving.md, "Sharded front door".

For real orchestrators (k8s, GCE MIGs), implement
``megatron_llm_torch.serving.supervisor.ReplicaBackend``
(spawn/poll/kill) and reuse ``FleetSupervisor`` unchanged — the policy
never knows what a process is.
"""

import argparse
import os
import shlex
import signal
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--replica_cmd", required=True,
                   help="command spawning ONE replica that prints "
                        "'PORT <n>' on stdout when ready (use --port 0 "
                        "so replicas pick free ports)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    # fleet size
    p.add_argument("--initial_replicas", type=int, default=0,
                   help="replicas spawned at startup (0 = min_replicas)")
    p.add_argument("--min_replicas", type=int, default=1)
    p.add_argument("--max_replicas", type=int, default=4)
    # SLO-driven scaling policy
    p.add_argument("--ttft_p95_slo_secs", type=float, default=1.0,
                   help="scale up when windowed p95 TTFT sustains above "
                        "this")
    p.add_argument("--queue_depth_high", type=int, default=16,
                   help="scale up when the fleet-summed engine queue "
                        "depth sustains at/above this")
    p.add_argument("--breach_secs", type=float, default=2.0,
                   help="how long a breach must sustain before scale-up")
    p.add_argument("--scale_cooldown_secs", type=float, default=30.0,
                   help="minimum gap between scaling actions")
    p.add_argument("--scale_down_idle_secs", type=float, default=60.0,
                   help="how long the fleet must be idle before the "
                        "coldest replica is drained")
    p.add_argument("--scale_down_ttft_frac", type=float, default=0.5,
                   help="hysteresis: idle means p95 below this fraction "
                        "of the SLO (between frac*SLO and SLO nothing "
                        "moves)")
    # self-healing
    p.add_argument("--respawn_backoff_secs", type=float, default=1.0)
    p.add_argument("--respawn_backoff_max_secs", type=float, default=30.0)
    p.add_argument("--respawn_storm_window_secs", type=float,
                   default=60.0,
                   help="deaths inside this window double the backoff; "
                        "outside it the backoff resets")
    p.add_argument("--dead_confirmation_secs", type=float, default=3.0,
                   help="a breaker-open replica (process still up) must "
                        "stay dead this long before it is respawned")
    p.add_argument("--poll_interval_secs", type=float, default=1.0,
                   help="supervisor control-loop period")
    p.add_argument("--spawn_eta_secs", type=float, default=60.0,
                   help="prior for spawn->ready time (brownout "
                        "retry_after until observed spawns refine it)")
    # router knobs (mirror serve_router)
    p.add_argument("--fail_threshold", type=int, default=3)
    p.add_argument("--cooldown_secs", type=float, default=1.0)
    p.add_argument("--max_cooldown_secs", type=float, default=30.0)
    p.add_argument("--probe_interval_secs", type=float, default=2.0,
                   help="background /health probe period")
    p.add_argument("--affinity_chars", type=int, default=256)
    p.add_argument("--affinity_max", type=int, default=4096)
    p.add_argument("--request_timeout_secs", type=float, default=600.0)
    # sharded front door (0 = legacy single in-process router)
    p.add_argument("--routers", type=int, default=0,
                   help="run N stateless router subprocesses instead of "
                        "one in-process router; they agree on affinity "
                        "via rendezvous hashing and any of them answers "
                        "fleet-wide /metrics")
    p.add_argument("--max_routers", type=int, default=0,
                   help="router-tier scale-up ceiling (default: "
                        "--routers, i.e. a fixed-size tier)")
    p.add_argument("--router_dispatch_p95_slo_secs", type=float,
                   default=0.25,
                   help="scale the router tier up when the windowed "
                        "dispatch-loop p95 sustains above this")
    p.add_argument("--router_inflight_high", type=int, default=64,
                   help="...or when the summed router in-flight "
                        "(connection-queue proxy) sustains at/above "
                        "this")
    # observability
    p.add_argument("--fleet_event_log", default=None,
                   help="append fleet events (replica_spawned/died/"
                        "respawned, scale_up/down, brownout) as JSONL "
                        "here; tools/serve_report.py renders a timeline")
    return p.parse_args(argv)


def _router_tier_argv(args):
    """Command for ONE router subprocess (free port, supervisor-managed
    membership), forwarding the shared router knobs."""
    return [
        sys.executable,
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "serve_router.py"),
        "--dynamic", "--host", "127.0.0.1", "--port", "0",
        "--fail_threshold", str(args.fail_threshold),
        "--breaker_backoff_secs", str(args.cooldown_secs),
        "--max_cooldown_secs", str(args.max_cooldown_secs),
        "--probe_interval_secs", str(args.probe_interval_secs),
        "--affinity_chars", str(args.affinity_chars),
        "--affinity_max", str(args.affinity_max),
        "--request_timeout_secs", str(args.request_timeout_secs),
    ]


def main(argv=None):
    args = parse_args(argv)
    from megatron_llm_torch.serving.router import ReplicaRouter, RouterServer
    from megatron_llm_torch.serving.supervisor import (
        FleetSupervisor,
        LocalProcessBackend,
        PolicyConfig,
        RouterTierClient,
    )

    tier = max(args.routers, 0)
    router_backend = None
    if tier > 0:
        router = RouterTierClient()
        router_backend = LocalProcessBackend(
            _router_tier_argv(args),
            spawn_eta_secs=30.0,
            stderr=None,                # routers share our stderr
        )
    else:
        router = ReplicaRouter(
            [],                         # membership is the supervisor's
            fail_threshold=args.fail_threshold,
            cooldown_secs=args.cooldown_secs,
            max_cooldown_secs=args.max_cooldown_secs,
            affinity_chars=args.affinity_chars,
            affinity_max=args.affinity_max,
            health_interval_secs=args.probe_interval_secs,
            request_timeout_secs=args.request_timeout_secs,
        )
    backend = LocalProcessBackend(
        shlex.split(args.replica_cmd),
        spawn_eta_secs=args.spawn_eta_secs,
        stderr=None,                    # replicas share our stderr
    )
    cfg = PolicyConfig(
        ttft_p95_slo_secs=args.ttft_p95_slo_secs,
        queue_depth_high=args.queue_depth_high,
        breach_secs=args.breach_secs,
        scale_cooldown_secs=args.scale_cooldown_secs,
        scale_down_idle_secs=args.scale_down_idle_secs,
        scale_down_ttft_frac=args.scale_down_ttft_frac,
        min_replicas=args.min_replicas,
        max_replicas=args.max_replicas,
        respawn_backoff_secs=args.respawn_backoff_secs,
        respawn_backoff_max_secs=args.respawn_backoff_max_secs,
        respawn_storm_window_secs=args.respawn_storm_window_secs,
        dead_confirmation_secs=args.dead_confirmation_secs,
        min_routers=tier,
        max_routers=max(args.max_routers, tier),
        router_dispatch_p95_slo_secs=args.router_dispatch_p95_slo_secs,
        router_inflight_high=args.router_inflight_high,
    )
    supervisor = FleetSupervisor(
        router, backend, config=cfg,
        poll_interval_secs=args.poll_interval_secs,
        event_log_path=args.fleet_event_log,
        router_backend=router_backend,
    )
    supervisor.spawn_initial(args.initial_replicas or args.min_replicas)
    if tier > 0:
        supervisor.spawn_initial_routers(tier)
    supervisor.start()

    if tier > 0:
        # no local HTTP server: the subprocess routers ARE the front
        # door.  Announce each as it becomes ready and block until a
        # signal; clients keep the whole list and retry siblings.
        import threading
        stop = threading.Event()
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
        signal.signal(signal.SIGINT, lambda *_: stop.set())
        announced = set()
        try:
            while not stop.wait(0.5):
                for url in supervisor.router_urls():
                    if url not in announced:
                        announced.add(url)
                        print(f"ROUTER {url}", flush=True)
        finally:
            supervisor.stop(kill_replicas=True)
        return 0

    server = RouterServer(router)

    def _term(signum, frame):
        server.shutdown()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    try:
        server.run(host=args.host, port=args.port)
    finally:
        supervisor.stop(kill_replicas=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
