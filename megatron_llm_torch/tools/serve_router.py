#!/usr/bin/env python
"""Run the multi-replica serving router over the port's replicas (the
twin of the repo's ``tools/serve_router.py``, with its flags, on the
port's ``serving/router.py`` and ``tracing.py``).

Start N engine replicas (one per card or host) with the port's server,
then put this front-end over them:

    python -m megatron_llm_torch.run_text_generation_server \
        --model_name llama2 --serve_engine ... --port 5000 &
    python -m megatron_llm_torch.run_text_generation_server \
        --model_name llama2 --serve_engine ... --port 5001 &
    python -m megatron_llm_torch.tools.serve_router \
        --backends localhost:5000,localhost:5001

Clients (and ``tools/serve_bench.py``) point at the router exactly as
they would a single server: PUT /api, PUT /api/stream, GET /health,
GET /metrics (JSON or Prometheus).  See docs/guide/serving.md,
"Running a replica fleet".

Routers are stateless and shard-nothing: run several of them over the
same replicas (give each the others via ``--peers``, or let
``megatron_llm_torch.tools.serve_fleet --routers N`` manage the tier) and
they agree on
prefix affinity through rendezvous hashing alone.  ``--dynamic`` starts
with zero backends for supervisor-managed membership (POST
/admin/backends).  See docs/guide/serving.md, "Sharded front door".
"""

import argparse
import os
import signal
import sys

# run as a file (the fleet's router tier does), the repo root must be
# importable
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--backends", default="",
                   help="comma-separated replica addresses "
                        "(host:port[,host:port...])")
    p.add_argument("--peers", default="",
                   help="comma-separated sibling-router addresses; any "
                        "router then answers fleet-wide /metrics by "
                        "merging its peers' histograms")
    p.add_argument("--router_id", default=None,
                   help="stable id stamped into /metrics and fleet "
                        "events (default: random)")
    p.add_argument("--dynamic", action="store_true",
                   help="allow starting with zero backends; membership "
                        "arrives via POST /admin/backends (the "
                        "serve_fleet supervisor does this)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--fail_threshold", type=int, default=3,
                   help="consecutive transport failures before a replica "
                        "is circuit-broken")
    p.add_argument("--breaker_backoff_secs", "--cooldown_secs",
                   dest="breaker_backoff_secs", type=float, default=1.0,
                   help="initial breaker cooldown (doubles per trip)")
    p.add_argument("--max_cooldown_secs", type=float, default=30.0)
    p.add_argument("--probe_interval_secs", "--health_interval_secs",
                   dest="probe_interval_secs", type=float, default=2.0,
                   help="background /health probe period")
    p.add_argument("--affinity_chars", type=int, default=256,
                   help="prompt prefix length keying session affinity")
    p.add_argument("--affinity_max", type=int, default=4096,
                   help="max tracked affinity entries (LRU beyond)")
    p.add_argument("--request_timeout_secs", type=float, default=600.0)
    p.add_argument("--trace_dir", default=None,
                   help="record router-side Chrome spans (route_request, "
                        "route_stream, failover) keyed by X-Request-Trace "
                        "ids; merge with replica traces via "
                        "tools/trace_report.py --merge")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from megatron_llm_torch.serving.router import ReplicaRouter, RouterServer

    # the router module itself stays stdlib-pure; span recording is an
    # opt-in that pulls in the tracing machinery only when requested
    tracer = None
    if args.trace_dir:
        from megatron_llm_torch.tracing import (SpanTracer, Tracing,
                                                start_trace_flusher)
        tracer = SpanTracer()
        start_trace_flusher(Tracing(tracer=tracer,
                                    trace_dir=args.trace_dir))

    # whitespace-only entries ("a:1,, b:2 ,") are stripped, not passed
    # through as malformed URLs
    backends = [u.strip() for u in args.backends.split(",") if u.strip()]
    if not backends and not args.dynamic:
        print("serve_router: --backends needs at least one replica "
              "address; pass --dynamic for supervisor-managed "
              "membership, or use megatron_llm_torch.tools.serve_fleet",
              file=sys.stderr)
        raise SystemExit(2)
    router = ReplicaRouter(
        backends,
        fail_threshold=args.fail_threshold,
        cooldown_secs=args.breaker_backoff_secs,
        max_cooldown_secs=args.max_cooldown_secs,
        affinity_chars=args.affinity_chars,
        affinity_max=args.affinity_max,
        health_interval_secs=args.probe_interval_secs,
        request_timeout_secs=args.request_timeout_secs,
        tracer=tracer,
        router_id=args.router_id,
    )
    peers = [u.strip() for u in args.peers.split(",") if u.strip()]
    if peers:
        router.set_peers(peers)
    server = RouterServer(router)

    # deterministic teardown: stop the health prober, then break
    # serve_forever (today the probe thread dies whenever the process
    # does — SIGTERM should be a clean exit, not a daemon-thread race)
    signal.signal(signal.SIGTERM, lambda *_: server.shutdown())
    server.run(host=args.host, port=args.port)


if __name__ == "__main__":
    sys.exit(main())
