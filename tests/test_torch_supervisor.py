"""The port's fleet supervisor (``megatron_llm_torch/serving/supervisor.py``)
against the JAX package's, and over real port replicas on the CPU:

* ``ScalingPolicy``: the decisions of the port's and the JAX package's
  policies equal, snapshot by snapshot, over the scripted timelines of
  ``tests/test_serve_supervisor.py`` (sustained and blipped breaches,
  queue depth, spawns in flight, the replica cap, cooldowns, the
  hysteresis band, the coldest replica's drain, the replica floor,
  respawn backoff in and out of a storm, the breaker's confirmation
  window, retiring and starting replicas) and over a long random
  timeline from a seeded fake clock;
* the windowed p95 (``_hist_delta``, ``_histogram_percentile``) equal;
* one test with real replicas: ``LocalProcessBackend`` spawns two of the
  port's servers (``python -m megatron_llm_torch.run_text_generation_server
  ... --serve_engine --port 0``, which write ``PORT <n>``); a SIGKILL of
  one while 12 requests run loses none, and the dead slot is respawned
  under its own name.  Every process is killed and reaped.
"""

import json
import os
import signal
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from megatron_llm_tpu.serving import supervisor as js
from megatron_llm_torch.serving import supervisor as ts
from megatron_llm_torch.serving.router import ReplicaRouter, RouterServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BASE = dict(ttft_p95_slo_secs=1.0, queue_depth_high=10, breach_secs=2.0,
            scale_cooldown_secs=30.0, scale_down_idle_secs=60.0,
            scale_down_ttft_frac=0.5, min_replicas=1, max_replicas=3,
            respawn_backoff_secs=1.0, respawn_backoff_max_secs=8.0,
            respawn_storm_window_secs=60.0, dead_confirmation_secs=3.0)


def R(slot, state="ready", **kw):
    """A replica as a plain spec, built into either package's
    ReplicaInfo."""
    return dict(slot=slot, url=f"http://x/{slot}", state=state, **kw)


def _run(mod, cfg, timeline):
    pol = mod.ScalingPolicy(mod.PolicyConfig(**dict(BASE, **cfg)))
    out = []
    for now, reps, kw in timeline:
        snap = mod.FleetSnapshot(
            now=now, replicas=[mod.ReplicaInfo(**r) for r in reps], **kw)
        out.append([(type(a).__name__, vars(a)) for a in pol.decide(snap)])
    return out


ONE = [R("replica-0")]
TWO = [R("replica-0"), R("replica-1")]

SCENARIOS = {
    "sustained_breach": ({}, [(t, ONE, dict(ttft_p95_secs=2.0))
                              for t in (0.0, 1.0, 2.0)]),
    "breach_blip": ({}, [(0.0, ONE, dict(ttft_p95_secs=2.0)),
                         (1.0, ONE, dict(ttft_p95_secs=0.8)),
                         (2.0, ONE, dict(ttft_p95_secs=2.0)),
                         (3.0, ONE, dict(ttft_p95_secs=2.0)),
                         (4.0, ONE, dict(ttft_p95_secs=2.0))]),
    "queue_depth": ({}, [(0.0, ONE, dict(queue_depth=50)),
                         (2.0, ONE, dict(queue_depth=50))]),
    "spawn_in_flight": ({}, [
        (0.0, ONE, dict(ttft_p95_secs=2.0, spawns_in_flight=1)),
        (5.0, ONE, dict(ttft_p95_secs=2.0, spawns_in_flight=1)),
        (6.0, TWO, dict(ttft_p95_secs=2.0))]),
    "capped": (dict(max_replicas=2), [(0.0, TWO, dict(ttft_p95_secs=2.0)),
                                      (10.0, TWO, dict(ttft_p95_secs=2.0))]),
    "cooldown": ({}, [(0.0, ONE, dict(ttft_p95_secs=2.0)),
                      (2.0, ONE, dict(ttft_p95_secs=2.0)),
                      (3.0, TWO, dict(ttft_p95_secs=2.0)),
                      (10.0, TWO, dict(ttft_p95_secs=2.0)),
                      (31.0, TWO, dict(ttft_p95_secs=2.0)),
                      (33.0, TWO, dict(ttft_p95_secs=2.0))]),
    "hysteresis_band": (dict(scale_cooldown_secs=0.0), [
        (float(t), TWO, dict(ttft_p95_secs=0.95 if t % 2 else 0.6))
        for t in range(60)] + [
        (float(t), TWO, dict(ttft_p95_secs=1.5 if t % 2 else 0.3))
        for t in range(60, 120)]),
    "coldest_drained": (dict(scale_down_idle_secs=10.0,
                             scale_cooldown_secs=0.0), [
        (0.0, [R("replica-0", affinity_entries=5),
               R("replica-1", affinity_entries=1),
               R("replica-2", affinity_entries=3)],
         dict(ttft_p95_secs=0.1)),
        (10.0, [R("replica-0", affinity_entries=5),
                R("replica-1", affinity_entries=1),
                R("replica-2", affinity_entries=3)],
         dict(ttft_p95_secs=0.1)),
        (11.0, [R("replica-0", affinity_entries=1, in_flight=2),
                R("replica-2", affinity_entries=1)], {}),
        (30.0, [R("replica-0", affinity_entries=1, in_flight=2),
                R("replica-2", affinity_entries=1)], {})]),
    "floor": (dict(scale_down_idle_secs=10.0, scale_cooldown_secs=0.0),
              [(0.0, ONE, {}), (100.0, ONE, {})]),
    "respawn_storm": ({}, [
        (t, [R("replica-0", state="dead", process_dead=True)], {})
        for t in (0.0, 0.5, 1.5, 4.0, 8.5, 17.0, 77.0)]),
    "breaker_confirmation": (dict(dead_confirmation_secs=3.0), [
        (t, [R("replica-0", state="dead", dead_since=99.0)], {})
        for t in (100.0, 102.0)]),
    "retiring_and_starting": ({}, [
        (0.0, [R("replica-0", state="retiring", process_dead=True),
               R("replica-1", state="starting")], {})]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scaling_decisions_equal_jax(name):
    cfg, timeline = SCENARIOS[name]
    got = _run(ts, cfg, timeline)
    assert got == _run(js, cfg, timeline)
    # the scenarios where the right decision is to do nothing
    assert any(got) or name in ("capped", "floor", "hysteresis_band",
                                "retiring_and_starting")


def test_scaling_decisions_equal_jax_on_a_random_timeline():
    """500 snapshots from a seeded fake clock: replicas come, go, die and
    retire, with p95, queue depth and spawns drawn at random."""
    rng = np.random.default_rng(7)
    states = ["ready", "ready", "ready", "dead", "starting", "retiring",
              "draining"]
    timeline, now = [], 0.0
    for _ in range(500):
        now += float(rng.choice([0.25, 0.5, 1.0, 5.0, 20.0]))
        reps = []
        for i in range(int(rng.integers(1, 5))):
            st = str(rng.choice(states))
            reps.append(R(f"replica-{i}", state=st,
                          affinity_entries=int(rng.integers(0, 9)),
                          in_flight=int(rng.integers(0, 4)),
                          process_dead=bool(st == "dead"
                                            and rng.random() < 0.5),
                          dead_since=(now - float(rng.random() * 6)
                                      if st == "dead" else None)))
        kw = dict(ttft_p95_secs=(None if rng.random() < 0.2
                                 else float(rng.exponential(1.0))),
                  queue_depth=int(rng.integers(0, 14)),
                  spawns_in_flight=int(rng.random() < 0.2))
        timeline.append((now, reps, kw))
    got = _run(ts, dict(scale_cooldown_secs=10.0, scale_down_idle_secs=8.0,
                        max_replicas=4), timeline)
    assert got == _run(js, dict(scale_cooldown_secs=10.0,
                                scale_down_idle_secs=8.0, max_replicas=4),
                       timeline)
    assert sum(map(len, got)) > 20


def test_windowed_p95_equal_jax():
    rng = np.random.default_rng(3)
    bounds = ["0.05", "0.1", "0.25", "0.5", "1", "2.5", "+Inf"]
    prev = {"buckets": {b: 0 for b in bounds}, "count": 0, "sum": 0.0}
    for _ in range(50):
        cur = {"buckets": {b: prev["buckets"][b] + int(rng.integers(0, 9))
                           for b in bounds}, "sum": prev["sum"] + 1.0}
        cur["count"] = sum(cur["buckets"].values())
        got, want = ts._hist_delta(cur, prev), js._hist_delta(cur, prev)
        assert got == want
        for q in (0.5, 0.95):
            assert ts._histogram_percentile(got, q) == \
                js._histogram_percentile(want, q)
        prev = cur
    assert ts._hist_delta(None, prev) is None
    assert ts._histogram_percentile(None, 0.95) is None


REPLICA = [sys.executable, "-m",
           "megatron_llm_torch.run_text_generation_server",
           "--model_name", "llama2", "--num_layers", "2", "--hidden_size",
           "64", "--num_attention_heads", "4", "--ffn_hidden_size", "96",
           "--vocab_size", "64", "--seq_length", "128",
           "--max_position_embeddings", "128", "--device", "cpu",
           "--serve_num_slots", "4", "--serve_block_size", "8",
           "--serve_prefill_chunk", "16", "--seed", "0", "--serve_engine",
           "--serve_alerts", "0", "--host", "127.0.0.1", "--port", "0"]


def _wait(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out: {what}"
        time.sleep(0.1)


def test_sigkill_of_a_port_replica_loses_no_request_and_respawns():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    backend = ts.LocalProcessBackend(REPLICA, env=env, cwd=REPO,
                                     spawn_eta_secs=30.0)
    router = ReplicaRouter([], fail_threshold=2, cooldown_secs=5.0,
                           health_interval_secs=0.5,
                           request_timeout_secs=60.0)
    sup = ts.FleetSupervisor(router, backend, config=ts.PolicyConfig(
        ttft_p95_slo_secs=1e9, queue_depth_high=10 ** 9,
        scale_cooldown_secs=3600.0, scale_down_idle_secs=3600.0,
        min_replicas=2, max_replicas=2, respawn_backoff_secs=0.2,
        dead_confirmation_secs=5.0), poll_interval_secs=0.25)
    front = RouterServer(router)
    procs = []
    try:
        sup.spawn_initial(2)
        sup.start()
        _wait(lambda: router.snapshot()["backends_total"] == 2, 60,
              "two replicas ready")
        procs += [r.handle.proc for r in sup.replicas.values()]
        threading.Thread(target=front.run, kwargs={"host": "127.0.0.1",
                                                   "port": 0},
                         daemon=True).start()
        _wait(lambda: front.httpd is not None, 10, "the router binds")
        url = f"http://127.0.0.1:{front.httpd.server_address[1]}/api"
        victim = sup.replicas["replica-0"].handle.proc
        results = []

        def client(i):
            req = urllib.request.Request(url, data=json.dumps({
                "prompts": [f"{i} " + " ".join(["2"] * 30)],
                "tokens_to_generate": 24, "temperature": 0.0}).encode(),
                method="PUT")
            with urllib.request.urlopen(req, timeout=60) as resp:
                results.append((i, resp.status))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        victim.send_signal(signal.SIGKILL)
        for t in threads:
            t.join(60)
        assert sorted(results) == [(i, 200) for i in range(12)]
        _wait(lambda: sup.counters["respawns_total"] >= 1
              and router.snapshot()["backends_total"] == 2, 60,
              "the respawn")
        procs += [r.handle.proc for r in sup.replicas.values()]
        assert sup.replicas["replica-0"].state == "ready"
        names = [(e["event"], e.get("slot")) for e in sup.events]
        assert ("replica_died", "replica-0") in names
        assert ("replica_respawned", "replica-0") in names
    finally:
        if front.httpd is not None:
            front.shutdown()
            front.httpd.server_close()
        sup.stop(kill_replicas=True)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(30)
