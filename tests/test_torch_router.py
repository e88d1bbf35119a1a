"""The port's router (``megatron_llm_torch/serving/router.py``) against the
JAX package's, and in front of the port's replicas on the CPU:

* the affinity digest of 1000 prompts (numpy-seeded) equal to the JAX
  router's and to the port's ``kv_blocks`` chain, and their rendezvous
  picks equal to the JAX router's over live sets that grow and shrink;
* merged histograms: ``_sum_numeric`` over replica snapshots made by the
  port's ``telemetry.Histogram`` equal to the JAX router's merge, and the
  percentiles of the merge equal;
* a ``RouterServer`` over two in-process port servers (tiny Llama,
  ``--serve_engine``): ``PUT /api`` through it answers as a replica
  does, a shared prefix lands on the replica its rendezvous order puts
  first, the merged ``/metrics`` request counts are the sums of the
  replicas' own, and ``tools/serve_top.py --once`` reads the router.
"""

import json
import os
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest

from megatron_llm_tpu.serving import router as jr
from megatron_llm_torch import telemetry
from megatron_llm_torch.serving import kv_blocks
from megatron_llm_torch.serving import router as tr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        words = rng.integers(0, 1000, rng.integers(1, 200))
        out.append(" ".join(map(str, words)))
    return out


def _urls(n, seed=0):
    rng = np.random.default_rng(seed)
    return [f"http://10.0.{i}.{rng.integers(1, 255)}:{5000 + i}"
            for i in range(n)]


def test_affinity_digests_equal_jax_and_kv_blocks():
    for prompt in _prompts(1000):
        got = tr._prompt_affinity_digest(prompt, 256)
        assert got == jr._prompt_affinity_digest(prompt, 256)
        assert got == kv_blocks.prompt_affinity_digest(prompt, 256)
    assert tr._digest_link(b"a", b"b") == jr._digest_link(b"a", b"b")


def test_rendezvous_picks_equal_jax_over_changing_live_sets():
    digests = [tr._prompt_affinity_digest(p, 256) for p in _prompts(1000)]
    pool = _urls(7)
    rng = np.random.default_rng(1)
    live = pool[:3]
    for step in range(12):
        # grow, shrink or swap one member, in a shuffled order
        if step % 3 == 0 and len(live) < len(pool):
            live = live + [u for u in pool if u not in live][:1]
        elif step % 3 == 1 and len(live) > 1:
            live = [u for u in live if u != live[rng.integers(len(live))]]
        else:
            live = list(rng.permutation(live))
        for d in digests:
            assert tr.rendezvous_order(d, live) == \
                jr.rendezvous_order(d, live)


def _replica_snapshot(rng):
    """A replica /metrics snapshot with the port's histograms."""
    hists = {}
    for name in ("ttft_secs", "tpot_secs", "e2e_secs"):
        h = telemetry.Histogram()
        for v in rng.exponential(0.2, rng.integers(5, 60)):
            h.observe(float(v))
        hists[name] = h.snapshot()
    return {"requests": int(rng.integers(0, 100)),
            "tokens_generated": int(rng.integers(0, 5000)),
            "histograms": hists,
            "engine": {"queue_depth": int(rng.integers(0, 9)),
                       "paged_kernel": "cuda"}}


def test_merged_histograms_equal_jax():
    rng = np.random.default_rng(2)
    snaps = [_replica_snapshot(rng) for _ in range(4)]
    got, want = {}, {}
    for s in snaps:
        tr._sum_numeric(got, json.loads(json.dumps(s)))
        jr._sum_numeric(want, json.loads(json.dumps(s)))
    assert got == want
    assert got["requests"] == sum(s["requests"] for s in snaps)
    for name, h in got["histograms"].items():
        assert tr._is_histogram(h)
        assert h["count"] == sum(s["histograms"][name]["count"]
                                 for s in snaps)
        for q in (0.5, 0.95, 0.99):
            assert tr._histogram_percentile(h, q) == \
                jr._histogram_percentile(h, q)
            assert telemetry.histogram_percentile(h, q) == \
                tr._histogram_percentile(h, q)


class _Tok:
    vocab_size, eod, pad = 64, 63, 0

    def tokenize(self, text):
        return [int(t) % 64 for t in text.split()]

    def detokenize(self, ids):
        return " ".join(str(i) for i in ids)


TINY = ["--model_name", "llama2", "--num_layers", "2", "--hidden_size",
        "64", "--num_attention_heads", "4", "--ffn_hidden_size", "96",
        "--padded_vocab_size", "64", "--seq_length", "128",
        "--max_position_embeddings", "128", "--device", "cpu",
        "--serve_num_slots", "4", "--serve_block_size", "8",
        "--serve_prefill_chunk", "16", "--seed", "0", "--serve_engine",
        "--serve_alerts", "0"]


def _put(url, payload):
    req = urllib.request.Request(url + "/api",
                                 data=json.dumps(payload).encode(),
                                 method="PUT")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=60) as resp:
        return json.loads(resp.read())


@pytest.fixture(scope="module")
def fleet():
    from megatron_llm_torch.run_text_generation_server import (
        build_parser,
        build_server,
    )

    servers, threads, urls = [], [], []
    for _ in range(2):
        server = build_server(build_parser().parse_args(TINY), _Tok())
        httpd = server.make_httpd("127.0.0.1", 0)
        t = threading.Thread(target=server.run, daemon=True)
        t.start()
        servers.append(server)
        threads.append(t)
        urls.append(f"http://127.0.0.1:{httpd.server_address[1]}")
    router = tr.ReplicaRouter(urls, health_interval_secs=0.5)
    front = tr.RouterServer(router)
    ft = threading.Thread(target=front.run,
                          kwargs={"host": "127.0.0.1", "port": 0},
                          daemon=True)
    ft.start()
    for _ in range(200):
        if front.httpd is not None:
            break
        threading.Event().wait(0.02)
    yield f"http://127.0.0.1:{front.httpd.server_address[1]}", urls
    front.shutdown()
    front.httpd.server_close()
    for server, t in zip(servers, threads):
        server.shutdown()
        server.engine.stop()
        t.join(10)
        assert not t.is_alive()


def test_router_over_port_replicas_affinity_and_merged_metrics(fleet):
    front, urls = fleet
    shared = " ".join(["7"] * 40)
    # the router keys on the first 256 characters: all of this prompt
    want = tr.rendezvous_order(
        tr._prompt_affinity_digest(f"{shared} 1 2", 256), urls)[0]
    before = {u: _get(u, "/metrics")["requests"] for u in urls}
    direct = _put(urls[0], {"prompts": [f"{shared} 1 2"],
                            "tokens_to_generate": 4, "temperature": 0.0})
    for i in range(5):
        code, body = _put(front, {"prompts": [f"{shared} 1 2"],
                                  "tokens_to_generate": 4,
                                  "temperature": 0.0})
        assert code == 200 and body["tokens"] == direct[1]["tokens"]
    after = {u: _get(u, "/metrics")["requests"] for u in urls}
    moved = {u: after[u] - before[u] - (u == urls[0]) for u in urls}
    assert moved[want] == 5 and sum(moved.values()) == 5
    merged = _get(front, "/metrics")
    own = [_get(u, "/metrics") for u in urls]
    agg = merged["aggregate"]
    assert agg["requests"] == sum(m["requests"] for m in own)
    assert agg["histograms"]["ttft_secs"]["count"] == sum(
        m["histograms"]["ttft_secs"]["count"] for m in own)
    assert merged["router"]["backends_alive"] == 2
    assert _get(front, "/health")["status"] == "ok"
    # the stdlib dashboard reads the port's router unchanged
    top = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "serve_top.py"),
         "--url", front, "--once", "--json"], cwd=REPO,
        capture_output=True, text=True, timeout=60)
    assert top.returncode == 0, top.stderr
    assert json.loads(top.stdout)


def test_stream_relay_forwards_each_event_as_it_arrives():
    """The relay hands on what the replica has sent, not full KiBs: an
    SSE reply with no length, as a replica sends, whose first event is
    followed by a pause, reaches the client's side of the router before
    the pause ends.  (The JAX router's ``read(1024)`` waits for a full
    KiB or EOF there: ROADMAP section 3, F7.)"""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    gate = threading.Event()

    class Replica(BaseHTTPRequestHandler):
        def do_PUT(self):
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(b'data: {"token": 5}\n\n')
            self.wfile.flush()
            gate.wait(30)
            self.wfile.write(b'data: {"done": true}\n\n')
            self.wfile.flush()

        def log_message(self, *a):
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Replica)
    st = threading.Thread(target=httpd.serve_forever, daemon=True)
    st.start()
    try:
        router = tr.ReplicaRouter(
            [f"http://127.0.0.1:{httpd.server_address[1]}"],
            request_timeout_secs=30)
        status, _, chunks = router.dispatch_stream(
            "PUT", "/api/stream", json.dumps({"prompts": ["1 2"]}).encode())
        assert status == 200
        first = []
        reader = threading.Thread(target=lambda: first.append(next(chunks)),
                                  daemon=True)
        reader.start()
        reader.join(10)
        # the first event came through while the replica still held the
        # second back
        assert first == [b'data: {"token": 5}\n\n'] and not gate.is_set()
        gate.set()
        assert b"".join(chunks) == b'data: {"done": true}\n\n'
    finally:
        gate.set()
        httpd.shutdown()
        httpd.server_close()
        st.join(10)


def test_replica_metrics_carry_kernel_launches(fleet, monkeypatch):
    """Each replica's /metrics carries the kernel wrappers' counts
    ("kernel_launches"), read at a dispatch's end with that dispatch's
    totals: the
    count a reader in another process holds against layers x dispatches.
    On the CPU no kernel launches; a count set in the wrapper module shows
    up at the next dispatch."""
    from megatron_llm_torch.ops.kernels import rmsnorm as rn

    front, urls = fleet
    monkeypatch.setattr(rn, "launches", 7)
    code, _ = _put(urls[1], {"prompts": ["3 4 5"], "tokens_to_generate": 2,
                             "temperature": 0.0})
    assert code == 200
    for url in urls:
        met = _get(url, "/metrics")
        eng, snap = met["engine"], met["kernel_launches"]
        assert snap["decode_steps"] == eng["decode_steps"] > 0
        assert snap["prefill_chunks"] == eng["prefill_chunks"] > 0
        # the replica that dispatched since the count was set reads it
        assert snap["rmsnorm"] == (7 if url == urls[1] else 0)
        assert not any(v for k, v in snap.items() if k not in (
            "decode_steps", "prefill_chunks", "rmsnorm"))
