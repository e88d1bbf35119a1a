"""The port's SLO sentinel (``serving/alerts.py``, a copy of the JAX
package's) against the JAX copy: the same snapshot sequence under a fake
clock gives the same transitions (burn rates, error rate, a queue-depth
threshold, a restart storm) and the same ``alerts`` block.  And the
port's ``build_server_alerts``: a transition reaches the JSONL stream and
the incident bundle is written under ``<structured_log_dir>/incidents``."""

import json
import os

from megatron_llm_tpu.serving import alerts as jax_alerts
from megatron_llm_torch import telemetry
from megatron_llm_torch.serving import alerts
from megatron_llm_torch.telemetry import Histogram

WALL = ("since_unix", "bundle")


def _snapshots(n=300, step=5.0):
    """(time, snapshot) pairs of a replica that degrades and recovers:
    slow first tokens, then errors, a queue backlog and three restarts,
    then calm."""
    ttft, tpot, e2e = Histogram(), Histogram(), Histogram()
    requests = errors = restarts = 0
    out = []
    for i in range(n):
        t = 1000.0 + i * step
        # the burn rules read a 900 s window: the run is 1500 s long
        bad = 180 <= i < 260
        for _ in range(5):
            ttft.observe(2.5 if bad else 0.05)
            tpot.observe(0.02)
            e2e.observe(0.8)
        requests += 5
        errors += 2 if 200 <= i < 260 else 0
        if i in (150, 160, 170):
            restarts += 1
        out.append((t, {
            "requests": requests, "errors": errors,
            "histograms": {"ttft_secs": ttft.snapshot(),
                           "tpot_secs": tpot.snapshot(),
                           "e2e_secs": e2e.snapshot()},
            "engine": {"queue_depth": 80 if 220 <= i < 260 else 3,
                       "engine_restarts": restarts, "preemptions": 0},
        }))
    return out


def _strip(d):
    return {k: v for k, v in d.items() if k not in WALL}


def test_transitions_equal_the_jax_sentinels():
    runs = []
    for mod in (alerts, jax_alerts):
        now = [0.0]
        eng = mod.AlertEngine(clock=lambda: now[0], interval_secs=2.0)
        seen, blocks = [], []
        for t, snap in _snapshots():
            now[0] = t
            seen += [_strip(tr) for tr in eng.evaluate(snap)]
            block = eng.snapshot()
            blocks.append(([_strip(f) for f in block["firing"]],
                           [_strip(p) for p in block["pending"]],
                           {k: v for k, v in block["counters"].items()
                            if k != "eval_secs_total"}))
        runs.append((seen, blocks))
    assert runs[0] == runs[1]
    seen = runs[0][0]
    fired = {tr["rule"] for tr in seen if tr["state"] == "firing"}
    resolved = {tr["rule"] for tr in seen if tr["state"] == "resolved"}
    assert {"ttft_burn", "error_rate", "queue_depth_high",
            "engine_restart_storm"} <= fired
    assert {"ttft_burn", "queue_depth_high"} <= resolved


def test_rule_parsing_equals_jax(tmp_path):
    text = json.dumps({"interval_secs": 0.5, "rules": [
        {"name": "q", "kind": "threshold", "path": "engine.queue_depth",
         "op": ">", "value": 4}]})
    path = tmp_path / "rules.json"
    path.write_text(text)
    for arg in (text, str(path)):
        assert alerts.parse_rules_arg(arg) == jax_alerts.parse_rules_arg(arg)
    assert alerts.normalize_rule(alerts.DEFAULT_RULES[0]) == \
        jax_alerts.normalize_rule(jax_alerts.DEFAULT_RULES[0])


class _Server:
    """What build_server_alerts reads of a server: its metrics."""

    def __init__(self):
        from megatron_llm_torch.text_generation_server import ServerMetrics

        self.metrics = ServerMetrics()


def test_build_server_alerts_streams_transitions_and_bundles(tmp_path):
    from megatron_llm_torch.text_generation_server import build_server_alerts

    stream = telemetry.TelemetryStream(str(tmp_path))
    telemetry.install_stream(stream)
    now = [0.0]
    try:
        server = _Server()
        rules = json.dumps([{"name": "busy", "kind": "threshold",
                             "path": "requests", "op": ">=", "value": 1,
                             "clear_secs": 0.0}])
        eng = build_server_alerts(server, structured_log_dir=str(tmp_path),
                                  alert_rules=rules,
                                  clock=lambda: now[0], start=False)
        assert server.metrics.alert_engine is eng
        assert eng.evaluate() == []
        server.metrics.observe(0.1, 200, tokens=3)
        now[0] = 2.0
        fired = eng.evaluate()
        assert [t["state"] for t in fired] == ["firing"]
        assert server.metrics.snapshot()["alerts"]["firing_count"] == 1
        bundle = fired[0]["bundle"]
        assert bundle and os.path.isdir(bundle)
        assert os.path.dirname(bundle) == str(tmp_path / "incidents")
        with open(os.path.join(bundle, "manifest.json")) as f:
            parts = json.load(f)["parts"]
        assert {"transition", "metrics", "recent_requests",
                "thread_stacks"} <= set(parts)
        # a bad rule set leaves the server without a sentinel
        assert build_server_alerts(_Server(), alert_rules="[{}]",
                                   start=False) is None
    finally:
        telemetry.install_stream(None)
        stream.close()
    with open(tmp_path / telemetry.STREAM_FILENAME) as f:
        records = [json.loads(line) for line in f]
    tr = [r for r in records if r.get("event") == "alert_transition"]
    assert len(tr) == 1 and tr[0]["kind"] == "serve"
    assert tr[0]["rule"] == "busy" and tr[0]["state"] == "firing"
