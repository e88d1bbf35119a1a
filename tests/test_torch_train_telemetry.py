"""The port's training telemetry and tracer (megatron_llm_torch/
telemetry.py, tracing.py) against the JAX package's: the JSONL records of
a tiny ``pretrain`` carry the JAX run's keys per ``kind`` (schema 13,
layer stats included); the flight recorder dumps in the JAX shape;
``--timing_log_option`` formats the timers' line as the JAX ``Timers``
do; ``StatusServer`` answers ``/health`` and ``/metrics`` (JSON and the
JAX package's Prometheus text); the CPU profiler window writes a Chrome
trace; the JAX tracing tests' synthetic cases (span nesting and the
ring, the span handle, the Chrome export, goodput arithmetic, nested
spans, stragglers, the recompile outlier path) run against both
packages; the kernels' build reported inside a step span moves from
``step`` to ``compile``; and ``tools/telemetry_report.py``,
``health_report.py`` and ``trace_report.py`` exit 0 on a port run's
files."""

import argparse
import json
import os
import subprocess
import sys
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu import global_vars as jax_global_vars
from megatron_llm_tpu import telemetry as jax_tel
from megatron_llm_tpu import tracing as jax_tr
from megatron_llm_tpu.config import ParallelConfig as JaxParallelConfig
from megatron_llm_tpu.config import TrainConfig as JaxTrainConfig
from megatron_llm_tpu.models.llama import LlamaModel as JaxLlama
from megatron_llm_tpu.models.llama import llama_config as jax_llama_config
from megatron_llm_tpu.parallel import sharding as sh
from megatron_llm_tpu.timers import Timers as JaxTimers
from megatron_llm_tpu.training import pretrain as jax_pretrain
from megatron_llm_torch import finetune, global_vars
from megatron_llm_torch import telemetry as tel
from megatron_llm_torch import tracing as tr
from megatron_llm_torch.config import ParallelConfig, TrainConfig
from megatron_llm_torch.models.llama import LlamaModel, llama_config
from megatron_llm_torch.timers import Timers
from megatron_llm_torch.training import pretrain
from megatron_llm_torch.weights import params_from_jax

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(seq_length=16, max_position_embeddings=16, padded_vocab_size=64,
          num_layers=2, hidden_size=32, num_attention_heads=4,
          ffn_hidden_size=64)
BOTH = pytest.mark.parametrize("mod", [jax_tr, tr], ids=["jax", "port"])


@pytest.fixture(autouse=True)
def _clean_state():
    for t, r in ((jax_tel, jax_tr), (tel, tr)):
        t.install_stream(None)
        r.install_tracing(None)
    jax_global_vars.reset_counters()
    global_vars.reset_counters()
    yield
    for t, r in ((jax_tel, jax_tr), (tel, tr)):
        t.install_stream(None)
        r.install_tracing(None)
        r.install_detector(None)
    jax_global_vars.reset_counters()
    global_vars.reset_counters()


def _args(**kw):
    base = dict(structured_log_dir=None, flight_recorder_size=64,
                profile=False, profile_step_start=2, profile_step_end=3,
                profile_dir=None, profiler_port=None, trace_dir=None,
                trace_buffer_size=100_000, straggler_threshold=1.5,
                status_port=None)
    base.update(kw)
    return argparse.Namespace(**base)


def _data(shape=(1, 8, 16)):
    rng = np.random.RandomState(0)
    while True:
        toks = rng.randint(0, 64, size=shape).astype(np.int32)
        yield {"tokens": toks, "labels": np.roll(toks, -1, axis=-1),
               "loss_mask": np.ones(shape, np.float32)}


def _tc(cls, iters):
    return cls(micro_batch_size=8, global_batch_size=8, train_iters=iters,
               lr=1e-3, optimizer="adam", seed=3)


def _records(d):
    with open(os.path.join(d, tel.STREAM_FILENAME)) as f:
        return [json.loads(line) for line in f]


def _shape(rec):
    """{key: sorted sub-keys for dict values} of a record."""
    return {k: (sorted(v) if isinstance(v, dict) else None)
            for k, v in rec.items()}


def test_stream_records_have_the_jax_keys(utils, tmp_path):
    jmodel = JaxLlama(jax_llama_config("tiny", **KW))
    utils.initialize_model_parallel(tp=1)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = llama_config("tiny", **KW)
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    jparams = sh.shard_params(jparams, jmodel.param_specs(jparams))
    out = {}
    for name, t, model, params, loop, tc, pc, it in (
            ("jax", jax_tel, jmodel, jparams, jax_pretrain, JaxTrainConfig,
             JaxParallelConfig,
             ({k: jnp.asarray(v) for k, v in b.items()} for b in _data())),
            ("port", tel, LlamaModel(tcfg, device="cpu"), tparams, pretrain,
             TrainConfig, ParallelConfig,
             ({k: torch.from_numpy(v) for k, v in b.items()}
              for b in _data()))):
        d = str(tmp_path / name)
        bundle = t.build_telemetry(
            _args(structured_log_dir=d, trace_dir=d,
                  flight_recorder_size=8), model)
        try:
            loop(model, params, _tc(tc, 4), pc(), it, log_interval=1,
                 log_layer_stats_interval=2, telemetry=bundle)
            out[name] = (_records(d),
                         bundle.stream.dump_flight_recorder("unit test"))
        finally:
            bundle.close()
    (jrecs, jdump), (trecs, tdump) = out["jax"], out["port"]
    assert [r["iteration"] for r in trecs] == [1, 2, 3, 4]
    for jr, trc in zip(jrecs, trecs):
        assert trc["schema"] == tel.TELEMETRY_SCHEMA_VERSION == 13
        assert trc["kind"] == jr["kind"] == "log"
        want, got = _shape(jr), _shape(trc)
        # the JAX CPU device reports some memory keys, a CPU tensor none
        want.pop("memory"), got.pop("memory")
        assert got == want
        assert ("layer_stats" in trc) == (trc["iteration"] % 2 == 0)
        if "layer_stats" in trc:
            assert sorted(trc["layer_stats"]) == sorted(jr["layer_stats"])
            assert trc["layer_stats"]["groups"] == \
                jr["layer_stats"]["groups"]
        assert trc["mfu"] is None and trc["goodput_pct"] > 0
    jd, td = (json.load(open(p)) for p in (jdump, tdump))
    assert sorted(td) == sorted(jd) and td["reason"] == "unit test"
    assert {r["kind"] for r in td["records"]} == \
        {r["kind"] for r in jd["records"]} == {"dispatch", "log"}
    assert len(td["records"]) == 8


@pytest.mark.parametrize("opt", ["minmax", "max", "all"])
def test_timing_log_option_formats_as_in_jax(opt):
    gathered = {"batch-generator": [0.00125], "train-step": [0.5]}
    want = JaxTimers(log_level=2, log_option=opt)._format_line(gathered)
    assert Timers(log_level=2, log_option=opt)._format_line(gathered) == want
    with pytest.raises(ValueError):
        Timers(log_option="median")


def _get(port, path, accept=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}")
    if accept:
        req.add_header("Accept", accept)
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, r.read().decode()


def test_status_server_answers_health_and_metrics():
    rec = {"schema": 13, "kind": "log", "iteration": 7, "lm_loss": 2.5,
           "recovery": {"rewinds": 1, "save_retries": 0}}
    servers = [m.StatusServer(0, host="127.0.0.1") for m in (jax_tel, tel)]
    try:
        for s in servers:
            assert json.loads(_get(s.port, "/health")[1])["iteration"] \
                is None
            s.update(rec)
        (jw, tw) = servers
        jh, th = (json.loads(_get(s.port, "/health")[1]) for s in servers)
        assert sorted(th) == sorted(jh) and th["iteration"] == 7
        assert json.loads(_get(tw.port, "/metrics")[1]) == rec
        jp, tp = (_get(s.port, "/metrics?format=prometheus")[1]
                  for s in servers)
        assert tp == jp and "megatron_train_iteration 7" in tp
        assert _get(tw.port, "/metrics", accept="text/plain")[1] == tp
    finally:
        for s in servers:
            s.close()


def test_cpu_profiler_window_writes_a_chrome_trace(tmp_path):
    cfg = llama_config("tiny", **KW)
    model = LlamaModel(cfg, device="cpu")
    d = str(tmp_path / "prof")
    bundle = tel.Telemetry.default(model)
    bundle.profiler = tel.ProfilerSession(d, 2, 3, cuda=False)
    pretrain(model, model.init(0), _tc(TrainConfig, 4), ParallelConfig(),
             ({k: torch.from_numpy(v) for k, v in b.items()}
              for b in _data()), log_interval=1, telemetry=bundle)
    assert bundle.profiler.done and not bundle.profiler.active
    path = os.path.join(d, "trace_iter2-3.json")
    assert bundle.profiler.trace_path == path
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "aten::mm" in names or "aten::addmm" in names
    with pytest.raises(ValueError):
        tel.ProfilerSession(d, 3, 2)


# -- the JAX tracing tests' synthetic cases, against both --------------------

@BOTH
def test_span_nesting_and_ring_eviction(mod):
    t = mod.SpanTracer(capacity=4)
    with t.span("outer", "step"):
        with t.span("inner", "checkpoint"):
            pass
    assert len(t) == 2
    for i in range(10):
        with t.span(f"s{i}", "other"):
            pass
    assert len(t) == 4 and t.dropped == 8
    names = [e["name"] for e in t.chrome_trace()["traceEvents"]
             if e["ph"] == "X"]
    assert names == ["s6", "s7", "s8", "s9"]


@BOTH
def test_span_handle_and_chrome_export(mod):
    t = mod.SpanTracer()
    with t.span("save", "checkpoint", iteration=3) as h:
        h.args["bytes"] = 1024
        time.sleep(0.01)
    t.instant("marker", "other", detail="x")
    doc = t.chrome_trace(reason="unit test")
    evs = doc["traceEvents"]
    assert {e["ph"] for e in evs} == {"M", "X", "i"}
    (x,) = [e for e in evs if e["ph"] == "X"]
    assert x["args"] == {"iteration": 3, "bytes": 1024,
                         "goodput": "checkpoint"}
    assert x["dur"] >= 10_000 and x["tid"] == 0 and x["pid"] == 0
    od = doc["otherData"]
    assert od["reason"] == "unit test" and od["dropped_events"] == 0
    assert set(od["goodput"]) == ({f"{c}_secs"
                                   for c in mod.GOODPUT_CATEGORIES}
                                  | {"other_secs", "wall_secs",
                                     "goodput_pct"})
    json.loads(json.dumps(doc))


@BOTH
def test_goodput_arithmetic_synthetic_timeline(mod):
    t = [0.0]
    g = mod.GoodputAccounter(clock=lambda: t[0])
    for cat, secs in (("step", 60.0), ("compile", 15.0),
                      ("checkpoint", 10.0), ("eval", 5.0)):
        g.add(cat, secs)
    t[0] = 100.0
    s = g.summary()
    assert s["other_secs"] == pytest.approx(10.0)
    assert s["goodput_pct"] == pytest.approx(60.0)
    assert g.move("step", "compile", 20.0) == pytest.approx(20.0)
    assert g.summary()["goodput_pct"] == pytest.approx(40.0)
    assert g.move("step", "compile", 1e9) == pytest.approx(40.0)
    assert g.summary()["step_secs"] == 0.0


@BOTH
def test_nested_goodput_spans_never_double_count(mod):
    t = mod.SpanTracer()
    with t.span("train", "run"):
        with t.span("step", "step"):
            with t.span("checkpoint_write", "checkpoint"):
                time.sleep(0.01)
    s = t.goodput.summary()
    assert s["checkpoint_secs"] == 0.0 and s["step_secs"] >= 0.01
    with t.span("checkpoint_save", "checkpoint"):
        time.sleep(0.01)
    assert t.goodput.summary()["checkpoint_secs"] >= 0.01


@BOTH
def test_straggler_flagging_and_no_flag_cases(mod):
    counters = (jax_global_vars if mod is jax_tr else global_vars)
    lines = []
    t = mod.SpanTracer()
    det = mod.StragglerDetector(threshold=1.5, tracer=t,
                                printer=lines.append)
    (ev,) = det.check({"train-step": [0.1, 0.1, 0.5, 0.1]}, iteration=7)
    assert ev["host"] == 2 and ev["ratio"] == pytest.approx(5.0)
    assert counters.get_counters()["straggler_events"] == 1
    assert "STRAGGLER host 2" in lines[0]
    # one process: a median of one never flags
    assert det.check({"train-step": [9.9]}, 1) == []
    assert det.check({"train-step": [0.001, 0.001, 0.004, 0.001]}, 3) == []


@BOTH
def test_recompile_outlier_path(mod):
    counters = (jax_global_vars if mod is jax_tr else global_vars)
    t = mod.SpanTracer()
    det = mod.RecompileDetector(tracer=t, use_monitoring=False)
    for _ in range(5):
        assert not det.observe_step_time(0.1)
    det.mark_steady()
    assert not det.observe_step_time(0.12)
    assert det.observe_step_time(1.0)
    assert det.recompiles == 1
    assert counters.get_counters()["recompiles"] == 1
    assert det.events[-1]["kind"] == "suspected_recompile"


def test_port_detector_defaults_to_the_outlier_path():
    assert tr.RecompileDetector().use_monitoring is False


def test_kernel_build_inside_a_step_moves_to_compile(tmp_path):
    bundle = tr.build_tracing(_args(trace_dir=str(tmp_path)))
    goodput = bundle.tracer.goodput
    try:
        with tr.span("step", "step"):
            t0 = time.perf_counter()
            with tr.span("kernel_build", "compile"):
                time.sleep(0.05)
            tr.note_compile(time.perf_counter() - t0)
        n, secs = bundle.recompile.drain()
        assert n == 1 and secs >= 0.05
        assert goodput.summary()["compile_secs"] == 0.0
        goodput.move("step", "compile", secs)        # the loop's move
        assert goodput.summary()["compile_secs"] >= 0.05
        # outside a goodput span the span itself counted it
        with tr.span("kernel_build", "compile"):
            time.sleep(0.02)
        tr.note_compile(0.02)
        assert bundle.recompile.drain() == (0, 0.0)
    finally:
        bundle.close()
    names = [e["name"] for e in
             json.load(open(tmp_path / "trace.json"))["traceEvents"]]
    assert names.count("kernel_build") == 2


def test_report_tools_read_a_port_run(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["--model_name=llama2", "--num_layers=2", "--hidden_size=32",
            "--num_attention_heads=4", "--seq_length=16",
            "--max_position_embeddings=16", "--micro_batch_size=2",
            "--global_batch_size=2", "--train_iters=6", "--lr=1e-3",
            "--vocab_size=64", "--log_interval=1", "--device", "cpu",
            "--structured_log_dir", "logs", "--trace_dir", "trace",
            "--log_layer_stats_interval", "1", "--rewind_on_spike",
            "--snapshot_interval", "1", "--resilience_check_interval", "1",
            "--fault_inject", "nan@3"]
    assert finetune.main(argv) == 6
    runs = {}
    for tool, path in (("telemetry_report", "logs"),
                       ("health_report", "logs"),
                       ("trace_report", "trace")):
        cmd = [sys.executable, os.path.join(ROOT, "tools", f"{tool}.py"),
               path]
        if tool == "trace_report":
            cmd += ["--log_dir", "logs"]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60)
        assert proc.returncode == 0, proc.stderr
        runs[tool] = proc.stdout
    assert "iteration 3: rewinds+1" in runs["telemetry_report"]
    assert "layer_001" in runs["health_report"]
    assert "goodput" in runs["trace_report"]
    fr = json.load(open(tmp_path / "logs" / "flight_recorder.json"))
    (health,) = [r for r in fr["records"] if r["kind"] == "health"]
    assert health["iteration"] == 3
    assert health["offenders"]["first_nonfinite"] == "embedding"
