"""The port's metrics registry (megatron_llm_torch/metrics.py) and
metrics writer (wandb_logger.py) against the JAX package's: every
``METRICS`` entry gives the JAX value on the same logits and batch
(fp32, 1e-6), the name helpers agree, and ``WandbTBShim``'s JSONL
fallback (no ``wandb`` installed) writes the JAX shim's lines apart from
the timestamps, its finish summaries included; a fake ``wandb`` module
receives the run's settings and scalars."""

import json
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu import global_vars as jax_global_vars
from megatron_llm_tpu import metrics as jax_metrics
from megatron_llm_tpu import wandb_logger as jax_wandb
from megatron_llm_torch import global_vars, metrics, wandb_logger


@pytest.fixture(autouse=True)
def _clean_counters():
    jax_global_vars.reset_counters()
    global_vars.reset_counters()
    yield
    jax_global_vars.reset_counters()
    global_vars.reset_counters()


def _inputs(mask):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    labels[0, :3] = logits[0, :3].argmax(-1)        # some right answers
    batch = {"labels": labels}
    if mask:
        batch["loss_mask"] = (rng.random((2, 5)) > 0.3).astype(np.float32)
    return logits, batch, np.float32(1.75)


@pytest.mark.parametrize("mask", [True, False])
@pytest.mark.parametrize("name", sorted(jax_metrics.METRICS))
def test_metrics_match_jax(name, mask):
    logits, batch, loss = _inputs(mask)
    want = jax_metrics.METRICS[name](jax_metrics.MetricInput(
        batch={k: jnp.asarray(v) for k, v in batch.items()},
        logits=jnp.asarray(logits), avg_loss=jnp.asarray(loss)))
    got = metrics.METRICS[name](metrics.MetricInput(
        batch={k: torch.from_numpy(v) for k, v in batch.items()},
        logits=torch.from_numpy(logits), avg_loss=torch.tensor(loss)))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-6, atol=0)


def test_metric_names_resolve_as_in_jax():
    assert sorted(metrics.METRICS) == sorted(jax_metrics.METRICS)
    for names in ([], ["accuracy"], ["all"], None):
        assert metrics.resolve_metric_names(names) == \
            jax_metrics.resolve_metric_names(names)
    with pytest.raises(KeyError):
        metrics.get_metric("bleu")
    global_vars.get_counters()["rewinds"] = 2
    assert metrics.recovery_counters() == {
        "rewinds": 2, "save_retries": 0, "watchdog_fires": 0,
        "signal_saves": 0}
    assert metrics.telemetry_summary() is None


def _strip_times(line):
    rec = json.loads(line)
    rec.pop("time", None)
    return rec


def test_wandb_fallback_lines_match_jax(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)     # not installed
    files = {}
    for name, mod, gv in (("jax", jax_wandb, jax_global_vars),
                          ("port", wandb_logger, global_vars)):
        gv.get_counters()["save_retries"] = 2
        path = str(tmp_path / f"{name}.jsonl")
        w = mod.WandbTBShim(config={"num_layers": 2}, project="p",
                            fallback_path=path)
        for it in (1, 2):
            w.add_scalar("lm loss", 2.5 / it, it)
            w.add_scalar("learning_rate", 1e-4, it)
            w.flush()
        w.add_scalar("validation loss", 3.0, 2)
        w.finish()
        files[name] = [_strip_times(line) for line in open(path)]
    assert files["port"] == files["jax"]
    assert files["port"][-1] == {"event": "recovery_summary",
                                 "rewinds": 0, "save_retries": 2,
                                 "watchdog_fires": 0, "signal_saves": 0}
    # --wandb_resume refuses to fake a resume without wandb
    with pytest.raises(ImportError):
        wandb_logger.WandbTBShim(config={}, resume="must",
                                 fallback_path=str(tmp_path / "x.jsonl"))


def test_wandb_module_receives_the_run(tmp_path, monkeypatch):
    calls = {"log": []}

    class Run:
        summary = {}

        def finish(self):
            calls["finished"] = True

    fake = types.SimpleNamespace(
        init=lambda **kw: calls.update(init=kw) or Run(),
        log=lambda payload, step: calls["log"].append((step, payload)))
    monkeypatch.setitem(sys.modules, "wandb", fake)
    environ = {k: v for k, v in os.environ.items() if k != "WANDB_API_KEY"}
    monkeypatch.setattr(os, "environ", environ)
    w = wandb_logger.WandbTBShim(config={"a": 1}, project="p", entity="e",
                                 name="n", run_id="i", api_key="k",
                                 fallback_path=str(tmp_path / "no.jsonl"))
    w.add_scalar("lm loss", 2.0, 3)
    w.finish()
    assert calls["init"] == {"project": "p", "entity": "e", "name": "n",
                             "id": "i", "resume": "allow",
                             "config": {"a": 1}}
    assert calls["log"] == [(3, {"lm loss": 2.0})]
    assert calls["finished"] and Run.summary["recovery/rewinds"] == 0
    assert environ["WANDB_API_KEY"] == "k"
    assert not (tmp_path / "no.jsonl").exists()
