"""Serving resilience in the port (``serving/resilience.py``, the engine's
watchdog, fault hooks and in-process restart) against the JAX package's
engine: the same tiny params, the same requests, the same
``fault_spec``, each engine started on its own thread.  Per request the
finish reasons must be equal, and so must ``engine_restarts`` and
``slots_evicted_nonfinite``:

* ``nan@N`` evicts one slot with ``nonfinite``, its batch-mates finish;
* ``hang@N:S`` under a watchdog restarts the engine: queued and
  not-yet-streaming requests complete, a streaming one that already
  sent a token ends with an error;
* ``slow@N:MS`` shorter than the watchdog does not trip it;
* ``oom@N`` holds one admission round back and every request finishes.

Also: the parser of the fault spec equals the JAX copy's, and a restart
leaves the old thread's pool untouched by the new state."""

import jax
import pytest
import torch

from megatron_llm_tpu.models.llama import LlamaModel as JaxLlama
from megatron_llm_tpu.models.llama import llama_config as jax_llama_config
from megatron_llm_tpu.serving import EngineConfig as JaxEngineConfig
from megatron_llm_tpu.serving import InferenceEngine as JaxEngine
from megatron_llm_tpu.serving import SamplingParams as JaxSamplingParams
from megatron_llm_tpu.serving.resilience import (
    ServingFaultInjector as JaxInjector,
)
from megatron_llm_torch.models.llama import LlamaModel, llama_config
from megatron_llm_torch.serving import (
    EngineConfig,
    InferenceEngine,
    SamplingParams,
)
from megatron_llm_torch.serving.resilience import ServingFaultInjector
from megatron_llm_torch.weights import params_from_jax

torch.set_num_threads(1)
KW = dict(num_layers=2, seq_length=64, max_position_embeddings=64,
          padded_vocab_size=64)
ENGINE_KW = dict(num_slots=2, block_size=8, prefill_chunk=16,
                 max_model_len=64, default_deadline_secs=0.0,
                 restart_backoff_secs=0.0)
PROMPTS = [[(5 * i + 3) % 60 + 1 for i in range(n)] for n in (9, 20, 5)]


@pytest.fixture(scope="module")
def models():
    jmodel = JaxLlama(jax_llama_config("tiny", use_flash_attn=False, **KW))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = llama_config("tiny", **KW)
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    return jmodel, jparams, LlamaModel(tcfg, device="cpu"), tparams


def _chaos(engine_cls, cfg_cls, sp_cls, model, params, spec, watchdog,
           stream_first=False):
    """Warm up, queue the three prompts, start the engine with ``spec``
    armed and wait for every request.  Returns (finish reasons, restarts,
    non-finite evictions)."""
    eng = engine_cls(model, params, cfg_cls(
        **ENGINE_KW, watchdog_secs=watchdog, fault_spec=spec))
    try:
        eng.warmup()
        sp = sp_cls(max_new_tokens=10, temperature=0.0)
        reqs = [eng.submit(p, sp, stream=stream_first and i == 0)
                for i, p in enumerate(PROMPTS)]
        eng.start()
        reasons = []
        for r in reqs:
            try:
                r.result(timeout=60)
            except Exception as exc:    # noqa: BLE001 - the reason counts
                assert "restarted mid-stream" in str(exc)
            reasons.append(r.finish_reason)
        st = eng.stats()
        return reasons, st["engine_restarts"], st["slots_evicted_nonfinite"]
    finally:
        eng.stop()


# the dispatch indices count from the first dispatch of warmup (4 of
# them); each trigger fires at its first dispatch at or after N.  The
# watchdog (2 s) sits far above a normal step on a loaded CPU, the hangs
# (5 s) far above the watchdog, and the spike (200 ms) far below it, so
# a slow step in a parallel run cannot add or remove a restart.
@pytest.mark.parametrize("spec, watchdog, stream_first, want", [
    ("nan@7", 0.0, False, (1, 0)),
    ("hang@6:5", 2.0, False, (0, 1)),
    ("hang@9:5", 2.0, True, (0, 1)),
    ("slow@6:200", 2.0, False, (0, 0)),
    ("oom@5", 0.0, False, (0, 0)),
], ids=["nan", "hang", "hang_midstream", "slow", "oom"])
def test_fault_specs_end_requests_as_in_jax(models, spec, watchdog,
                                            stream_first, want):
    jmodel, jparams, tmodel, tparams = models
    got = _chaos(InferenceEngine, EngineConfig, SamplingParams, tmodel,
                 tparams, spec, watchdog, stream_first)
    ref = _chaos(JaxEngine, JaxEngineConfig, JaxSamplingParams, jmodel,
                 jparams, spec, watchdog, stream_first)
    assert got == ref
    assert (got[2], got[1]) == want
    if spec.startswith("nan"):
        assert sorted(got[0]) == ["length", "length", "nonfinite"]
    elif stream_first:
        assert got[0] == ["error", "length", "length"]
    else:
        assert got[0] == ["length"] * 3


def test_fault_spec_grammar_equals_jax():
    for spec in ("", "nan@3", "hang@4", "hang@4:2.5,slow@9:30",
                 "oom@2, nan@8", "slow@1"):
        got = ServingFaultInjector.from_spec(spec)
        want = JaxInjector.from_spec(spec)
        assert (got is None) == (want is None)
        if got is not None:
            assert vars(got) == vars(want)
    for bad in ("boom@3", "nan@x"):
        with pytest.raises(ValueError):
            ServingFaultInjector.from_spec(bad)


def test_restart_gives_a_fresh_pool_and_strands_the_old_one(models):
    """A restart publishes a new state with its own pool; the old state's
    pool is another tensor, so the wedged thread's writes cannot reach
    the new one, and the counters carry over."""
    _, _, tmodel, tparams = models
    eng = InferenceEngine(tmodel, tparams, EngineConfig(**ENGINE_KW))
    try:
        eng.warmup()
        eng.start()
        r = eng.submit(PROMPTS[0], SamplingParams(max_new_tokens=4,
                                                  temperature=0.0))
        r.result(timeout=60)
        old = eng._st
        admitted = eng.scheduler.admitted
        eng.restart("test")
        new = eng._st
        assert new is not old and new.gen == old.gen + 1
        for lo, ln in zip(old.pages, new.pages):
            for name in lo:
                assert lo[name].data_ptr() != ln[name].data_ptr()
        assert eng.scheduler.admitted == admitted
        assert eng.stats()["engine_restarts"] == 1
        r2 = eng.submit(PROMPTS[0], SamplingParams(max_new_tokens=4,
                                                   temperature=0.0))
        assert r2.result(timeout=60).tokens == r.tokens
    finally:
        eng.stop()
