"""The port's serving engine against the JAX package's InferenceEngine:
the same tiny Llama params (carried across by weights.py), the same
EngineConfig, the same greedy requests, single-stepped on the CPU — the
generated tokens must be identical.  Cases: co-batched prompts, a shared
prefix served from the prefix cache, a forced copy-on-write of a shared
page, and preemption under a deliberately small pool.  Also: the
options that were refused before they were ported build engines that
serve the same tokens, and the stats / request_done keys keep the JAX
engine's (schema 13) so the stdlib serve tools read a port replica."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from megatron_llm_tpu.models.llama import LlamaModel as JaxLlama
from megatron_llm_tpu.models.llama import llama_config as jax_llama_config
from megatron_llm_tpu.serving import EngineConfig as JaxEngineConfig
from megatron_llm_tpu.serving import InferenceEngine as JaxEngine
from megatron_llm_tpu.serving import SamplingParams as JaxSamplingParams
from megatron_llm_torch.models.llama import LlamaModel, llama_config
from megatron_llm_torch.serving import (
    EngineConfig,
    InferenceEngine,
    SamplingParams,
)
from megatron_llm_torch.weights import params_from_jax

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(num_layers=2, seq_length=64, max_position_embeddings=64,
          padded_vocab_size=64)
ENGINE_KW = dict(num_slots=4, block_size=8, prefill_chunk=16,
                 max_model_len=64)


@pytest.fixture(scope="module")
def models():
    jmodel = JaxLlama(jax_llama_config("tiny", use_flash_attn=False, **KW))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = llama_config("tiny", **KW)
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    return jmodel, jparams, LlamaModel(tcfg, device="cpu"), tparams


def _engines(models, **kw):
    jmodel, jparams, tmodel, tparams = models
    cfg = dict(ENGINE_KW, **kw)
    return (JaxEngine(jmodel, jparams, JaxEngineConfig(**cfg)),
            InferenceEngine(tmodel, tparams, EngineConfig(**cfg)))


def _greedy(sp_cls, n):
    return sp_cls(max_new_tokens=n, temperature=0.0)


def _drive(engine, reqs, limit=2000):
    for _ in range(limit):
        if all(r.state == "done" for r in reqs):
            return
        engine.step()
    raise AssertionError("engine did not finish the requests")


def _serve(engine, sp_cls, prompts, n=8):
    reqs = [engine.submit(p, _greedy(sp_cls, n)) for p in prompts]
    _drive(engine, reqs)
    return reqs


PROMPTS = [[(5 * i + 3) % 60 + 1 for i in range(n)] for n in (3, 17, 30, 9)]


def test_cobatched_greedy_tokens_match_jax(models):
    jeng, teng = _engines(models)
    want = _serve(jeng, JaxSamplingParams, PROMPTS)
    got = _serve(teng, SamplingParams, PROMPTS)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert all(r.finish_reason == "length" for r in got)
    js, ts = jeng.stats(), teng.stats()
    for key in ("decode_steps", "prefill_chunks", "tokens_generated",
                "prefill_tokens_computed"):
        assert ts[key] == js[key], key
    assert ts["paged_kernel"] == ts["prefill_kernel"] == "torch"


def test_shared_prefix_hits_the_cache_like_jax(models):
    jeng, teng = _engines(models)
    common = [(7 * i + 3) % 60 + 1 for i in range(20)]
    a, b = common + [11, 12, 13, 14], common + [21, 22, 23]
    for prompts in ([a], [b], [a]):
        want = _serve(jeng, JaxSamplingParams, prompts)
        got = _serve(teng, SamplingParams, prompts)
        assert got[0].tokens == want[0].tokens
        assert got[0].cached_prompt_tokens == want[0].cached_prompt_tokens
    assert teng.stats()["prefix_cache_hit_tokens"] == \
        jeng.stats()["prefix_cache_hit_tokens"] > 0



def test_prefix_hit_chunk_at_the_position_table_end(models):
    """A 56-token cached prefix (seven pages) leaves the next prompt's
    chunk starting at 56 with prefill_chunk 16: its padded tail lies past
    max_position_embeddings (64) and must neither fail the chunk nor
    change the JAX engine's tokens."""
    jeng, teng = _engines(models)
    common = [(7 * i + 3) % 60 + 1 for i in range(56)]
    for prompts in ([common + [2]], [common + [3, 4, 5, 6]]):
        want = _serve(jeng, JaxSamplingParams, prompts, n=2)
        got = _serve(teng, SamplingParams, prompts, n=2)
        assert got[0].tokens == want[0].tokens
        assert got[0].cached_prompt_tokens == want[0].cached_prompt_tokens
    assert got[0].cached_prompt_tokens == 56

def test_copy_on_write_of_a_shared_page(models):
    """Two live requests adopt the same cached pages; forcing the write
    barrier on one of them copies the page on the device, repoints its
    table, and neither request's output changes."""
    _, teng = _engines(models)
    common = [(3 * i + 1) % 60 + 1 for i in range(16)]
    c, d = common + [5, 6, 7], common + [8, 9]
    base = [r.tokens for r in _serve(teng, SamplingParams, [c, d])]
    st = teng._st
    rc = teng.submit(c, _greedy(SamplingParams, 8))
    rd = teng.submit(d, _greedy(SamplingParams, 8))
    teng.step()                     # admits both; both adopt the prefix
    assert rc.cached_prompt_tokens == rd.cached_prompt_tokens == 16
    old = int(st.blocks.tables[rc.slot, 0])
    assert old == int(st.blocks.tables[rd.slot, 0])
    copies = st.blocks.stats()["cow_copies"]
    teng._writable(st, rc.slot, 0)
    new = int(st.blocks.tables[rc.slot, 0])
    assert new != old and st.blocks.stats()["cow_copies"] == copies + 1
    for layer in st.pages:
        for pool in layer.values():
            torch.testing.assert_close(pool[new], pool[old], rtol=0, atol=0)
    _drive(teng, [rc, rd])
    assert [rc.tokens, rd.tokens] == base


def test_preemption_matches_jax(models):
    """A pool of 8 usable pages: the long request's reservation (7 pages)
    starves the short one until the engine preempts it; the victim
    resumes and both engines emit the same tokens."""
    jeng, teng = _engines(models, num_slots=2, num_blocks=9)
    long_p = [(11 * i + 2) % 60 + 1 for i in range(20)]
    out = []
    for eng, sp in ((jeng, JaxSamplingParams), (teng, SamplingParams)):
        lr = eng.submit(long_p, _greedy(sp, 30))
        for _ in range(4):
            eng.step()
        sr = eng.submit([1, 2, 3], _greedy(sp, 6))
        _drive(eng, [lr, sr])
        assert eng.scheduler.preemptions >= 1 and lr.preempt_count >= 1
        eng.blocks.check_invariants()
        out.append((lr.tokens, sr.tokens, eng.scheduler.preemptions))
    assert out[1] == out[0]


@pytest.mark.parametrize("kw", [
    dict(speculative=True),
    dict(host_cache_bytes=1 << 20), dict(watchdog_secs=1.0),
    dict(fault_spec="nan@3")])
def test_unported_options_raise(models, kw):
    """The four options that the port used to refuse (speculative
    decoding, the host KV tier, the watchdog, the fault injector) now
    build an engine that serves the plain engine's greedy tokens (the
    fault spec stays disarmed without a warmup)."""
    _, _, tmodel, tparams = models
    eng = InferenceEngine(tmodel, tparams, EngineConfig(**ENGINE_KW, **kw))
    try:
        got = _serve(eng, SamplingParams, PROMPTS)
        _, plain = _engines(models)
        want = _serve(plain, SamplingParams, PROMPTS)
        assert [r.tokens for r in got] == [r.tokens for r in want]
        assert eng.stats()["speculative"] == bool(kw.get("speculative"))
        assert (eng.host_cache is not None) == ("host_cache_bytes" in kw)
        assert (eng.fault_injector is not None) == ("fault_spec" in kw)
    finally:
        eng.stop()


def test_stats_and_request_done_keep_the_jax_keys(models):
    jeng, teng = _engines(models)
    records = []
    teng.request_done_hook = records.append
    _serve(teng, SamplingParams, PROMPTS[:1])
    _serve(jeng, JaxSamplingParams, PROMPTS[:1])
    with open(os.path.join(REPO, ".graftlint.json")) as f:
        schema = json.load(f)["telemetry_schema"]
    assert set(records[0]) == set(schema["request_done_keys"])
    js, ts = jeng.stats(), teng.stats()
    assert set(ts) == set(js)
    assert set(ts["loop"]) == set(js["loop"])
    assert set(ts["cache"]) == set(js["cache"])
    assert ts["drafted_tokens"] == ts["engine_restarts"] == 0


def test_sampled_requests_follow_their_seed(models):
    """Sampled rows draw from per-request generators: the same seed gives
    the same tokens whatever the batch-mates, another seed other ones."""
    _, teng = _engines(models)
    sp = dict(max_new_tokens=10, temperature=1.0, top_k=20)
    alone = teng.submit(PROMPTS[1], SamplingParams(seed=7, **sp))
    _drive(teng, [alone])
    mates = [teng.submit(PROMPTS[1], SamplingParams(seed=s, **sp))
             for s in (7, 8)]
    mates.append(teng.submit(PROMPTS[2], _greedy(SamplingParams, 5)))
    _drive(teng, mates)
    assert mates[0].tokens == alone.tokens
    assert mates[1].tokens != alone.tokens


def test_serve_report_reads_a_port_replica_stream(models, tmp_path):
    """The stdlib tools/serve_report.py summarises the port engine's
    schema-13 JSONL stream unchanged."""
    import subprocess
    import sys

    from megatron_llm_torch import telemetry

    stream = telemetry.TelemetryStream(str(tmp_path))
    telemetry.install_stream(stream)
    try:
        _, teng = _engines(models)
        _serve(teng, SamplingParams, PROMPTS)
        teng.stop()
    finally:
        telemetry.install_stream(None)
        stream.close()
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "serve_report.py"),
         str(tmp_path), "--json"], capture_output=True, text=True,
        timeout=120)
    assert res.returncode == 0, res.stderr
    report = json.loads(res.stdout)
    assert report["summary"]["requests"] == len(PROMPTS)
    assert report["prefill"]["kernel"] == {"torch": len(PROMPTS)}
