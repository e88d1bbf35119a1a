"""The host KV tier of the port (``serving/host_cache.py`` and the
engine's spill and swap-in) against the JAX package's.

* The ``HostKVCache`` copy under the JAX copy's operation sequence: the
  same block manager churn drives both (a numpy page as the fetch), and
  after every operation the managers' and the tiers' counters and the
  tiers' entries are equal.
* In the engine, with a pool small enough that fillers evict a shared
  prefix: the prefix comes back by swap-in (``prefix_cache_host_hits``
  counted), with the tokens of an engine without the tier and the JAX
  engine's counts; a host entry that went missing truncates the cached
  prefix at the gap, as in the JAX engine.
* The swapped-in pages are the spilled pages, byte for byte.
"""

import random

import jax
import numpy as np
import pytest
import torch

from megatron_llm_tpu.models.llama import LlamaModel as JaxLlama
from megatron_llm_tpu.models.llama import llama_config as jax_llama_config
from megatron_llm_tpu.serving import BlockManager as JaxBlockManager
from megatron_llm_tpu.serving import EngineConfig as JaxEngineConfig
from megatron_llm_tpu.serving import HostKVCache as JaxHostKVCache
from megatron_llm_tpu.serving import InferenceEngine as JaxEngine
from megatron_llm_tpu.serving import NoCapacity as JaxNoCapacity
from megatron_llm_tpu.serving import SamplingParams as JaxSamplingParams
from megatron_llm_torch.models.llama import LlamaModel, llama_config
from megatron_llm_torch.serving import (
    BlockManager,
    EngineConfig,
    InferenceEngine,
    NoCapacity,
    SamplingParams,
    chain_block_digests,
)
from megatron_llm_torch.serving.host_cache import HostKVCache
from megatron_llm_torch.weights import params_from_jax

torch.set_num_threads(1)
BS = 4


def _fetch(manager, block):
    return np.full((2, BS), block, np.float32)


def _tiers(cls_bm, cls_host):
    host = cls_host(6, 1, fetch=_fetch).start()
    bm = cls_bm(num_blocks=13, block_size=BS, num_slots=3,
                max_blocks_per_slot=8, prefix_cache=True, host_cache=host)
    return bm, host


def _swap_ins(bm, host, slot):
    loaded = []
    for _idx, b, d in bm.take_pending_swap_ins(slot):
        assert host.take_for_swap_in(d) is not None
        loaded.append((b, d))
    bm.complete_swap_ins(slot, loaded)
    if loaded:
        host.note_swap_in(len(loaded), 0.0)


def _state(bm, host):
    hs = host.stats()
    hs.pop("swap_in_secs_total", None)
    with host._lock:
        entries = [(d, e.data.tolist(), e.pins)
                   for d, e in host._entries.items()]
    return bm.stats(), hs, entries


def test_host_kv_cache_follows_the_jax_copy_under_churn():
    rng = random.Random(3)
    pairs = [_tiers(BlockManager, HostKVCache),
             _tiers(JaxBlockManager, JaxHostKVCache)]
    try:
        prompts = [[rng.randrange(1, 6) for _ in range(rng.randrange(3, 17))]
                   for _ in range(6)]
        live = {}
        for _ in range(300):
            op = rng.random()
            if op < 0.45 and len(live) < 3:
                p = rng.choice(prompts)
                total = len(p) + rng.randrange(1, 8)
                slots = []
                for (bm, host), exc in zip(pairs, (NoCapacity, JaxNoCapacity)):
                    try:
                        slots.append(bm.alloc(total, prompt_tokens=p))
                    except exc:
                        slots.append(None)
                assert slots[0] == slots[1]
                if slots[0] is None:
                    continue
                for bm, host in pairs:
                    _swap_ins(bm, host, slots[0])
                live[slots[0]] = (p, pairs[0][0].slot_cached_tokens(slots[0]))
            elif op < 0.7 and live:
                s = rng.choice(sorted(live))
                p, cached = live[s]
                n = rng.randrange(cached, len(p) + 1)
                for bm, _ in pairs:
                    bm.commit_prefix(s, p, n)
            elif live:
                s = rng.choice(sorted(live))
                p, _ = live.pop(s)
                n = rng.randrange(0, len(p) + 1)
                for bm, _ in pairs:
                    bm.free(s, token_ids=p, n_written=n)
            for bm, host in pairs:
                assert host.drain()
                bm.check_invariants()
            assert _state(*pairs[0]) == _state(*pairs[1])
        assert pairs[0][1].stats()["spills_completed"] > 0
        assert pairs[0][0].stats()["prefix_cache_host_hits"] > 0
    finally:
        for _, host in pairs:
            host.close()


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

KW = dict(num_layers=2, seq_length=64, max_position_embeddings=64,
          padded_vocab_size=64)
ENGINE_KW = dict(num_slots=4, block_size=8, prefill_chunk=16,
                 max_model_len=64, num_blocks=13, default_deadline_secs=0.0)
PROMPT = [1, 2, 3, 4, 5, 6, 7, 8] * 4 + [9]     # 33 tokens: 4 full pages
HOST_BYTES = 64 << 20


@pytest.fixture(scope="module")
def models():
    jmodel = JaxLlama(jax_llama_config("tiny", use_flash_attn=False, **KW))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = llama_config("tiny", **KW)
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    return jmodel, jparams, LlamaModel(tcfg, device="cpu"), tparams


def _run(engine, sp_cls, prompt, n=4):
    req = engine.submit(prompt, sp_cls(max_new_tokens=n, temperature=0.0,
                                       eod_id=63))
    for _ in range(500):
        if req.state == "done":
            break
        engine.step()
    assert req.state == "done"
    if engine.host_cache is not None:
        assert engine.host_cache.drain(timeout=30)
    return req


def _evict(engine, sp_cls):
    """Distinct fillers until none of PROMPT's prefix pages is in the
    pool (they stay in the host tier)."""
    digests = chain_block_digests(PROMPT, 8, 4)
    for i in range(40):
        if not any(engine.blocks.host_spill_check(d) for d in digests):
            return i
        _run(engine, sp_cls, [10 + i] * 25 + [i % 7 + 1], n=2)
    raise AssertionError("the fillers never evicted the prompt")


def _swap_sequence(engine, sp_cls, drop=None):
    """PROMPT, fillers until it left the pool, PROMPT again (with the
    host entry of page ``drop`` gone, if given)."""
    r1 = _run(engine, sp_cls, PROMPT)
    fillers = _evict(engine, sp_cls)
    if drop is not None and engine.host_cache is not None:
        gone = chain_block_digests(PROMPT, 8, 4)[drop]
        take = engine.host_cache.take_for_swap_in

        def take_missing(digest):
            return None if digest == gone else take(digest)

        engine.host_cache.take_for_swap_in = take_missing
    r2 = _run(engine, sp_cls, PROMPT)
    return r1, r2, fillers


@pytest.mark.parametrize("drop", [None, 2], ids=["whole", "missing_entry"])
def test_swap_in_brings_the_prefix_back_like_jax(models, drop):
    jmodel, jparams, tmodel, tparams = models
    teng = InferenceEngine(tmodel, tparams, EngineConfig(
        **ENGINE_KW, host_cache_bytes=HOST_BYTES))
    jeng = JaxEngine(jmodel, jparams, JaxEngineConfig(
        **ENGINE_KW, host_cache_bytes=HOST_BYTES))
    plain = InferenceEngine(tmodel, tparams, EngineConfig(**ENGINE_KW))
    try:
        got = _swap_sequence(teng, SamplingParams, drop)
        want = _swap_sequence(jeng, JaxSamplingParams, drop)
        base = _swap_sequence(plain, SamplingParams)
    finally:
        for eng in (teng, jeng):
            eng.stop()
    r1, r2, fillers = got
    assert fillers == want[2] == base[2]
    blocks = 4 if drop is None else drop
    assert r2.host_hit_blocks == want[1].host_hit_blocks == blocks
    assert r2.cached_prompt_tokens == want[1].cached_prompt_tokens \
        == 8 * blocks
    assert r2.swap_in_secs > 0
    # the tokens of the run without the tier (which recomputes)
    assert base[1].host_hit_blocks == 0
    assert r1.tokens == r2.tokens == base[1].tokens == want[1].tokens
    ts, js = teng.stats(), jeng.stats()
    for key in ("prefix_cache_host_hits", "prefix_cache_hit_tokens",
                "prefill_tokens_cached", "prefill_tokens_computed"):
        assert ts[key] == js[key], key
    # admission matched all 4 pages in the tier; the swap-in loaded those
    # before the gap
    assert ts["prefix_cache_host_hits"] == 4
    assert ts["cache"]["host"]["swap_in_blocks"] == blocks
    teng.blocks.check_invariants()


def test_swapped_in_pages_are_the_spilled_pages(models):
    """Page bytes survive the round trip: after the swap-in, the pool
    pages of the prompt's prefix equal the first run's pages."""
    _swapped_in_pages_are_the_spilled_pages(models, int8=False)


def test_swapped_in_int8_pages_are_the_spilled_pages(models):
    """The same over int8 pools: the int8 pages and their fp32 scales
    share one stored page and both come back."""
    _swapped_in_pages_are_the_spilled_pages(models, int8=True)


def _swapped_in_pages_are_the_spilled_pages(models, int8):
    _, _, tmodel, tparams = models
    eng = InferenceEngine(tmodel, tparams, EngineConfig(
        **ENGINE_KW, host_cache_bytes=HOST_BYTES, int8_kv_cache=int8))
    try:
        r1 = _run(eng, SamplingParams, PROMPT)
        digests = chain_block_digests(PROMPT, 8, 4)
        before = [eng._fetch_block_impl(
            eng._st.pages, eng.blocks.host_spill_check(d)[0])
            for d in digests]
        _evict(eng, SamplingParams)
        req = eng.submit(PROMPT, SamplingParams(max_new_tokens=4,
                                                temperature=0.0))
        eng.step()                  # admits and swaps in, then prefills
        assert req.host_hit_blocks == 4
        # the fetch's layout is every layer's pool arrays, flattened to
        # bytes: equal bytes are equal pages in every array of every layer
        for i, page in enumerate(before):
            now = int(eng.blocks.tables[req.slot, i])
            assert torch.equal(eng._fetch_block_impl(eng._st.pages, now),
                               page), i
        for _ in range(100):
            if req.state == "done":
                break
            eng.step()
        assert req.tokens == r1.tokens
    finally:
        eng.stop()
