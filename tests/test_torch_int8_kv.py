"""The int8 paged KV cache of the port against the JAX package's:

* ``absmax_quantize_int8``: int8 values and scales equal to the JAX
  function's, on fp32 and bf16 inputs, with zero rows and exact ties;
* paged attention over int8 pools, decode and prefill: the port's plain
  version (what the wrapper runs on a CPU tensor) against the JAX Pallas
  kernel in interpret mode at 2e-5, and within the quantisation drift
  bound of the JAX test (< 0.2 of the oracle's std) of a float oracle;
* the paged model forward over int8 pools, from the same params: the int8
  pages the two packages write are equal (their scales to the last bit
  or two), logits within 1e-4 (fp32);
* the engine with ``int8_kv_cache=True``: the same greedy tokens as the
  JAX engine, and a forced copy-on-write copies the scales too.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.models.falcon import FalconModel as JaxFalcon
from megatron_llm_tpu.models.falcon import falcon_config as jax_falcon_config
from megatron_llm_tpu.models.language_model import (
    language_model_forward as jax_forward)
from megatron_llm_tpu.models.llama import LlamaModel as JaxLlama
from megatron_llm_tpu.models.llama import llama_config as jax_llama_config
from megatron_llm_tpu.ops.pallas import paged_attention as jpa
from megatron_llm_tpu.quantization import absmax_quantize_int8 as jax_quantize
from megatron_llm_tpu.serving import EngineConfig as JaxEngineConfig
from megatron_llm_tpu.serving import InferenceEngine as JaxEngine
from megatron_llm_tpu.serving import SamplingParams as JaxSamplingParams
from megatron_llm_tpu.text_generation.generation import (
    init_paged_kv_caches as jax_init_pools)
from megatron_llm_torch.models.falcon import FalconModel, falcon_config
from megatron_llm_torch.models.language_model import language_model_forward
from megatron_llm_torch.models.llama import LlamaModel, llama_config
from megatron_llm_torch.ops.kernels import paged_attention as tpa
from megatron_llm_torch.quantization import absmax_quantize_int8
from megatron_llm_torch.serving import (
    EngineConfig,
    InferenceEngine,
    SamplingParams,
)
from megatron_llm_torch.text_generation.generation import init_paged_kv_caches
from megatron_llm_torch.weights import params_from_jax

torch.set_num_threads(1)
BS, D, M = 8, 16, 6


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = jpa._INTERPRET
    jpa._INTERPRET = True
    yield
    jpa._INTERPRET = old


# ---------------------------------------------------------------------------
# the quantiser
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("axis", [-1, -2])
def test_absmax_quantize_int8_equals_jax(dtype, axis):
    rng = np.random.default_rng(0)
    t = (rng.standard_normal((3, 5, 2, 16)) * 4).astype(np.float32)
    t[0, 0] = 0.0                          # all-zero rows: scale 1
    t[1, 1, 0] = np.arange(16) * 0.5       # exact .5 ties after scaling
    t[1, 1, 0, -1] = 63.5
    jt = jnp.asarray(t)
    tt = torch.from_numpy(t)
    if dtype == "bf16":
        jt = jt.astype(jnp.bfloat16)
        tt = torch.from_numpy(np.asarray(jt, np.float32)).to(torch.bfloat16)
    want_q, want_s = jax_quantize(jt, axis=axis)
    got_q, got_s = absmax_quantize_int8(tt, axis=axis)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


# ---------------------------------------------------------------------------
# paged attention over int8 pools
# ---------------------------------------------------------------------------

def _case(rng, g, nh, ctx, C):
    """Linear K/V per slot scattered into a page pool through a shuffled
    block table, the chunk's C keys included; positions past ctx + C and
    unowned pages hold amplified garbage."""
    S = len(ctx)
    L = M * BS
    q = rng.standard_normal((S, C, nh, D)).astype(np.float32)
    k_lin = rng.standard_normal((S, L, g, D)).astype(np.float32)
    v_lin = rng.standard_normal((S, L, g, D)).astype(np.float32)
    for s in range(S):
        k_lin[s, int(ctx[s]) + C:] *= 100.0
        v_lin[s, int(ctx[s]) + C:] *= 100.0
    P = 1 + S * M
    kp = (rng.standard_normal((P, BS, g, D)) * 100.0).astype(np.float32)
    vp = (rng.standard_normal((P, BS, g, D)) * 100.0).astype(np.float32)
    bt = np.zeros((S, M), np.int32)
    free = list(1 + rng.permutation(S * M))
    for s in range(S):
        for j in range(-(-(int(ctx[s]) + C) // BS)):
            bt[s, j] = free.pop()
            kp[bt[s, j]] = k_lin[s, j * BS:(j + 1) * BS]
            vp[bt[s, j]] = v_lin[s, j * BS:(j + 1) * BS]
    return q, k_lin, v_lin, kp, vp, bt


def _oracle(q, k_lin, v_lin, ctx, scale, window):
    S, C, nh, d = q.shape
    L, g = k_lin.shape[1], k_lin.shape[2]
    qpg = nh // g
    out = np.zeros_like(q)
    kpos = np.arange(L)
    for s in range(S):
        for j in range(C):
            pos = int(ctx[s]) + j
            valid = kpos <= pos
            if window is not None:
                valid &= kpos > pos - window
            for h in range(nh):
                sc = (k_lin[s, :, h // qpg] @ q[s, j, h]) * scale
                sc = np.where(valid, sc, -np.inf)
                p = np.where(valid, np.exp(sc - sc[valid].max()), 0.0)
                out[s, j, h] = (p / p.sum()) @ v_lin[s, :, h // qpg]
    return out


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("window", [None, 12])
@pytest.mark.parametrize("g,nh", [(1, 1), (2, 4), (1, 8)])
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_int8_pools_match_the_jax_kernel_and_the_drift_bound(kind, g, nh,
                                                             window):
    rng = np.random.default_rng(42 + 7 * g + nh + (window or 0))
    if kind == "decode":
        ctx, C = np.asarray([0, 5, 17, 31], np.int32), 1
    else:
        ctx, C = np.asarray([0, 3, 8, 17], np.int32), 16
    q, k_lin, v_lin, kp, vp, bt = _case(rng, g, nh, ctx, C)
    scale = 1.0 / math.sqrt(D)
    kq, ks = jax_quantize(jnp.asarray(kp), axis=-1)
    vq, vs = jax_quantize(jnp.asarray(vp), axis=-1)
    jargs = (kq, vq, jnp.asarray(bt), jnp.asarray(ctx))
    targs = _t(kq, vq, bt, ctx)
    tks, tvs = _t(ks, vs)
    if kind == "decode":
        want = np.asarray(jpa.paged_attention_decode(
            jnp.asarray(q[:, 0]), *jargs, k_scales=ks, v_scales=vs,
            sliding_window=window))[:, None]
        got = tpa.paged_attention_decode(
            torch.from_numpy(q[:, 0].copy()), *targs, k_scales=tks,
            v_scales=tvs, sliding_window=window).numpy()[:, None]
    else:
        want = np.asarray(jpa.paged_attention_prefill(
            jnp.asarray(q), *jargs, k_scales=ks, v_scales=vs,
            sliding_window=window))
        got = tpa.paged_attention_prefill(
            torch.from_numpy(q), *targs, k_scales=tks, v_scales=tvs,
            sliding_window=window).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    oracle = _oracle(q, k_lin, v_lin, ctx, scale, window)
    drift = np.max(np.abs(got - oracle)) / (np.std(oracle) + 1e-6)
    assert drift < 0.2, drift


def test_scales_come_in_pairs_and_pools_keep_the_jax_layout():
    q, kp, bt, cl = _t(np.zeros((1, 2, D), np.float32),
                       np.zeros((3, BS, 1, D), np.int8),
                       np.zeros((1, 2), np.int32), np.zeros(1, np.int32))
    with pytest.raises(ValueError):
        tpa.paged_attention_decode(q, kp, kp, bt, cl,
                                   k_scales=torch.ones(3, BS, 1))
    cfg = llama_config("tiny", num_attention_heads_kv=2)
    jcfg = jax_llama_config("tiny", num_attention_heads_kv=2)
    got = init_paged_kv_caches(cfg, 5, BS, device="cpu", quantized=True)
    want = jax_init_pools(jcfg, 5, BS, quantized=True)
    assert len(got) == len(want) == cfg.num_layers
    for name, arr in want[0].items():
        t = got[0][name]
        assert tuple(t.shape) == arr.shape and str(t.dtype).endswith(
            str(arr.dtype)), name
        np.testing.assert_array_equal(t.numpy(), np.asarray(arr))
    assert set(got[0]) == set(want[0])


# ---------------------------------------------------------------------------
# the model's paged branch over int8 pools
# ---------------------------------------------------------------------------

KW = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
          ffn_hidden_size=96, padded_vocab_size=64, seq_length=32,
          max_position_embeddings=32)
FAMILY = {
    "llama_gqa": (JaxLlama, jax_llama_config, LlamaModel, llama_config,
                  dict(num_attention_heads_kv=2)),
    "falcon_mqa": (JaxFalcon, jax_falcon_config, FalconModel, falcon_config,
                   dict()),
}


def _models(name):
    jcls, jcfg_fn, tcls, tcfg_fn, extra = FAMILY[name]
    kw = dict(KW, **extra)
    jmodel = jcls(jcfg_fn("tiny", use_flash_attn=False, **kw))
    jparams = jmodel.init(jax.random.PRNGKey(3))
    tcfg = tcfg_fn("tiny", **kw)
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    return jmodel, jparams, tcls(tcfg, device="cpu"), tparams


def _step(fwd, params, cfg, pools, bt, tokens, ctx, valid, to_arr):
    caches = [dict({k: to_arr(v) for k, v in p.items()},
                   block_tables=to_arr(bt), context_lens=to_arr(ctx),
                   valid_lens=to_arr(valid)) for p in pools]
    n = tokens.shape[1]
    pos = (ctx[:, None] + np.arange(n)[None, :]).astype(np.int64)
    logits, new = fwd(params, to_arr(tokens), to_arr(pos), None, cfg,
                      kv_caches=caches)
    names = ("k_pages_q", "k_pages_scale", "v_pages_q", "v_pages_scale")
    return np.asarray(logits), [{k: np.array(c[k]) for k in names}
                                for c in new]


@pytest.mark.parametrize("name", sorted(FAMILY))
def test_paged_forward_over_int8_pools_matches_jax(name):
    """Two slots prefill an 8-token chunk (the second has 5 valid tokens),
    a second chunk that crosses pages, then decode two steps; after every
    step the int8 pages and scales of every live page are equal in the
    two packages and the logits agree."""
    jmodel, jparams, tmodel, tparams = _models(name)
    tcfg, jcfg = tmodel.cfg, jmodel.cfg
    S, Mp, bs = 2, 6, 4
    P = 1 + S * Mp
    pools_j = [{k: np.asarray(v) for k, v in p.items()}
               for p in jax_init_pools(jcfg, P, bs, quantized=True)]
    pools_t = [{k: v.copy() for k, v in p.items()} for p in pools_j]
    bt = (1 + np.arange(S * Mp)).reshape(S, Mp).astype(np.int32)
    rng = np.random.default_rng(2)
    valids = [np.array([8, 8], np.int32), np.array([8, 5], np.int32),
              np.array([1, 1], np.int32), np.array([1, 1], np.int32)]
    tokens = rng.integers(0, 64, (2, 8))
    ctx = np.array([0, 0], np.int32)
    for step, valid in enumerate(valids):
        lj, pools_j = _step(jax_forward, jparams, jcfg, pools_j, bt, tokens,
                            ctx, valid, jnp.asarray)
        lt, pools_t = _step(language_model_forward, tparams, tcfg, pools_t,
                            bt, tokens, ctx, valid, torch.from_numpy)
        for s in range(2):
            np.testing.assert_allclose(lt[s, :valid[s]], lj[s, :valid[s]],
                                       atol=1e-4, rtol=0,
                                       err_msg=f"step {step} slot {s}")
        ctx = ctx + valid
        for layer, (pj, pt) in enumerate(zip(pools_j, pools_t)):
            for key in pj:
                # every page but the garbage block 0, where the padded
                # rows of both packages land in an unspecified order
                msg = f"step {step} layer {layer} {key}"
                if key.endswith("_q"):
                    np.testing.assert_array_equal(pt[key][1:], pj[key][1:],
                                                  err_msg=msg)
                else:
                    # the K/V that are quantised come out of matmuls that
                    # sum in another order in the two frameworks, so a
                    # scale may differ in its last bit
                    np.testing.assert_allclose(pt[key][1:], pj[key][1:],
                                               rtol=1e-6, atol=0,
                                               err_msg=msg)
        if step == 0:
            tokens = rng.integers(0, 64, (2, 8))
        else:
            tokens = lj[np.arange(2), valid - 1].argmax(-1).reshape(2, 1)
    assert pools_t[0]["k_pages_q"].dtype == np.int8
    assert np.abs(pools_t[0]["k_pages_q"][1:]).max() == 127


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

ENGINE_KW = dict(num_slots=4, block_size=8, prefill_chunk=16,
                 max_model_len=64, int8_kv_cache=True)
EKW = dict(num_layers=2, seq_length=64, max_position_embeddings=64,
           padded_vocab_size=64)
PROMPTS = [[(5 * i + 3) % 60 + 1 for i in range(n)] for n in (3, 17, 30, 9)]


@pytest.fixture(scope="module")
def engines():
    jmodel = JaxFalcon(jax_falcon_config("tiny", use_flash_attn=False, **EKW))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = falcon_config("tiny", **EKW)
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    tmodel = FalconModel(tcfg, device="cpu")
    return (JaxEngine(jmodel, jparams, JaxEngineConfig(**ENGINE_KW)),
            InferenceEngine(tmodel, tparams, EngineConfig(**ENGINE_KW)))


def _serve(engine, sp_cls, prompts, n=8):
    reqs = [engine.submit(p, sp_cls(max_new_tokens=n, temperature=0.0))
            for p in prompts]
    for _ in range(2000):
        if all(r.state == "done" for r in reqs):
            return reqs
        engine.step()
    raise AssertionError("engine did not finish the requests")


def test_int8_engine_serves_the_jax_engines_greedy_tokens(engines):
    jeng, teng = engines
    assert set(teng._st.pages[0]) == {"k_pages_q", "k_pages_scale",
                                      "v_pages_q", "v_pages_scale"}
    want = _serve(jeng, JaxSamplingParams, PROMPTS)
    got = _serve(teng, SamplingParams, PROMPTS)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert all(r.finish_reason == "length" for r in got)
    js, ts = jeng.stats(), teng.stats()
    assert set(ts) == set(js)
    for key in ("decode_steps", "prefill_chunks", "tokens_generated",
                "prefill_tokens_computed", "blocks_total"):
        assert ts[key] == js[key], key


def test_int8_copy_on_write_copies_pages_and_scales(engines):
    _, teng = engines
    common = [(3 * i + 1) % 60 + 1 for i in range(16)]
    c, d = common + [5, 6, 7], common + [8, 9]
    base = [r.tokens for r in _serve(teng, SamplingParams, [c, d])]
    st = teng._st
    greedy = SamplingParams(max_new_tokens=8, temperature=0.0)
    rc, rd = teng.submit(c, greedy), teng.submit(d, greedy)
    teng.step()                     # admits both; both adopt the prefix
    assert rc.cached_prompt_tokens == rd.cached_prompt_tokens == 16
    old = int(st.blocks.tables[rc.slot, 0])
    assert old == int(st.blocks.tables[rd.slot, 0])
    teng._writable(st, rc.slot, 0)
    new = int(st.blocks.tables[rc.slot, 0])
    assert new != old
    for layer in st.pages:
        assert len(layer) == 4
        for name, pool in layer.items():
            assert torch.equal(pool[new], pool[old]), name
        # a written page: its scales are no longer the initial ones
        assert not torch.equal(layer["k_pages_scale"][new],
                               torch.ones_like(layer["k_pages_scale"][new]))
    for _ in range(2000):
        if rc.state == rd.state == "done":
            break
        teng.step()
    assert [rc.tokens, rd.tokens] == base
