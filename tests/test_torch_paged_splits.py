"""Kernels A and A' with their keys split over blocks, and their plan, on
the CPU (no CUDA code path runs here).

* The plain version of one split launch (``_reference_split_partials``)
  followed by the plain version of the merge kernel
  (``_reference_merge``) gives the JAX package's
  ``paged_attention_prefill`` / ``paged_attention_decode`` (the Pallas
  kernel in interpret mode), fp32, atol 1e-5: splits from 1 to one a key
  tile, windows None, 5 and 12, both kernels' tiles, plain and int8
  pools; also where a split reaches no key of some row (m = -inf, l = 0).
* The splits of a block tile its key range exactly, in order.
* For the serving shape of every preset the port serves (decode of 8
  slots, a prefill chunk of 64), the plan on an H100's 132 SMs is the
  variant and the splits pinned here, at a head_dim the kernels take.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.ops.pallas import paged_attention as jpa
from megatron_llm_torch import models
from megatron_llm_torch.ops.kernels import paged_attention as tpa
from megatron_llm_torch.quantization import absmax_quantize_int8

torch.set_num_threads(1)
ATOL = 1e-5
H100_SMS = 132
BS, D, M = 8, 16, 6
CTX = np.asarray([0, 3, 8, 29], np.int32)


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = jpa._INTERPRET
    jpa._INTERPRET = True
    yield
    jpa._INTERPRET = old


def _pools(rng, S, g, live_tokens):
    """Pools with each slot's live pages at shuffled physical indices;
    every other page (and the garbage block 0) is large noise."""
    P = 1 + S * M
    k = (rng.standard_normal((P, BS, g, D)) * 100.0).astype(np.float32)
    v = (rng.standard_normal((P, BS, g, D)) * 100.0).astype(np.float32)
    bt = (1 + rng.permutation(S * M)).reshape(S, M).astype(np.int32)
    for s in range(S):
        for j in range(min(M, -(-int(live_tokens[s]) // BS))):
            k[bt[s, j]] = rng.standard_normal((BS, g, D))
            v[bt[s, j]] = rng.standard_normal((BS, g, D))
    return k, v, bt


_JAX_CACHE = {}


def _jax_prefill(key, q, kp, vp, bt, ks, vs, window):
    """The JAX package's prefill on these inputs, once per ``key``."""
    if key not in _JAX_CACHE:
        _JAX_CACHE[key] = np.asarray(jpa.paged_attention_prefill(
            *(jnp.asarray(a) for a in (q, kp, vp, bt, CTX)),
            k_scales=None if ks is None else jnp.asarray(ks),
            v_scales=None if vs is None else jnp.asarray(vs),
            sliding_window=window))
    return _JAX_CACHE[key]


def _split_then_merge(q, kp, vp, bt, cl, ks, vs, window, tiles, splits):
    tr, tk = tiles
    o, m, l = tpa._reference_split_partials(
        q, kp, vp, bt, cl, ks, vs, 1.0 / math.sqrt(D), window,
        tile_rows=tr, tile_keys=tk, splits=splits)
    return tpa._reference_merge(o, m, l, q.dtype), m


# (tile rows, tile keys): the tensor-core kernel's tile and CUDA-core ones
TILES = [(64, 64), (4, 16), (1, 8), (2, 16)]
# key tiles of the table (M * BS = 48 keys): 1 .. one split a tile of 8
SPLITS = [1, 2, 3, 6]


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("window", [None, 5, 12])
@pytest.mark.parametrize("g,nh", [(1, 4), (2, 4)])
def test_split_prefill_merges_to_jax(g, nh, window, tiles, splits,
                                     quantized):
    C = 16
    rng = np.random.default_rng(100 * g + nh + (window or 0))
    q = rng.standard_normal((len(CTX), C, nh, D)).astype(np.float32)
    kp, vp, bt = _pools(rng, len(CTX), g, CTX + C)
    ks = vs = None
    if quantized:
        kq, ksc = absmax_quantize_int8(torch.from_numpy(kp), axis=-1)
        vq, vsc = absmax_quantize_int8(torch.from_numpy(vp), axis=-1)
        kp, vp, ks, vs = (kq.numpy(), vq.numpy(), ksc.numpy(), vsc.numpy())
    want = _jax_prefill((g, nh, window, quantized), q, kp, vp, bt, ks, vs,
                        window)
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (q, kp, vp, bt, CTX)]
    sc = [None if a is None else torch.from_numpy(a) for a in (ks, vs)]
    got, _ = _split_then_merge(*t, *sc, window, tiles, splits)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("window", [None, 5, 12])
@pytest.mark.parametrize("g,nh", [(1, 1), (2, 4), (1, 8)])
def test_split_decode_merges_to_jax(g, nh, window, splits):
    lens = np.asarray([0, 5, 17, 40], np.int32)
    rng = np.random.default_rng(7 * g + nh + (window or 0))
    q = rng.standard_normal((len(lens), nh, D)).astype(np.float32)
    kp, vp, bt = _pools(rng, len(lens), g, lens + 1)
    key = ("decode", g, nh, window)
    if key not in _JAX_CACHE:
        _JAX_CACHE[key] = np.asarray(jpa.paged_attention_decode(
            *(jnp.asarray(a) for a in (q, kp, vp, bt, lens)),
            sliding_window=window))
    want = _JAX_CACHE[key]
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (q[:, None], kp, vp, bt, lens)]
    for tiles in ((64, 64), (1, 8)):
        got, _ = _split_then_merge(*t, None, None, window, tiles, splits)
        np.testing.assert_allclose(got[:, 0].numpy(), want, atol=ATOL,
                                   rtol=0)


def test_a_split_no_key_reaches_weighs_nothing():
    # slot 0 at context 0: its rows reach keys 0..15, two 8-key tiles
    # over three splits, so some split holds no key for its first rows
    rng = np.random.default_rng(3)
    C, nh, g = 16, 2, 1
    q = rng.standard_normal((len(CTX), C, nh, D)).astype(np.float32)
    kp, vp, bt = _pools(rng, len(CTX), g, CTX + C)
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (q, kp, vp, bt, CTX)]
    got, m = _split_then_merge(*t, None, None, 5, (64, 8), 3)
    first_rows = m[:, 0, :4]                       # [splits, 4, nh]
    assert (first_rows == float("-inf")).any(0).all()
    assert torch.isfinite(first_rows).any(0).all()
    want = np.asarray(jpa.paged_attention_prefill(
        *(jnp.asarray(a) for a in (q, kp, vp, bt, CTX)), sliding_window=5))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_one_split_is_the_plain_version():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((len(CTX), 16, 4, D)).astype(np.float32)
    kp, vp, bt = _pools(rng, len(CTX), 2, CTX + 16)
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (q, kp, vp, bt, CTX)]
    got, _ = _split_then_merge(*t, None, None, None, (4, 16), 1)
    want = tpa._reference_paged_prefill(*t, None, None, 1.0 / math.sqrt(D),
                                        None)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("window", [None, 7, 100])
@pytest.mark.parametrize("tiles,splits", [((64, 64), 4), ((1, 16), 9),
                                          ((4, 32), 2)])
def test_splits_tile_the_key_range_in_order(tiles, splits, window):
    cl = torch.tensor([0, 15, 200, 1000], dtype=torch.int32)
    C, qpg, Mt, bs = 8, 3, 80, 16
    r = tpa._split_key_ranges(cl, C, qpg, Mt, bs, window, *tiles, splits)
    a, b = r[..., 0], r[..., 1]
    assert (a <= b).all()
    assert (a[1:] == b[:-1]).all()         # split i + 1 starts where i ends
    assert (a % tiles[1] == 0).all()
    rows = torch.arange(C * qpg)
    pos_hi = cl.long()[:, None] + (torch.clamp(
        rows // tiles[0] * tiles[0] + tiles[0], max=C * qpg) - 1) // qpg
    hi = torch.clamp(pos_hi, max=Mt * bs - 1)
    # the last split ends with the tile that holds the block's last key
    assert (b[-1] == (hi // tiles[1] + 1) * tiles[1]).all()


# The plan of the serving shape of every family the port serves (decode
# of 8 slots, a prefill chunk of 64; 16-token pages, a table of up to 4096
# positions) on an H100's 132 SMs, as "variant splits": bf16 decode, bf16
# prefill, fp32 decode, fp32 prefill, the same over plain and int8 pools.
# Fixed values: a change of the rule shows here, and is measured again by
# chip_smoke.py's sweeps of the rows threshold and the splits.
SERVED_PLANS = {
    ("llama_config", "7B"): ("simt 1", "mma 4", "simt 1", "simt 1"),
    ("falcon_config", "7B"): ("mma 8", "mma 5", "simt 4", "simt 1"),
    ("mistral_config", "7B"): ("mma 2", "mma 4", "simt 2", "simt 1"),
    ("qwen2_config", "7B"): ("mma 4", "mma 9", "simt 2", "simt 2"),
    ("qwen2_config", "0.5B"): ("mma 8", "mma 9", "simt 4", "simt 4"),
    ("gemma_config", "2B"): ("mma 15", "mma 15", "simt 8", "simt 1"),
    ("gemma_config", "7B"): ("simt 1", "mma 8", "simt 1", "simt 1"),
    ("gpt2_config", "125M"): ("simt 4", "mma 10", "simt 4", "simt 2"),
    ("gpt_neox_config", "1b"): ("simt 2", "mma 15", "simt 2", "simt 1"),
    ("gpt_neox_config", "6.9b"): ("simt 1", "mma 4", "simt 1", "simt 1"),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("config_fn,size", list(SERVED_PLANS))
def test_every_served_preset_has_a_plan(config_fn, size, quantized, dtype):
    cfg = getattr(models, config_fn)(size)
    nh, g, d = (cfg.num_attention_heads, cfg.num_query_groups, cfg.head_dim)
    bs = 16
    M = -(-min(cfg.max_position_embeddings, 4096) // bs)
    assert d in tpa.HEAD_DIMS, (config_fn, size, d)
    want = SERVED_PLANS[(config_fn, size)]
    want = want[:2] if dtype == torch.bfloat16 else want[2:]
    for (S, C), w in zip(((8, 1), (1, 64)), want):
        variant, tr, tk, splits = tpa.plan(dtype, S, C, nh, g, d, bs, M,
                                           quantized, H100_SMS)
        assert f"{variant} {splits}" == w, (config_fn, size, S, C)
        assert (tr, tk) == tpa.tile_shape(variant, dtype, C * nh // g, d,
                                          quantized)


def test_plan_routes_the_timed_shapes():
    # (dtype, S, C, nh, g, d, quantized) -> variant, tile rows, splits
    bf = torch.bfloat16
    assert tpa.plan(bf, 1, 64, 32, 32, 128, 16, 128, False, 132) == \
        ("mma", 64, 64, 4)                       # Llama-2-7B prefill
    assert tpa.plan(bf, 8, 1, 32, 32, 128, 16, 128, False, 132) == \
        ("simt", 1, 64, 1)                       # Llama-2-7B decode
    assert tpa.plan(bf, 1, 64, 71, 1, 64, 16, 128, True, 132) == \
        ("mma", 64, 64, 5)                       # Falcon-7B prefill
    assert tpa.plan(bf, 8, 1, 71, 1, 64, 16, 128, True, 132) == \
        ("mma", 64, 64, 8)                       # Falcon-7B decode
    assert tpa.plan(torch.float32, 8, 1, 71, 1, 64, 16, 128, True,
                    132)[0] == "simt"
    assert tpa.kernel_variant(bf, 1, 64, False) == "simt"
    assert tpa.kernel_variant(bf, 2, 64, False) == "mma"
    assert tpa.plan(bf, 8, 1, 32, 8, 128, 16, 128, False, 132)[0] == "mma"
    with pytest.raises(ValueError):
        tpa.kernel_variant(bf, 16, 48, False)
    with pytest.raises(TypeError):
        tpa.kernel_variant(torch.float16, 16, 64, False)


def test_long_tables_split_to_fit_the_page_list():
    """A split stages its block-table entries in shared memory (4096 of
    them, the kernels' kPagesSmem): Llama-3.1's 131072 positions at 16 a
    page take at least 3 splits, short tables none more."""
    assert tpa.table_splits(128, 16, 64) == 1
    assert tpa.table_splits(4094, 16, 64) == 1
    assert tpa.table_splits(8192, 16, 64) == 3
    for M, bs, tk in ((8192, 16, 64), (8192, 16, 16), (16384, 8, 64),
                      (65536, 16, 64)):
        n = tpa.table_splits(M, bs, tk)
        assert tpa.pages_cap(M, bs, n, tk) <= tpa.PAGES_SMEM_ENTRIES
        assert n == 1 or tpa.pages_cap(M, bs, n - 1, tk) \
            > tpa.PAGES_SMEM_ENTRIES
    # the plan takes them at Llama-3.1's serving shapes, decode and prefill
    bf = torch.bfloat16
    for S, C in ((8, 1), (1, 64)):
        variant, _, tk, splits = tpa.plan(bf, S, C, 32, 8, 128, 16, 8192,
                                          False, H100_SMS)
        assert splits >= tpa.table_splits(8192, 16, tk) == 3
