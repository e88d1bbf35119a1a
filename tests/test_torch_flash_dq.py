"""H's dQ pass on the CPU: ``_reference_dq_tiles``, the plain version of
the bf16 dQ kernel's walk (its q-tiles, the k-tiles each reaches under
the causal band and the window, the ragged last tiles), against the JAX
package's ``_bwd_call`` dq, the Pallas kernels in interpret mode as
tests/test_torch_flash_attention.py runs them.  Lengths that are no
multiple of 64, windows, MHA/GQA/MQA, head_dim 64/128/256; fp32, atol
2e-5 (the grads' tolerance of the JAX tests).  And the walk itself: its
tile is ``TILES``' dQ tile, it visits every visible (query, key) pair
exactly once, and ``kernel_variant`` names the new kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import megatron_llm_tpu.ops.pallas.flash_attention as F
from megatron_llm_torch.ops.kernels import flash_attention as tfa

torch.set_num_threads(1)
GRAD_ATOL = 2e-5
BLOCK = 64


@pytest.fixture(autouse=True)
def _interpret():
    F._INTERPRET = True
    yield
    F._INTERPRET = False


def _inputs(s, nh, ng, d, seed):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((1, s, nh, d)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((1, s, ng, d)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((1, s, ng, d)) * 0.3).astype(np.float32)
    do = rng.standard_normal((1, s, nh, d)).astype(np.float32)
    return q, k, v, do


CASES = [  # (s, nh, ng, d, window)
    (40, 2, 2, 64, None), (100, 4, 2, 64, 30), (200, 4, 1, 64, None),
    (100, 2, 2, 128, None), (200, 4, 4, 128, 50), (40, 4, 1, 128, 8),
    (100, 2, 1, 256, None), (140, 2, 2, 256, 70),
]


@pytest.mark.parametrize("s,nh,ng,d,window", CASES)
def test_dq_walk_matches_the_jax_two_pass_backward(s, nh, ng, d, window):
    q, k, v, do = _inputs(s, nh, ng, d, seed=s + d)
    scale = 1.0 / np.sqrt(d)
    jq, jk, jv, jdo = (jnp.swapaxes(jnp.asarray(t), 1, 2)
                       for t in (q, k, v, do))
    o, lse = F._fwd_call(jq, jk, jv, scale=scale, causal=True,
                         window=window, block_q=BLOCK, block_k=BLOCK)
    dq, _, _ = F._bwd_call(jq, jk, jv, o, lse, jdo, scale=scale,
                           causal=True, window=window, block_q=BLOCK,
                           block_k=BLOCK)
    want = np.asarray(jnp.swapaxes(dq, 1, 2))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    to = torch.from_numpy(np.array(jnp.swapaxes(o, 1, 2)))
    tlse = torch.from_numpy(np.array(lse)[..., 0])
    got = tfa._reference_dq_tiles(tq, tk, tv, to, tlse, tdo, True, window,
                                  scale)
    np.testing.assert_allclose(got.numpy(), want, atol=GRAD_ATOL, rtol=0)
    # the walk and the whole-row plain backward give one dq
    whole = tfa._reference_attention_bwd(tq, tk, tv, to, tlse, tdo, True,
                                         window, scale)[0]
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=GRAD_ATOL,
                               rtol=0)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("s,window", [(1000, None), (100, None), (200, 30),
                                      (40, 8)])
def test_dq_walk_visits_every_visible_pair_once(d, s, window):
    br, bc = tfa.TILES[(torch.bfloat16, d)][2]
    walk = tfa._dq_walk(s, s, d, True, window)
    assert [q0 for q0, _, _ in walk] == list(range(0, s, br))
    seen = torch.zeros(s, s, dtype=torch.int32)
    for q0, q1, ktiles in walk:
        assert q1 - q0 == min(br, s - q0)
        for k0, k1 in ktiles:
            assert k0 % bc == 0 and k1 - k0 == min(bc, s - k0)
            seen[q0:q1, k0:k1] += 1
    vis = tfa._visible(s, s, True, window, "cpu")
    assert (seen[vis] == 1).all() and (seen <= 1).all()


def test_two_pass_variants_and_tiles():
    for d in tfa.HEAD_DIMS:
        assert tfa.kernel_variant(torch.bfloat16, d, "two_pass") == \
            "bwd_two_pass_bf16_wgmma"
        assert tfa.kernel_variant(torch.float32, d, "two_pass") == \
            "bwd_two_pass_fp32"
        # 64 query rows a consumer warpgroup, two of them below d 256;
        # 64-key tiles through the ring
        assert tfa.TILES[(torch.bfloat16, d)][2] == (
            64 if d == 256 else 128, 64)
