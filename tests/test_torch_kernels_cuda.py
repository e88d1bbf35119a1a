"""The port's CUDA kernels against their plain versions on the card (the
CPU has no kernel to run: every test here skips without a CUDA device).
This file imports no jax, so it also runs on a GPU machine without it:

    python -m pytest tests/test_torch_kernels_cuda.py

Tolerances: bf16 2e-2 (tests/test_pallas_kernels.py), fp32 1e-4.  Also
checks, everywhere, that a wrapper refuses what its kernel does not
take instead of falling back."""

import math

import pytest
import torch

from megatron_llm_torch.ops.kernels import paged_attention as pa
from megatron_llm_torch.ops.kernels import rmsnorm as rn

torch.set_num_threads(1)
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,h", [(8, 4096), (64, 4096), (3, 128)])
def test_rmsnorm_kernel_matches_plain(cuda, n, h, dtype):
    g = torch.Generator(device=cuda).manual_seed(n + h)
    x = (torch.randn(n, h, device=cuda, generator=g) * 3).to(dtype)
    s = (torch.rand(h, device=cuda, generator=g) + 0.5).to(dtype)
    before = rn.launches
    y, r = rn.rms_norm_fwd(x, s, 1e-5)
    y0, r0 = rn.rms_norm_fwd_plain(x, s, 1e-5)
    assert rn.launches == before + 1
    torch.testing.assert_close(y.float(), y0.float(), rtol=0,
                               atol=TOL[dtype])
    torch.testing.assert_close(r, r0, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C,g,nh,window", [
    (1, 32, 32, None), (1, 8, 32, 4096), (64, 32, 32, None),
    (64, 8, 32, 5), (16, 2, 8, 12)])
def test_paged_kernel_matches_plain(cuda, C, g, nh, window, dtype):
    S, d, bs, M = 4, 128, 16, 24
    gen = torch.Generator(device=cuda).manual_seed(C + g + nh)
    ctx = [0, 5, 17, 300] if C == 1 else [0, 3, 16, 200]
    q = torch.randn(S, C, nh, d, device=cuda, generator=gen).to(dtype)
    P = 1 + S * M
    kp = torch.randn(P, bs, g, d, device=cuda, generator=gen).to(dtype)
    vp = torch.randn(P, bs, g, d, device=cuda, generator=gen).to(dtype)
    bt = (torch.randperm(P - 1, device=cuda, generator=gen) + 1).reshape(
        S, M).to(torch.int32)
    cl = torch.tensor(ctx, dtype=torch.int32, device=cuda)
    scale = 1.0 / math.sqrt(d)
    if C == 1:
        before = pa.decode_launches
        out = pa.paged_attention_decode(q[:, 0].contiguous(), kp, vp, bt, cl,
                                        sliding_window=window)
        ref = pa._reference_paged_attention(q[:, 0], kp, vp, bt, cl, scale,
                                            window)
        assert pa.decode_launches == before + 1
    else:
        before = pa.prefill_launches
        out = pa.paged_attention_prefill(q, kp, vp, bt, cl,
                                         sliding_window=window)
        ref = pa._reference_paged_prefill(q, kp, vp, bt, cl, scale, window)
        assert pa.prefill_launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=TOL[dtype])


def test_wrappers_refuse_instead_of_falling_back(cuda):
    x = torch.randn(4, 102, device=cuda)        # h not a 16-byte multiple
    with pytest.raises(ValueError):
        rn.rms_norm_fwd(x, torch.ones(102, device=cuda), 1e-5)
    with pytest.raises(TypeError):
        rn.rms_norm_fwd(x.half(), torch.ones(102, device=cuda).half(), 1e-5)
    q = torch.randn(2, 4, 48, device=cuda)      # head_dim 48: no kernel
    kp = torch.randn(3, 16, 4, 48, device=cuda)
    bt = torch.ones(2, 2, dtype=torch.int32, device=cuda)
    cl = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        pa.paged_attention_decode(q, kp, kp, bt, cl)
