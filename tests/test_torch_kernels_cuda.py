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

from megatron_llm_torch.ops.kernels import flash_attention as fa
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
@pytest.mark.parametrize("n,h", [(8, 4096), (64, 4096), (3, 128),
                                 (4096, 4096), (1000, 4096)])
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
    # strided inputs: the kernels read dense rows
    q = torch.randn(2, 8, 64, device=cuda)[:, ::2]
    kp = torch.randn(3, 16, 4, 64, device=cuda)
    assert not q.is_contiguous()
    with pytest.raises(ValueError):
        pa.paged_attention_decode(q, kp, kp, bt, cl)
    with pytest.raises(ValueError):
        pa.paged_attention_decode(
            q.contiguous(),
            torch.randn(3, 16, 64, 4, device=cuda).transpose(2, 3), kp, bt,
            cl)
    x = torch.randn(4, 256, device=cuda)[:, :128]
    with pytest.raises(ValueError):
        rn.rms_norm_fwd_kernel(x, torch.ones(128, device=cuda), 1e-5)


# -- kernel C: the RMSNorm backward, and the autograd function around B/C --

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,h", [(4096, 4096), (300, 4096), (3, 128)])
def test_rmsnorm_bwd_kernel_matches_plain(cuda, n, h, dtype):
    g = torch.Generator(device=cuda).manual_seed(7 * n + h)
    x = (torch.randn(n, h, device=cuda, generator=g) * 3).to(dtype)
    s = (torch.rand(h, device=cuda, generator=g) + 0.5).to(dtype)
    gy = torch.randn(n, h, device=cuda, generator=g).to(dtype)
    _, rstd = rn.rms_norm_fwd_plain(x, s, 1e-5)
    before = rn.bwd_launches
    dx, ds = rn.rms_norm_bwd(x, s, gy, rstd)
    dx0, ds0 = rn.rms_norm_bwd_plain(x, s, gy, rstd)
    assert rn.bwd_launches == before + 1
    torch.testing.assert_close(dx.float(), dx0.float(), rtol=0,
                               atol=TOL[dtype])
    # dscale sums n rows: relative to its size
    scale = ds0.abs().max().item() + 1.0
    assert (ds - ds0).abs().max().item() <= TOL[dtype] * scale


def test_rmsnorm_kernel_path_has_a_grad_fn(cuda):
    x = torch.randn(8, 4096, device=cuda, requires_grad=True)
    s = torch.ones(4096, device=cuda, requires_grad=True)
    y = rn.fused_rms_norm(x, s)
    assert y.grad_fn is not None
    b0, c0 = rn.launches, rn.bwd_launches
    gx, gs = torch.autograd.grad(y.square().sum(), (x, s))
    assert rn.launches == b0 and rn.bwd_launches == c0 + 1
    x0 = x.detach().requires_grad_(True)
    s0 = s.detach().requires_grad_(True)
    y0, _ = rn.rms_norm_fwd_plain(x0, s0, 1e-5)
    rx, rs = torch.autograd.grad(y0.square().sum(), (x0, s0))
    torch.testing.assert_close(gx, rx, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(gs, rs, rtol=1e-4, atol=1e-3)


def test_rmsnorm_strided_rows(cuda):
    # x = wide[..., :h]: reshape(-1, h) is a view with row stride 2h.  The
    # kernel wrappers refuse it; the autograd function normalises a dense
    # copy, forward and backward.
    h = 256
    wide = torch.randn(4, 8, 2 * h, device=cuda)
    x = wide[..., :h]
    s = (torch.rand(h, device=cuda) + 0.5)
    with pytest.raises(ValueError):
        rn.rms_norm_fwd_kernel(x.reshape(-1, h), s, 1e-5)
    with pytest.raises(ValueError):
        rn.rms_norm_bwd_kernel(x.contiguous().reshape(-1, h), s,
                               x.reshape(-1, h), torch.ones(32, 1,
                                                            device=cuda))
    xk = x.detach().requires_grad_(True)
    sk = s.detach().requires_grad_(True)
    b0, c0 = rn.launches, rn.bwd_launches
    y = rn.fused_rms_norm(xk, sk)
    gx, gs = torch.autograd.grad(y.square().sum(), (xk, sk))
    assert (rn.launches, rn.bwd_launches) == (b0 + 1, c0 + 1)
    x0 = x.detach().requires_grad_(True)
    s0 = s.detach().requires_grad_(True)
    y0, _ = rn.rms_norm_fwd_plain(x0.reshape(-1, h), s0, 1e-5)
    rx, rs = torch.autograd.grad(y0.square().sum(), (x0, s0))
    torch.testing.assert_close(y.reshape(-1, h), y0, rtol=0, atol=1e-4)
    torch.testing.assert_close(gx, rx, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(gs, rs, rtol=1e-4, atol=1e-3)


# -- kernels F, G, H: flash attention forward and backward -----------------

FA_CASES = [  # (b, s, nh, ng, d, window)
    (1, 256, 4, 4, 128, None),      # G
    (2, 192, 8, 2, 64, None),       # G, GQA qpg 4
    (1, 200, 4, 1, 128, None),      # H (ragged last tile), MQA
    (1, 256, 8, 2, 128, 100),       # G, window cutting inside a tile
    (1, 130, 4, 4, 64, 7),          # H, small window
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,nh,ng,d,window", FA_CASES)
def test_flash_kernels_match_plain(cuda, b, s, nh, ng, d, window, dtype):
    gen = torch.Generator(device=cuda).manual_seed(s + nh + ng + d)
    q, k, v, do = (torch.randn(b, s, heads, d, device=cuda, generator=gen)
                   .to(dtype) for heads in (nh, ng, ng, nh))
    scale = 1.0 / math.sqrt(d)
    f0 = fa.fwd_launches
    o, lse = fa.flash_attention_fwd(q, k, v, True, window, scale)
    o0, lse0 = fa._reference_attention(q, k, v, True, window, scale)
    assert fa.fwd_launches == f0 + 1
    tol = TOL[dtype]
    torch.testing.assert_close(o.float(), o0.float(), rtol=0, atol=tol)
    torch.testing.assert_close(lse, lse0, rtol=0, atol=tol)
    fused = fa.uses_fused_backward(s, s)
    g0, h0 = fa.bwd_fused_launches, fa.bwd_launches
    grads = fa.flash_attention_bwd(q, k, v, o0, lse0, do, True, window,
                                   scale)
    ref = fa._reference_attention_bwd(q, k, v, o0, lse0, do, True, window,
                                      scale)
    assert (fa.bwd_fused_launches, fa.bwd_launches) == (
        (g0 + 1, h0) if fused else (g0, h0 + 1))
    # gradients relative to each one's size (sums over s keys or rows)
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
        err = (got.float() - want.float()).abs().max().item()
        size = want.float().abs().max().item()
        assert err <= tol * max(size, 1.0), (name, err, size)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,nh,ng,window", [
    (256, 4, 4, None),              # G, q, k and v all views
    (200, 4, 4, None),              # H, q, k and v all views
    (200, 8, 2, 7),                 # H, GQA: k and v views
])
def test_flash_kernels_read_fused_qkv_views(cuda, s, nh, ng, window, dtype):
    # the views of one fused [b, s, ng, qpg + 2, d] QKV tensor that the
    # model passes, read through their strides (no copy is made)
    d, qpg = 64, nh // ng
    gen = torch.Generator(device=cuda).manual_seed(s + nh + ng)
    mixed = torch.randn(1, s, ng, qpg + 2, d, device=cuda,
                        generator=gen).to(dtype)
    q = mixed[:, :, :, :qpg].reshape(1, s, nh, d)
    k, v = mixed[:, :, :, qpg], mixed[:, :, :, qpg + 1]
    assert not k.is_contiguous() and fa._readable(k) and fa._readable(q)
    do = torch.randn(1, s, nh, d, device=cuda, generator=gen).to(dtype)
    scale = 1.0 / math.sqrt(d)
    o, lse = fa.flash_attention_fwd(q, k, v, True, window, scale)
    o0, lse0 = fa._reference_attention(q, k, v, True, window, scale)
    tol = TOL[dtype]
    torch.testing.assert_close(o.float(), o0.float(), rtol=0, atol=tol)
    torch.testing.assert_close(lse, lse0, rtol=0, atol=tol)
    grads = fa.flash_attention_bwd(q, k, v, o0, lse0, do, True, window,
                                   scale)
    ref = fa._reference_attention_bwd(q, k, v, o0, lse0, do, True, window,
                                      scale)
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
        err = (got.float() - want.float()).abs().max().item()
        size = want.float().abs().max().item()
        assert err <= tol * max(size, 1.0), (name, err, size)


def test_flash_rows_no_key_reaches(cuda):
    # sq > sk with a window: the last query rows see no key
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(1, 96, 2, 64, device=cuda, generator=gen)
    k = torch.randn(1, 40, 2, 64, device=cuda, generator=gen)
    o, lse = fa.flash_attention_fwd(q, k, k, True, 8, 0.125)
    o0, lse0 = fa._reference_attention(q, k, k, True, 8, 0.125)
    assert (o[0, 50:] == 0).all() and (lse[0, :, 50:] == fa.NEG_INF).all()
    torch.testing.assert_close(o, o0, rtol=0, atol=1e-4)
    grads = fa.flash_attention_bwd(q, k, k, o, lse, torch.ones_like(q),
                                   True, 8, 0.125)
    assert all(torch.isfinite(g).all() for g in grads)


def test_flash_autograd_on_the_card(cuda):
    q = torch.randn(1, 128, 4, 64, device=cuda, requires_grad=True)
    k = torch.randn(1, 128, 2, 64, device=cuda, requires_grad=True)
    v = torch.randn(1, 128, 2, 64, device=cuda, requires_grad=True)
    out = fa.flash_attention(q, k, v)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out.square().sum(), (q, k, v))
    qd, kd, vd = (t.detach().requires_grad_(True) for t in (q, k, v))
    ref, _ = fa._reference_attention(qd, kd, vd, True, None, 0.125)
    want = torch.autograd.grad(ref.square().sum(), (qd, kd, vd))
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_paged_wrappers_refuse_inputs_that_require_grad(cuda):
    q = torch.randn(2, 4, 64, device=cuda, requires_grad=True)
    kp = torch.randn(3, 16, 4, 64, device=cuda)
    bt = torch.ones(2, 2, dtype=torch.int32, device=cuda)
    cl = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        pa.paged_attention_decode(q, kp, kp, bt, cl)
