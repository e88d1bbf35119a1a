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
from megatron_llm_torch.ops.kernels import layernorm as ln
from megatron_llm_torch.ops.kernels import paged_attention as pa
from megatron_llm_torch.ops.kernels import rmsnorm as rn
from megatron_llm_torch.quantization import absmax_quantize_int8

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
        ref = pa._reference_paged_attention(q[:, 0], kp, vp, bt, cl, None,
                                            None, scale, window)
        assert pa.decode_launches == before + 1
    else:
        before = pa.prefill_launches
        out = pa.paged_attention_prefill(q, kp, vp, bt, cl,
                                         sliding_window=window)
        ref = pa._reference_paged_prefill(q, kp, vp, bt, cl, None, None,
                                          scale, window)
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
    (1, 256, 4, 4, 256, None),      # G, head_dim 256
    (1, 200, 8, 1, 256, None),      # H, head_dim 256, MQA
    (1, 512, 8, 1, 256, None),      # G, Gemma-2B's MQA shape (nh 8, g 1)
    (1, 384, 16, 16, 256, 100),     # G, Gemma-7B's heads, window
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,nh,ng,d", [
    (256, 8, 1, 256),               # G, Gemma-2B's fused QKV
    (200, 8, 1, 256),               # H
    (256, 8, 2, 128),               # G, GQA: k and v views
])
def test_flash_views_take_the_dtype_variant(cuda, s, nh, ng, d, dtype):
    # fused-QKV views at other head_dims: in bf16 the forward builds its
    # TMA maps from the views' strides
    qpg = nh // ng
    gen = torch.Generator(device=cuda).manual_seed(s + nh + d)
    mixed = torch.randn(1, s, ng, qpg + 2, d, device=cuda,
                        generator=gen).to(dtype)
    q = mixed[:, :, :, :qpg].reshape(1, s, nh, d)
    k, v = mixed[:, :, :, qpg], mixed[:, :, :, qpg + 1]
    assert not k.is_contiguous() and fa._readable(k)
    do = torch.randn(1, s, nh, d, device=cuda, generator=gen).to(dtype)
    scale = 1.0 / math.sqrt(d)
    fa.variant_launches.clear()
    o, lse = fa.flash_attention_fwd(q, k, v, True, None, scale)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, True, None, scale)
    kind = "fused" if fa.uses_fused_backward(s, s) else "two_pass"
    assert fa.variant_launches == {
        fa.kernel_variant(dtype, d, "fwd"): 1,
        fa.kernel_variant(dtype, d, kind): 1}
    o0, lse0 = fa._reference_attention(q, k, v, True, None, scale)
    ref = fa._reference_attention_bwd(q, k, v, o, lse, do, True, None,
                                      scale)
    tol = TOL[dtype]
    torch.testing.assert_close(o.float(), o0.float(), rtol=0, atol=tol)
    torch.testing.assert_close(lse, lse0, rtol=0, atol=tol)
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
        err = (got.float() - want.float()).abs().max().item()
        size = want.float().abs().max().item()
        assert err <= tol * max(size, 1.0), (name, err, size)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,nh,d", [(1024, 71, 64), (512, 8, 256)])
def test_flash_head_split_backward_is_right_and_deterministic(cuda, s, nh,
                                                              d, dtype):
    # MQA: one KV group's heads split over blocks; dK/dV are fp32 partials
    # summed in split order, so two runs give the same bits
    bk = fa.TILES[(dtype, d)][1][1]
    splits = fa.head_splits(1, s, 1, nh, bk, fa._sm_count(cuda))
    assert splits > 1
    gen = torch.Generator(device=cuda).manual_seed(nh + d)
    q, do = (torch.randn(1, s, nh, d, device=cuda, generator=gen).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(1, s, 1, d, device=cuda, generator=gen).to(dtype)
            for _ in range(2))
    scale = 1.0 / math.sqrt(d)
    o, lse = fa._reference_attention(q, k, v, True, None, scale)
    one = fa.flash_attention_bwd(q, k, v, o, lse, do, True, None, scale)
    two = fa.flash_attention_bwd(q, k, v, o, lse, do, True, None, scale)
    assert torch.equal(one[1], two[1]) and torch.equal(one[2], two[2])
    ref = fa._reference_attention_bwd(q, k, v, o, lse, do, True, None,
                                      scale)
    for name, got, want in zip(("dq", "dk", "dv"), one, ref):
        err = (got.float() - want.float()).abs().max().item()
        size = want.float().abs().max().item()
        assert err <= TOL[dtype] * max(size, 1.0), (name, err, size)


def test_flash_tiles_match_the_kernels(cuda):
    import ctypes

    from megatron_llm_torch.ops.kernels import build

    lib = build.load_library()
    for dtype, code in ((torch.bfloat16, 1), (torch.float32, 0)):
        for d in fa.HEAD_DIMS:
            out = (ctypes.c_int * 8)()
            assert lib.mlt_flash_tiles(code, d, out) == 0
            assert tuple(out) == tuple(x for pair in fa.TILES[(dtype, d)]
                                       for x in pair)


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


# -- kernel A': ragged paged attention over int8 pools ----------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C,g,nh,d,window", [
    (1, 1, 71, 64, None), (64, 1, 71, 64, None), (1, 32, 32, 128, None),
    (64, 8, 32, 128, 5), (16, 2, 8, 32, 12), (1, 1, 8, 256, 100)])
def test_int8_paged_kernel_matches_plain(cuda, C, g, nh, d, window, dtype):
    S, bs, M = 4, 16, 24
    gen = torch.Generator(device=cuda).manual_seed(C + g + nh + d)
    ctx = [0, 5, 17, 300] if C == 1 else [0, 3, 16, 200]
    q = torch.randn(S, C, nh, d, device=cuda, generator=gen).to(dtype)
    P = 1 + S * M
    # values of unit size: a bf16 step is 0.03 above 4, more than the 2e-2
    kq, ks = absmax_quantize_int8(
        torch.randn(P, bs, g, d, device=cuda, generator=gen), axis=-1)
    vq, vs = absmax_quantize_int8(
        torch.randn(P, bs, g, d, device=cuda, generator=gen) * 0.5, axis=-1)
    bt = (torch.randperm(P - 1, device=cuda, generator=gen) + 1).reshape(
        S, M).to(torch.int32)
    cl = torch.tensor(ctx, dtype=torch.int32, device=cuda)
    scale = 1.0 / math.sqrt(d)
    plain = (pa.decode_launches, pa.prefill_launches)
    if C == 1:
        before = pa.quant_decode_launches
        out = pa.paged_attention_decode(q[:, 0].contiguous(), kq, vq, bt, cl,
                                        k_scales=ks, v_scales=vs,
                                        sliding_window=window)
        ref = pa._reference_paged_attention(q[:, 0], kq, vq, bt, cl, ks, vs,
                                            scale, window)
        assert pa.quant_decode_launches == before + 1
    else:
        before = pa.quant_prefill_launches
        out = pa.paged_attention_prefill(q, kq, vq, bt, cl, k_scales=ks,
                                         v_scales=vs, sliding_window=window)
        ref = pa._reference_paged_prefill(q, kq, vq, bt, cl, ks, vs, scale,
                                          window)
        assert pa.quant_prefill_launches == before + 1
    assert (pa.decode_launches, pa.prefill_launches) == plain
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=TOL[dtype])


def test_int8_paged_wrapper_refuses_mismatched_pools(cuda):
    q = torch.randn(2, 4, 64, device=cuda)
    kq = torch.zeros(3, 16, 1, 64, dtype=torch.int8, device=cuda)
    sc = torch.ones(3, 16, 1, device=cuda)
    bt = torch.ones(2, 2, dtype=torch.int32, device=cuda)
    cl = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):          # int8 pools without scales
        pa.paged_attention_decode(q, kq, kq, bt, cl)
    with pytest.raises(TypeError):          # scales beside float pools
        pa.paged_attention_decode(q, kq.float(), kq.float(), bt, cl,
                                  k_scales=sc, v_scales=sc)
    with pytest.raises(ValueError):         # scales of another shape
        pa.paged_attention_decode(q, kq, kq, bt, cl, k_scales=sc[:, :8],
                                  v_scales=sc[:, :8])
    with pytest.raises(ValueError):         # bf16 scales
        pa.paged_attention_decode(q, kq, kq, bt, cl, k_scales=sc.bfloat16(),
                                  v_scales=sc.bfloat16())


# -- kernels D and E: LayerNorm forward and backward ------------------------

LN_SHAPES = [(8, 4544), (64, 4544), (2048, 4544), (1000, 768), (3, 128),
             (300, 1600), (17, 11008)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,h", LN_SHAPES)
def test_layernorm_kernels_match_plain(cuda, n, h, dtype):
    g = torch.Generator(device=cuda).manual_seed(5 * n + h)
    # outputs below 4: above it a bf16 step (0.03) exceeds the tolerance
    x = (torch.randn(n, h, device=cuda, generator=g) * 3 + 2).to(dtype)
    s = (torch.rand(h, device=cuda, generator=g) * 0.4 + 0.4).to(dtype)
    b = (torch.randn(h, device=cuda, generator=g) * 0.1).to(dtype)
    gy = torch.randn(n, h, device=cuda, generator=g).to(dtype)
    d0, e0 = ln.launches, ln.bwd_launches
    y, mu, rstd = ln.layer_norm_fwd(x, s, b, 1e-5)
    y0, mu0, rstd0 = ln.layer_norm_fwd_plain(x, s, b, 1e-5)
    assert (ln.launches, ln.bwd_launches) == (d0 + 1, e0)
    tol = TOL[dtype]
    torch.testing.assert_close(y.float(), y0.float(), rtol=0, atol=tol)
    torch.testing.assert_close(mu, mu0, rtol=0, atol=1e-5)
    torch.testing.assert_close(rstd, rstd0, rtol=1e-5, atol=1e-6)
    dx, dg, db = ln.layer_norm_bwd(x, s, gy, mu0, rstd0)
    dx0, dg0, db0 = ln.layer_norm_bwd_plain(x, s, gy, mu0, rstd0)
    assert (ln.launches, ln.bwd_launches) == (d0 + 1, e0 + 1)
    torch.testing.assert_close(dx.float(), dx0.float(), rtol=0, atol=tol)
    # dgamma and dbeta sum n rows: relative to their size
    for got, want in ((dg, dg0), (db, db0)):
        size = want.abs().max().item() + 1.0
        assert (got - want).abs().max().item() <= tol * size
    # the column sums are taken in a fixed order: the same bits every run
    again = ln.layer_norm_bwd(x, s, gy, mu0, rstd0)
    assert torch.equal(again[1], dg) and torch.equal(again[2], db)


def test_layernorm_fp32_keeps_1e5_on_rows_with_a_large_mean(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(64, 4544, device=cuda, generator=g) + 30.0
    s = torch.rand(4544, device=cuda, generator=g) + 0.5
    b = torch.randn(4544, device=cuda, generator=g)
    y, _, _ = ln.layer_norm_fwd(x, s, b, 1e-5)
    want = ((x.double() - x.double().mean(-1, keepdim=True))
            * torch.rsqrt(x.double().var(-1, unbiased=False, keepdim=True)
                          + 1e-5) * s.double() + b.double())
    torch.testing.assert_close(y.double(), want, rtol=0, atol=1e-5)


def test_layernorm_kernel_path_has_a_grad_fn(cuda):
    x = torch.randn(2, 4, 4544, device=cuda, requires_grad=True)
    s = torch.ones(4544, device=cuda, requires_grad=True)
    b = torch.zeros(4544, device=cuda, requires_grad=True)
    y = ln.fused_layer_norm(x, s, b)
    assert y.grad_fn is not None
    d0, e0 = ln.launches, ln.bwd_launches
    # one output feeding two branches, one through a strided view
    loss = y.square().sum() + y.transpose(0, 1).sin().sum()
    gx, gs, gb = torch.autograd.grad(loss, (x, s, b))
    assert ln.launches == d0 and ln.bwd_launches == e0 + 1
    x0, s0, b0 = (t.detach().requires_grad_(True) for t in (x, s, b))
    y0 = torch.nn.functional.layer_norm(x0, (4544,), s0, b0, 1e-5)
    loss0 = y0.square().sum() + y0.transpose(0, 1).sin().sum()
    rx, rs, rb = torch.autograd.grad(loss0, (x0, s0, b0))
    torch.testing.assert_close(gx, rx, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(gs, rs, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(gb, rb, rtol=1e-4, atol=1e-3)


def test_layernorm_wrappers_refuse_instead_of_falling_back(cuda):
    x = torch.randn(4, 102, device=cuda)        # h not a 16-byte multiple
    one = torch.ones(102, device=cuda)
    with pytest.raises(ValueError):
        ln.layer_norm_fwd(x, one, one, 1e-5)
    x = torch.randn(4, 128, device=cuda)
    one = torch.ones(128, device=cuda)
    with pytest.raises(TypeError):              # fp32 x, bf16 params
        ln.layer_norm_fwd(x, one.bfloat16(), one.bfloat16(), 1e-5)
    with pytest.raises(ValueError):             # bias of another dtype
        ln.layer_norm_fwd(x.bfloat16(), one, one.bfloat16(), 1e-5)
    with pytest.raises(ValueError):             # strided rows
        ln.layer_norm_fwd_kernel(
            torch.randn(4, 256, device=cuda)[:, :128], one, one, 1e-5)
    with pytest.raises(ValueError):             # statistics of another run
        ln.layer_norm_bwd(x, one, x, torch.zeros(3, 1, device=cuda),
                          torch.ones(3, 1, device=cuda))
