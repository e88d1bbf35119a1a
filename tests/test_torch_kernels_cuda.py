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

from megatron_llm_torch.ops.kernels import build
from megatron_llm_torch.ops.kernels import flash_attention as fa
from megatron_llm_torch.ops.kernels import layernorm as ln
from megatron_llm_torch.ops.kernels import norm_plan
from megatron_llm_torch.ops.kernels import paged_attention as pa
from megatron_llm_torch.ops.kernels import rmsnorm as rn
from megatron_llm_torch.quantization import absmax_quantize_int8

torch.set_num_threads(1)
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# bf16 paged attention, also: each row's largest error against the fp32
# plain version within this share of the row's largest |value| (the
# outputs of a row at context ~1000 are ~0.05, where 2e-2 alone says
# little; PERF.md gives the measured error)
PAGED_ROW_REL = 1e-2


def _assert_paged_close(out, ref32, dtype):
    """The kernel's output against the plain version computed in fp32
    (``ref32``): within TOL of it rounded to ``dtype``, and in bf16 also
    within PAGED_ROW_REL of each row's largest |value|."""
    torch.testing.assert_close(out.float(), ref32.to(dtype).float(), rtol=0,
                               atol=TOL[dtype])
    if dtype == torch.bfloat16:
        err = (out.float() - ref32).abs().amax(-1)
        rel = err / ref32.abs().amax(-1).clamp_min(1e-6)
        assert rel.max().item() <= PAGED_ROW_REL, rel.max().item()


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
        ref = pa._reference_paged_attention(q[:, 0].float(), kp, vp, bt, cl,
                                            None, None, scale, window)
        assert pa.decode_launches == before + 1
    else:
        before = pa.prefill_launches
        out = pa.paged_attention_prefill(q, kp, vp, bt, cl,
                                         sliding_window=window)
        ref = pa._reference_paged_prefill(q.float(), kp, vp, bt, cl, None,
                                          None, scale, window)
        assert pa.prefill_launches == before + 1
    _assert_paged_close(out, ref, dtype)


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,h", [(8, 4096), (300, 4096), (37, 768),
                                 (64, 5120), (5, 128)])
def test_rmsnorm_every_plan_matches_plain(cuda, n, h, dtype):
    g = torch.Generator(device=cuda).manual_seed(3 * n + h)
    x = (torch.randn(n, h, device=cuda, generator=g) * 3).to(dtype)
    s = (torch.rand(h, device=cuda, generator=g) + 0.5).to(dtype)
    y0, r0 = rn.rms_norm_fwd_plain(x, s, 1e-5)
    for t, v, rows in _plans(h, dtype):
        # a grid smaller than the rows: blocks walk several row groups
        for grid in (-(-n // rows), max(1, n // (3 * rows))):
            p = (t, v, rows, grid)
            before = dict(rn.plan_launches)
            y, r = rn.rms_norm_fwd_kernel(x, s, 1e-5, force_plan=p)
            assert rn.plan_launches[p] == before.get(p, 0) + 1
            torch.testing.assert_close(y.float(), y0.float(), rtol=0,
                                       atol=TOL[dtype], msg=str(p))
            torch.testing.assert_close(r, r0, rtol=1e-5, atol=1e-6)
            # without rstd: the same y; a rerun: the same bits
            y2, none = rn.rms_norm_fwd_kernel(x, s, 1e-5, rstd=False,
                                              force_plan=p)
            again = rn.rms_norm_fwd_kernel(x, s, 1e-5, force_plan=p)
            assert none is None and torch.equal(y2, y)
            assert torch.equal(again[0], y) and torch.equal(again[1], r)


def test_norms_without_a_gradient_keep_no_statistics(cuda):
    x = torch.randn(2, 4, 4096, device=cuda).bfloat16()
    s = (torch.rand(4096, device=cuda) + 0.5).bfloat16()
    b = torch.randn(4096, device=cuda).bfloat16()
    want = rn.rms_norm_fwd_kernel(x.reshape(-1, 4096), s, 1e-5)[0]
    want_ln = ln.layer_norm_fwd_kernel(x, s, b, 1e-5)[0]
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            b0, d0 = rn.launches, ln.launches
            y = rn.fused_rms_norm(x, s)
            y_ln = ln.fused_layer_norm(x, s, b)
            assert (rn.launches, ln.launches) == (b0 + 1, d0 + 1)
        assert y.grad_fn is None and y_ln.grad_fn is None
        assert torch.equal(y.reshape(-1, 4096), want)
        assert torch.equal(y_ln, want_ln)
    # grad mode on, but no input requires a gradient: the same path
    y = rn.fused_rms_norm(x, s)
    assert y.grad_fn is None and torch.equal(y.reshape(-1, 4096), want)


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


H_CASES = [  # (s, nh, ng, d, window, views): H's two passes
    (1000, 32, 32, 128, None, False),   # Llama-2-7B's sequence-1000 step
    (100, 4, 4, 64, None, False),       # one ragged tile of 100 rows
    (1000, 32, 8, 128, 100, False),     # GQA with a window
    (1000, 71, 1, 64, None, False),     # Falcon-7B's MQA heads
    (1000, 71, 1, 64, None, True),      # ... as the model's fused QKV views
    (1000, 16, 16, 256, None, False),   # Gemma-7B's heads of 256
    (200, 8, 1, 256, 30, True),         # Gemma-2B's views with a window
    (40, 4, 2, 128, None, True),        # shorter than one q-tile
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,nh,ng,d,window,views", H_CASES)
def test_flash_two_pass_backward(cuda, s, nh, ng, d, window, views, dtype):
    # H against its plain version, launched as its variant; dq, dk and dv
    # are the same bits on a second run (each dq row is written by one
    # block, dK/dV splits are summed in a fixed order)
    gen = torch.Generator(device=cuda).manual_seed(s + nh + d)
    if views:
        qpg = nh // ng
        mixed = torch.randn(1, s, ng, qpg + 2, d, device=cuda,
                            generator=gen).to(dtype)
        q = mixed[:, :, :, :qpg].reshape(1, s, nh, d)
        k, v = mixed[:, :, :, qpg], mixed[:, :, :, qpg + 1]
    else:
        q = torch.randn(1, s, nh, d, device=cuda, generator=gen).to(dtype)
        k, v = (torch.randn(1, s, ng, d, device=cuda, generator=gen)
                .to(dtype) for _ in range(2))
    do = torch.randn(1, s, nh, d, device=cuda, generator=gen).to(dtype)
    scale = 1.0 / math.sqrt(d)
    o, lse = fa._reference_attention(q, k, v, True, window, scale)
    assert not fa.uses_fused_backward(s, s)
    before = dict(fa.variant_launches)
    one = fa.flash_attention_bwd(q, k, v, o, lse, do, True, window, scale)
    moved = {key: n for key, n in fa.variant_launches.items()
             if n != before.get(key, 0)}
    assert moved == {fa.kernel_variant(dtype, d, "two_pass"):
                     before.get(fa.kernel_variant(dtype, d, "two_pass"), 0)
                     + 1}
    two = fa.flash_attention_bwd(q, k, v, o, lse, do, True, window, scale)
    for a, b in zip(one, two):
        assert torch.equal(a, b)
    ref = fa._reference_attention_bwd(q, k, v, o, lse, do, True, window,
                                      scale)
    tol = TOL[dtype]
    for name, got, want in zip(("dq", "dk", "dv"), one, ref):
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
    splits = fa.head_splits(1, s, 1, nh, bk, build.sm_count(cuda))
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

    lib = build.load_library()
    for dtype, code in ((torch.bfloat16, 1), (torch.float32, 0)):
        for d in fa.HEAD_DIMS:
            out = (ctypes.c_int * 8)()
            assert lib.mlt_flash_tiles(code, d, out) == 0
            assert tuple(out) == tuple(x for pair in fa.TILES[(dtype, d)]
                                       for x in pair)
            smem = (ctypes.c_longlong * 4)()
            assert lib.mlt_flash_smem(code, d, smem) == 0
            assert max(smem) <= 232448
            if dtype == torch.bfloat16:
                # H's dQ pass: Q and dO of its q-tile, a two-stage ring
                # of K and V tiles, 5 mbarriers, 1024 bytes of alignment
                br, bc = fa.TILES[(dtype, d)][2]
                assert smem[2] == (1024 + 2 * br * d * 2
                                   + 2 * 2 * bc * d * 2 + 8 * 5)


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
        ref = pa._reference_paged_attention(q[:, 0].float(), kq, vq, bt, cl,
                                            ks, vs, scale, window)
        assert pa.quant_decode_launches == before + 1
    else:
        before = pa.quant_prefill_launches
        out = pa.paged_attention_prefill(q, kq, vq, bt, cl, k_scales=ks,
                                         v_scales=vs, sliding_window=window)
        ref = pa._reference_paged_prefill(q.float(), kq, vq, bt, cl, ks, vs,
                                          scale, window)
        assert pa.quant_prefill_launches == before + 1
    assert (pa.decode_launches, pa.prefill_launches) == plain
    _assert_paged_close(out, ref, dtype)


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


# -- A and A': both variants, the key splits, the plan --------------------

def _paged_inputs(cuda, S, C, nh, g, d, quantized, dtype, seed, bs=16,
                  M=24):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    ctx = [0, 5, 17, 300][:S] if C == 1 else [0, 3, 16, 200][:S]
    q = torch.randn(S, C, nh, d, device=cuda, generator=gen).to(dtype)
    P = 1 + S * M
    k = torch.randn(P, bs, g, d, device=cuda, generator=gen)
    v = torch.randn(P, bs, g, d, device=cuda, generator=gen) * 0.5
    if quantized:
        (k, ks), (v, vs) = (absmax_quantize_int8(k, axis=-1),
                            absmax_quantize_int8(v, axis=-1))
    else:
        k, v, ks, vs = k.to(dtype), v.to(dtype), None, None
    bt = (torch.randperm(P - 1, device=cuda, generator=gen) + 1).reshape(
        S, M).to(torch.int32)
    cl = torch.tensor(ctx, dtype=torch.int32, device=cuda)
    return q, k, v, bt, cl, ks, vs


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("variant,dtype", [
    ("mma", torch.bfloat16), ("simt", torch.bfloat16),
    ("simt", torch.float32)])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("C,g,nh,window", [(1, 1, 8, None), (16, 2, 8, 12),
                                           (64, 4, 4, None)])
def test_paged_variants_match_plain(cuda, C, g, nh, window, d, variant,
                                    dtype, quantized):
    q, k, v, bt, cl, ks, vs = _paged_inputs(cuda, 4, C, nh, g, d, quantized,
                                            dtype, C + g + nh + d)
    scale = 1.0 / math.sqrt(d)
    out = pa._ragged_call(q, k, v, bt, cl, ks, vs, scale=scale,
                          window=window, variant=variant)
    ref = pa._reference_paged_prefill(q.float(), k, v, bt, cl, ks, vs, scale,
                                      window)
    _assert_paged_close(out, ref, dtype)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("variant,dtype", [
    ("mma", torch.bfloat16), ("simt", torch.bfloat16),
    ("simt", torch.float32)])
def test_paged_forced_splits_agree_and_repeat(cuda, variant, dtype,
                                              quantized):
    # 1 to 12 splits of a 384-key table: each within tolerance of the plain
    # version and the same bits on a second run (the merge adds the splits
    # in order, with no atomics)
    q, k, v, bt, cl, ks, vs = _paged_inputs(cuda, 4, 16, 8, 2, 128,
                                            quantized, dtype, 7)
    scale = 1.0 / math.sqrt(128)
    ref = pa._reference_paged_prefill(q.float(), k, v, bt, cl, ks, vs, scale,
                                      None)
    merges = pa.merge_launches
    for splits in (1, 2, 3, 5, 8, 12):
        outs = [pa._ragged_call(q, k, v, bt, cl, ks, vs, scale=scale,
                                window=None, variant=variant, splits=splits)
                for _ in range(2)]
        _assert_paged_close(outs[0], ref, dtype)
        assert torch.equal(outs[0], outs[1]), splits
    assert pa.merge_launches == merges + 2 * 5


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("variant,dtype", [
    ("mma", torch.bfloat16), ("simt", torch.bfloat16),
    ("simt", torch.float32)])
@pytest.mark.parametrize("C,g,nh,d,window,splits", [
    (1, 1, 8, 64, None, 4), (1, 4, 4, 128, 12, 3), (16, 2, 8, 128, None, 5),
    (64, 4, 4, 32, 5, 2), (16, 1, 8, 256, None, 3)])
def test_paged_split_partials_match_the_reference(cuda, C, g, nh, d, window,
                                                   splits, variant, dtype,
                                                   quantized):
    # one split launch's partials (o, m, l), as the merge reads them,
    # against its plain version at the tile the plan states for the
    # variant: the splits' key ranges (the kernels' block_of against
    # _split_key_ranges), a split that reaches no key of a row (m = -inf,
    # l = 0, from the slot at context 0 on), then the merge
    q, k, v, bt, cl, ks, vs = _paged_inputs(cuda, 4, C, nh, g, d, quantized,
                                            dtype, C + g + d + splits)
    scale = 1.0 / math.sqrt(d)
    out, o, m, l = pa._ragged_call(q, k, v, bt, cl, ks, vs, scale=scale,
                                   window=window, variant=variant,
                                   splits=splits, partials=True)
    tr, tk = pa.tile_shape(variant, dtype, C * nh // g, d, quantized)
    o0, m0, l0 = pa._reference_split_partials(
        q, k, v, bt, cl, ks, vs, scale, window, tile_rows=tr, tile_keys=tk,
        splits=splits)
    empty = m0 == float("-inf")
    assert empty.any() and not empty.all()
    assert torch.equal(m == float("-inf"), empty)
    assert (l[empty] == 0).all()
    live = ~empty
    torch.testing.assert_close(m[live], m0[live], rtol=0, atol=1e-4)
    torch.testing.assert_close(l[live], l0[live], rtol=1e-4, atol=0)
    torch.testing.assert_close((o / l[..., None])[live],
                               (o0 / l0[..., None])[live], rtol=0,
                               atol=TOL[dtype])
    torch.testing.assert_close(pa._reference_merge(o, m, l, dtype).float(),
                               out.float(), rtol=0, atol=TOL[dtype])


def test_paged_variant_launches_follow_the_plan(cuda):
    for C, nh, g, dtype, want in [(1, 32, 32, torch.bfloat16, "simt"),
                                  (1, 71, 1, torch.bfloat16, "mma"),
                                  (64, 32, 32, torch.bfloat16, "mma"),
                                  (64, 32, 32, torch.float32, "simt")]:
        q, k, v, bt, cl, _, _ = _paged_inputs(cuda, 2, C, nh, g, 64, False,
                                              dtype, 3)
        before = dict(pa.variant_launches)
        if C == 1:
            pa.paged_attention_decode(q[:, 0].contiguous(), k, v, bt, cl)
        else:
            pa.paged_attention_prefill(q, k, v, bt, cl)
        moved = {key: n - before.get(key, 0)
                 for key, n in pa.variant_launches.items()
                 if n != before.get(key, 0)}
        assert moved == {want: 1}, (C, nh, g, dtype, moved)
        assert pa.kernel_variant(dtype, C * nh // g, 64, False) == want


def test_paged_tensor_cores_refuse_fp32(cuda):
    q, k, v, bt, cl, _, _ = _paged_inputs(cuda, 2, 16, 8, 2, 64, False,
                                          torch.float32, 3)
    with pytest.raises(TypeError):
        pa._ragged_call(q, k, v, bt, cl, None, None, scale=0.125,
                        window=None, variant="mma")


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


def _plans(h, dtype):
    """Every (row_threads, vecs) D can take for rows of h, each with one
    row a block and with several."""
    nvec = h // (16 // torch.empty((), dtype=dtype).element_size())
    out = []
    for v in range(1, ln.MAX_VECS + 1):
        t = 32 * -(-nvec // (32 * v))
        if t <= ln.max_threads(v):
            out += [(t, v, 1), (t, v, max(1, 256 // t))]
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,h", [(8, 4544), (300, 4544), (37, 768),
                                 (64, 1600), (5, 128)])
def test_layernorm_every_plan_matches_plain(cuda, n, h, dtype):
    g = torch.Generator(device=cuda).manual_seed(n * h)
    # fp32 rows with a large mean: the two-pass variance keeps 1e-5
    mean = 30.0 if dtype == torch.float32 else 2.0
    x = (torch.randn(n, h, device=cuda, generator=g) * 3 + mean).to(dtype)
    s = (torch.rand(h, device=cuda, generator=g) * 0.4 + 0.4).to(dtype)
    b = (torch.randn(h, device=cuda, generator=g) * 0.1).to(dtype)
    y0, mu0, rstd0 = ln.layer_norm_fwd_plain(x, s, b, 1e-5)
    tol = TOL[dtype] if dtype == torch.bfloat16 else 1e-5
    for t, v, rows in _plans(h, dtype):
        # a grid smaller than the rows: blocks walk several row groups
        for grid in (-(-n // rows), max(1, n // (3 * rows))):
            p = (t, v, rows, grid)
            before = dict(ln.plan_launches)
            y, mu, rstd = ln.layer_norm_fwd_kernel(x, s, b, 1e-5,
                                                   force_plan=p)
            assert ln.plan_launches[p] == before.get(p, 0) + 1
            torch.testing.assert_close(y.float(), y0.float(), rtol=0,
                                       atol=tol, msg=str(p))
            torch.testing.assert_close(mu, mu0, rtol=0, atol=1e-5)
            torch.testing.assert_close(rstd, rstd0, rtol=1e-5, atol=1e-6)
            again = ln.layer_norm_fwd_kernel(x, s, b, 1e-5, force_plan=p)
            assert torch.equal(again[0], y) and torch.equal(again[1], mu)


def _bwd_plans(h, dtype):
    """Every (row_threads, vecs) E can take for rows of h, each with one
    row a block and with as many as fit its threads."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    nvec = h // vec
    out = []
    for v in range(1, ln.MAX_VECS + 1):
        t = 32 * -(-nvec // (32 * v))
        limit, _ = norm_plan.bwd_shape(v, vec)
        if t <= limit:
            out += sorted({(t, v, 1), (t, v, max(1, min(512, limit) // t))})
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,h", [(300, 4544), (37, 768), (64, 1600),
                                 (5, 128), (2048, 4544)])
def test_layernorm_bwd_every_plan_matches_plain(cuda, n, h, dtype):
    g = torch.Generator(device=cuda).manual_seed(11 * n + h)
    x = (torch.randn(n, h, device=cuda, generator=g) * 3 + 1).to(dtype)
    s = (torch.rand(h, device=cuda, generator=g) + 0.5).to(dtype)
    gy = torch.randn(n, h, device=cuda, generator=g).to(dtype)
    _, mu, rstd = ln.layer_norm_fwd_plain(x, s, torch.zeros_like(s), 1e-5)
    dx0, dg0, db0 = ln.layer_norm_bwd_plain(x, s, gy, mu, rstd)
    tol = TOL[dtype]
    plans = _bwd_plans(h, dtype)
    if n == 2048:       # the training rows: E's own plan and a few more
        plans = [p[:3] for p in (ln.bwd_plan(n, h, dtype),)] + plans[::3]
    for t, v, rows in plans:
        for grid in sorted({min(-(-n // rows), 132), max(1, n // (7 * rows)),
                            -(-n // rows)}):
            p = (t, v, rows, grid)
            before = dict(ln.bwd_plan_launches)
            dx, dg, db, part = ln.layer_norm_bwd_kernel(
                x, s, gy, mu, rstd, force_plan=p, partials=True)
            assert ln.bwd_plan_launches[p] == before.get(p, 0) + 1
            torch.testing.assert_close(dx.float(), dx0.float(), rtol=0,
                                       atol=tol, msg=str(p))
            for got, want in ((dg, dg0), (db, db0)):
                size = want.abs().max().item() + 1.0
                assert (got - want).abs().max().item() <= tol * size, p
            # the partial rows and the column pass against their plain
            # walk (fp32: only the kernel's fused multiply-adds differ)
            ref_part, ref_sums = ln._reference_bwd_partials(x, s, gy, mu,
                                                            rstd, p)
            size = ref_part.abs().max().item() + 1.0
            assert (part - ref_part).abs().max().item() <= 1e-5 * size, p
            sums = torch.cat([dg, db])
            assert (sums - ref_sums).abs().max().item() <= 1e-5 * size, p
            # a fixed order: the same bits every run
            again = ln.layer_norm_bwd_kernel(x, s, gy, mu, rstd,
                                             force_plan=p)
            assert all(torch.equal(a, b) for a, b in zip(again, (dx, dg,
                                                                 db))), p


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
