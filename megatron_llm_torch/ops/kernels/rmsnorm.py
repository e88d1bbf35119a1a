"""Fused RMSNorm, forward and backward: the CUDA kernels B (the norm
forward of ``csrc/layernorm.cu``, which kernel D shares) and C
(``csrc/rmsnorm.cu``), and their plain PyTorch versions.

The counterpart of ``megatron_llm_tpu/ops/pallas/rmsnorm.py``: the forward
``_fwd_kernel`` through ``_fwd_call``, the backward ``_bwd_kernel`` through
``_bwd_call``, and ``fused_rms_norm`` with its ``jax.custom_vjp``, here a
``torch.autograd.Function`` whose forward saves rstd and whose backward
reuses it.  Where no gradient can be asked for (grad mode off, or no
input that requires one, as in serving) ``fused_rms_norm`` calls the
forward directly and keeps no rstd.  A CPU tensor takes the plain
versions; a CUDA tensor launches the kernels or raises.

B keeps each row in registers under ``norm_plan.plan`` (row_threads,
vecs, rows_per_block, grid), the plan of D.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from megatron_llm_torch.ops.kernels import build
from megatron_llm_torch.ops.kernels import norm_plan

# kernel launches since the last reset (plain counts; chip_smoke.py zeroes
# them before driving a path and reads them after).  One backward launch
# is one call of kernel C, which runs its two passes (dx with per-block
# dscale partials, then the column sum).  ``plan_launches`` counts B's
# launches by plan (row_threads, vecs, rows_per_block, grid).
launches = 0
bwd_launches = 0
plan_launches: dict = {}
# most row-blocks of the backward's first pass (each writes one row of
# partial dscale sums): about two per SM of an H100
_BWD_MAX_BLOCKS = 256


def rms_norm_fwd_plain(x2d: torch.Tensor, scale: torch.Tensor, eps: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y [n, h] in x's dtype, rstd [n, 1] fp32), computed in fp32."""
    xf = x2d.float()
    rstd = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    y = xf * rstd * scale.float()
    return y.to(x2d.dtype), rstd


def rms_norm_bwd_plain(x2d: torch.Tensor, scale: torch.Tensor,
                       g2d: torch.Tensor, rstd: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx [n, h] in x's dtype, dscale [h] fp32), computed in fp32 with
    the Pallas kernel's formulas:
    dx = rstd * (g*s - x * rstd^2 * mean(g*s*x)), dscale = sum g*x*rstd."""
    xf, gf = x2d.float(), g2d.float()
    gs = gf * scale.float()
    m = (gs * xf).sum(dim=-1, keepdim=True) / x2d.shape[-1]
    dx = rstd * (gs - xf * (rstd * rstd) * m)
    ds = (gf * xf * rstd).sum(dim=0)
    return dx.to(x2d.dtype), ds


def _check(x2d: torch.Tensor, scale: torch.Tensor) -> Tuple[int, int]:
    build.require_cuda(x2d, "x")
    build.require_cuda(scale, "scale")
    if x2d.dim() != 2 or scale.shape != (x2d.shape[1],):
        raise ValueError(f"rmsnorm takes x [n, h] and scale [h], got "
                         f"{tuple(x2d.shape)} and {tuple(scale.shape)}")
    if scale.device != x2d.device:
        raise ValueError("x and scale must be on the same device")
    x_code, s_code = build.dtype_code(x2d), build.dtype_code(scale)
    if x_code == build.DTYPE_CODES[torch.float32] and s_code != x_code:
        raise TypeError("a float32 x takes a float32 scale")
    if not (x2d.is_contiguous() and scale.is_contiguous()):
        raise ValueError(f"rmsnorm reads dense rows: x (strides "
                         f"{x2d.stride()}) and scale must be contiguous")
    h = x2d.shape[1]
    vec = 16 // x2d.element_size()
    if h % vec or x2d.data_ptr() % 16:
        raise ValueError(f"rmsnorm needs 16-byte aligned rows (h % {vec} "
                         f"== 0), got h = {h}")
    return x_code, s_code


def rms_norm_fwd_kernel(x: torch.Tensor, scale: torch.Tensor, eps: float,
                        rstd: bool = True,
                        force_plan: Optional[Tuple[int, int, int, int]]
                        = None
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch kernel B on the rows of x [..., h] (n = x.numel() / h);
    returns (y in x's shape, rstd [n, 1] fp32, or None with
    ``rstd=False``).  ``force_plan`` (row_threads, vecs, rows_per_block,
    grid) replaces ``norm_plan.plan``'s (tests and sweeps).  Every check
    runs in one pass; a call that fails one is refused with the reason."""
    global launches
    codes = norm_plan.CODES.get((x.dtype, scale.dtype))
    dev = x.get_device()
    if (codes is None or dev < 0 or scale.dim() != 1 or x.dim() < 1
            or scale.get_device() != dev
            or not (x.is_contiguous() and scale.is_contiguous())):
        norm_plan.refuse("rmsnorm", x, scale)
    h = scale.shape[0]
    xp, sp = x.data_ptr(), scale.data_ptr()
    if x.shape[-1] != h or h % (16 // x.element_size()) or (xp | sp) % 16:
        norm_plan.refuse("rmsnorm", x, scale)
    n = x.numel() // h if h else 0
    y = torch.empty_like(x)
    r = x.new_empty((n, 1), dtype=torch.float32) if rstd else None
    if n == 0:
        return y, r
    p = force_plan or norm_plan.plan(n, h, x.dtype, build.sm_count(dev))
    rc = norm_plan.entry("mlt_norm_fwd")(norm_plan.FWD_CALL.pack(
        xp, sp, 0, y.data_ptr(), 0, 0 if r is None else r.data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev), n, h, codes[0], codes[1],
        p[0], p[1], p[2], p[3], 1, eps))
    if rc:
        build.check_rc(rc, "rmsnorm")
    launches += 1
    plan_launches[p] = plan_launches.get(p, 0) + 1
    return y, r


def rms_norm_bwd_kernel(x2d: torch.Tensor, scale: torch.Tensor,
                        g2d: torch.Tensor, rstd: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel C; returns (dx [n, h] in x's dtype, dscale [h] fp32).
    ``rstd`` is the forward's, [n, 1] fp32."""
    global bwd_launches
    x_code, s_code = _check(x2d, scale)
    build.require_cuda(g2d, "g")
    build.require_cuda(rstd, "rstd")
    n, h = x2d.shape
    if g2d.shape != x2d.shape or g2d.dtype != x2d.dtype:
        raise ValueError(f"g must match x ({tuple(x2d.shape)}, "
                         f"{x2d.dtype}), got {tuple(g2d.shape)}, "
                         f"{g2d.dtype}")
    if (rstd.dtype != torch.float32 or rstd.numel() != n
            or not rstd.is_contiguous()):
        raise ValueError("rstd must be the forward's [n, 1] fp32")
    if not g2d.is_contiguous() or g2d.data_ptr() % 16:
        raise ValueError("g must be contiguous and 16-byte aligned")
    dx = torch.empty_like(x2d)
    dscale = torch.zeros(h, dtype=torch.float32, device=x2d.device)
    if n == 0:
        return dx, dscale
    rows = -(-n // min(n, _BWD_MAX_BLOCKS))
    nblocks = -(-n // rows)
    partial = torch.empty((nblocks, h), dtype=torch.float32,
                          device=x2d.device)
    lib = build.load_library()
    rc = lib.mlt_rmsnorm_bwd(x2d.data_ptr(), scale.data_ptr(),
                             g2d.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
                             partial.data_ptr(), dscale.data_ptr(), n, h,
                             rows, nblocks, x_code, s_code,
                             build.stream_handle(x2d))
    build.check_rc(rc, "rmsnorm backward")
    bwd_launches += 1
    return dx, dscale


def rms_norm_fwd(x2d: torch.Tensor, scale: torch.Tensor, eps: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version for a CPU tensor, kernel B for a CUDA one."""
    if x2d.device.type == "cpu":
        return rms_norm_fwd_plain(x2d, scale, eps)
    return rms_norm_fwd_kernel(x2d, scale, eps)


def rms_norm_bwd(x2d: torch.Tensor, scale: torch.Tensor, g2d: torch.Tensor,
                 rstd: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain backward for a CPU tensor, kernel C for a CUDA one."""
    if x2d.device.type == "cpu":
        return rms_norm_bwd_plain(x2d, scale, g2d, rstd)
    return rms_norm_bwd_kernel(x2d, scale, g2d, rstd)


class _FusedRMSNorm(torch.autograd.Function):
    """Forward: kernel B, saving rstd.  Backward: kernel C with that rstd
    (the ``_vjp_fwd`` / ``_vjp_bwd`` pair of the JAX package)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        shape = x.shape
        # the kernels read dense rows: a strided view (x = wide[..., :h])
        # is copied once here and the copy is what backward reads
        x2d = x.reshape(-1, shape[-1]).contiguous()
        scale = scale.contiguous()
        y, rstd = rms_norm_fwd(x2d, scale, eps)
        ctx.save_for_backward(x2d, scale, rstd)
        return y.reshape(shape)

    @staticmethod
    def backward(ctx, gy):
        x2d, scale, rstd = ctx.saved_tensors
        g2d = gy.reshape(x2d.shape).to(x2d.dtype).contiguous()
        dx, ds = rms_norm_bwd(x2d, scale, g2d, rstd)
        return dx.reshape(gy.shape), ds.to(scale.dtype), None


def fused_rms_norm(x: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis of any-rank ``x``, differentiable in
    ``x`` and ``scale``.  Where no gradient can be asked for, the forward
    runs without the autograd function and keeps no rstd: the same y."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _FusedRMSNorm.apply(x, scale, eps)
    if x.is_cpu:
        h = x.shape[-1]
        return rms_norm_fwd_plain(x.reshape(-1, h), scale, eps)[0].reshape(
            x.shape)
    return rms_norm_fwd_kernel(x.contiguous(), scale.contiguous(), eps,
                               rstd=False)[0]
