"""Fused RMSNorm, forward and backward: the CUDA kernels B and C (the
norm forward and backward of ``csrc/layernorm.cu``, which kernels D and E
share), and their plain PyTorch versions.

The counterpart of ``megatron_llm_tpu/ops/pallas/rmsnorm.py``: the forward
``_fwd_kernel`` through ``_fwd_call``, the backward ``_bwd_kernel`` through
``_bwd_call``, and ``fused_rms_norm`` with its ``jax.custom_vjp``, here a
``torch.autograd.Function`` whose forward saves rstd and whose backward
reuses it.  Where no gradient can be asked for (grad mode off, or no
input that requires one, as in serving) ``fused_rms_norm`` calls the
forward directly and keeps no rstd.  A CPU tensor takes the plain
versions; a CUDA tensor launches the kernels or raises.

B keeps each row in registers under ``norm_plan.plan`` (row_threads,
vecs, rows_per_block, grid), the plan of D.  C holds x and g of a row the
same way and its dscale sums in registers under ``norm_plan.bwd_plan(...,
rms=True)``; each block writes one partial row, which the column pass adds
in a fixed order (``_reference_bwd_partials`` is that walk's plain
version).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from megatron_llm_torch.ops.kernels import build
from megatron_llm_torch.ops.kernels import norm_plan

# kernel launches since the last reset (plain counts; chip_smoke.py zeroes
# them before driving a path and reads them after).  One backward launch
# is one call of kernel C, which runs its two passes (dx with per-block
# dscale partials, then the column pass).  ``plan_launches`` and
# ``bwd_plan_launches`` count B's and C's launches by plan (row_threads,
# vecs, rows_per_block, grid).
launches = 0
bwd_launches = 0
plan_launches: dict = {}
bwd_plan_launches: dict = {}


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


def rms_norm_fwd_kernel(x: torch.Tensor, scale: torch.Tensor, eps: float,
                        rstd: bool = True,
                        force_plan: Optional[Tuple[int, int, int, int]]
                        = None
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch kernel B on the rows of x [..., h] (n = x.numel() / h);
    returns (y in x's shape, rstd [n, 1] fp32, or None with
    ``rstd=False``).  ``force_plan`` (row_threads, vecs, rows_per_block,
    grid) replaces ``norm_plan.plan``'s (tests and sweeps).  Every check
    runs in one pass (``norm_plan.fwd_checks``); a call that fails one is
    refused with the reason."""
    global launches
    codes, dev, h, xp, sp, _ = norm_plan.fwd_checks("rmsnorm", x, scale,
                                                    None)
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
                        g2d: torch.Tensor, rstd: torch.Tensor,
                        force_plan: Optional[Tuple[int, int, int, int]]
                        = None, partials: bool = False):
    """Launch kernel C (``norm_plan.launch_bwd``); returns (dx [n, h] in
    x's dtype, dscale [h] fp32).  ``rstd`` is the forward's, [n, 1] fp32.
    ``force_plan`` (row_threads, vecs, rows_per_block, grid) replaces
    ``bwd_plan``'s; ``partials=True`` also returns the first pass's
    partial rows [grid, h] fp32 (tests).  A call that fails a check is
    refused with the reason."""
    global bwd_launches
    dx, ds, part, p = norm_plan.launch_bwd("rmsnorm backward", x2d, scale,
                                           g2d, None, rstd, force_plan)
    if p is not None:
        bwd_launches += 1
        bwd_plan_launches[p] = bwd_plan_launches.get(p, 0) + 1
    return (dx, ds, part) if partials else (dx, ds)


def _reference_bwd_partials(x2d: torch.Tensor, scale: torch.Tensor,
                            g2d: torch.Tensor, rstd: torch.Tensor,
                            p: Tuple[int, int, int, int]
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """C's walk over the rows and its column pass, in fp32 and in their
    orders (``norm_plan.bwd_walk``), under plan ``p``: (partial [grid, h],
    dscale [h]), each row adding g * x * rstd to its columns."""
    return norm_plan.bwd_walk(g2d.float() * x2d.float() * rstd, p)


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
