"""Fused LayerNorm, forward and backward: the CUDA kernels D and E (the
norm forward and backward of ``csrc/layernorm.cu``, which kernels B and C
share), and their plain PyTorch versions.

The counterpart of ``megatron_llm_tpu/ops/pallas/layernorm.py``: the forward
``_fwd_kernel`` through ``_fwd_call``, the backward ``_bwd_kernel`` through
``_bwd_call``, and ``fused_layer_norm`` with its ``jax.custom_vjp``, here a
``torch.autograd.Function`` whose forward saves mu and rstd and whose
backward reuses them.  Where no gradient can be asked for (grad mode off,
or no input that requires one, as in serving) ``fused_layer_norm`` calls
the forward directly and keeps no statistics.  A CPU tensor takes the
plain versions; a CUDA tensor launches the kernels or raises.

D keeps each row in registers, split over ``row_threads`` threads of
``vecs`` 16-byte vectors each; ``plan(n, h, dtype, sm_count)`` picks
(row_threads, vecs, rows_per_block, grid) for a call.  E holds x and g
of a row the same way and its dgamma and dbeta sums in registers under
``bwd_plan``; each block writes one partial row, which E's column pass
adds in a fixed order (``_reference_bwd_partials`` is that walk's plain
version).  The kernels take the plans as given (``ops/kernels/
norm_plan.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from megatron_llm_torch.ops.kernels import build
from megatron_llm_torch.ops.kernels import norm_plan
# D's plan and its limits live in norm_plan, shared with B
from megatron_llm_torch.ops.kernels.norm_plan import (  # noqa: F401
    MAX_VECS, bwd_plan, max_threads, plan)

# kernel launches since the last reset (plain counts; chip_smoke.py zeroes
# them before driving a path and reads them after).  One backward launch
# is one call of kernel E, which runs its two passes (dx with per-block
# dgamma/dbeta partials, then the column pass).  ``plan_launches`` and
# ``bwd_plan_launches`` count D's and E's launches by plan (row_threads,
# vecs, rows_per_block, grid).
launches = 0
bwd_launches = 0
plan_launches: dict = {}
bwd_plan_launches: dict = {}


def layer_norm_fwd_plain(x2d: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, eps: float
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y [n, h] in x's dtype, mu [n, 1] fp32, rstd [n, 1] fp32), computed
    in fp32; the variance is the mean of the squared deviations."""
    xf = x2d.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    rstd = torch.rsqrt(xc.square().mean(dim=-1, keepdim=True) + eps)
    y = xc * rstd * scale.float() + bias.float()
    return y.to(x2d.dtype), mu, rstd


def layer_norm_bwd_plain(x2d: torch.Tensor, scale: torch.Tensor,
                         g2d: torch.Tensor, mu: torch.Tensor,
                         rstd: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx [n, h] in x's dtype, dgamma [h] fp32, dbeta [h] fp32), computed
    in fp32 with the Pallas kernel's formulas:
    dx = rstd * (g*gamma - mean(g*gamma) - xhat * mean(g*gamma*xhat)),
    dgamma = sum g*xhat, dbeta = sum g."""
    xf, gf = x2d.float(), g2d.float()
    xhat = (xf - mu) * rstd
    ggam = gf * scale.float()
    m1 = ggam.mean(dim=-1, keepdim=True)
    m2 = (ggam * xhat).mean(dim=-1, keepdim=True)
    dx = rstd * (ggam - m1 - xhat * m2)
    return dx.to(x2d.dtype), (gf * xhat).sum(dim=0), gf.sum(dim=0)


def layer_norm_fwd_kernel(x: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, eps: float,
                          force_plan: Optional[Tuple[int, int, int, int]]
                          = None, stats: bool = True
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                     Optional[torch.Tensor]]:
    """Launch kernel D on the rows of x [..., h] (n = x.numel() / h);
    returns (y in x's shape, mu [n, 1], rstd [n, 1]), mu and rstd the two
    rows of one [2, n, 1] fp32 tensor, or both None with ``stats=False``.
    ``force_plan`` (row_threads, vecs, rows_per_block, grid) replaces
    ``plan``'s (tests and sweeps).  Every check runs in one pass
    (``norm_plan.fwd_checks``); a call that fails one is refused with the
    reason."""
    global launches
    codes, dev, h, xp, sp, bp = norm_plan.fwd_checks("layernorm", x, scale,
                                                     bias)
    n = x.numel() // h if h else 0
    # mu and rstd: the two rows of one allocation (new_empty: less host
    # work than torch.empty with a device argument)
    y = torch.empty_like(x)
    mu = rstd = None
    sptr = 0
    if stats:
        st = x.new_empty((2, n, 1), dtype=torch.float32)
        mu, rstd = st[0], st[1]
        sptr = st.data_ptr()
    if n == 0:
        return y, mu, rstd
    p = force_plan or plan(n, h, x.dtype, build.sm_count(dev))
    rc = norm_plan.entry("mlt_norm_fwd")(norm_plan.FWD_CALL.pack(
        xp, sp, bp, y.data_ptr(), sptr, sptr + 4 * n if stats else 0,
        torch._C._cuda_getCurrentRawStream(dev), n, h, codes[0], codes[1],
        p[0], p[1], p[2], p[3], 0, eps))
    if rc:
        build.check_rc(rc, "layernorm")
    launches += 1
    plan_launches[p] = plan_launches.get(p, 0) + 1
    return y, mu, rstd


def layer_norm_bwd_kernel(x2d: torch.Tensor, scale: torch.Tensor,
                          g2d: torch.Tensor, mu: torch.Tensor,
                          rstd: torch.Tensor,
                          force_plan: Optional[Tuple[int, int, int, int]]
                          = None, partials: bool = False):
    """Launch kernel E (``norm_plan.launch_bwd``); returns (dx [n, h] in
    x's dtype, dgamma [h] fp32, dbeta [h] fp32).  ``mu`` and ``rstd`` are
    the forward's, [n, 1] fp32.  ``force_plan`` (row_threads, vecs,
    rows_per_block, grid) replaces ``bwd_plan``'s; ``partials=True`` also
    returns the first pass's partial rows [grid, 2h] fp32 (tests).  A call
    that fails a check is refused with the reason."""
    global bwd_launches
    dx, sums, part, p = norm_plan.launch_bwd("layernorm backward", x2d,
                                             scale, g2d, mu, rstd,
                                             force_plan)
    if p is not None:
        bwd_launches += 1
        bwd_plan_launches[p] = bwd_plan_launches.get(p, 0) + 1
    h = x2d.shape[1]
    out = (dx, sums[:h], sums[h:])
    return out + (part,) if partials else out


def _reference_bwd_partials(x2d: torch.Tensor, scale: torch.Tensor,
                            g2d: torch.Tensor, mu: torch.Tensor,
                            rstd: torch.Tensor,
                            p: Tuple[int, int, int, int]
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """E's walk over the rows and its column pass, in fp32 and in their
    orders (``norm_plan.bwd_walk``), under plan ``p``: (partial [grid, 2h],
    sums [2h]), each row adding g * xhat and g to its columns."""
    xf, gf = x2d.float(), g2d.float()
    return norm_plan.bwd_walk(torch.cat([gf * ((xf - mu) * rstd), gf], dim=1),
                              p)


def layer_norm_fwd(x2d: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, eps: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version for a CPU tensor, kernel D for a CUDA one."""
    if x2d.device.type == "cpu":
        return layer_norm_fwd_plain(x2d, scale, bias, eps)
    return layer_norm_fwd_kernel(x2d, scale, bias, eps)


def layer_norm_bwd(x2d: torch.Tensor, scale: torch.Tensor,
                   g2d: torch.Tensor, mu: torch.Tensor, rstd: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward for a CPU tensor, kernel E for a CUDA one."""
    if x2d.device.type == "cpu":
        return layer_norm_bwd_plain(x2d, scale, g2d, mu, rstd)
    return layer_norm_bwd_kernel(x2d, scale, g2d, mu, rstd)


class _FusedLayerNorm(torch.autograd.Function):
    """Forward: kernel D, saving mu and rstd.  Backward: kernel E with
    them (the ``_vjp_fwd`` / ``_vjp_bwd`` pair of the JAX package)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        shape = x.shape
        # the kernels read dense rows: a strided view is copied once here
        # and the copy is what backward reads
        x2d = x.reshape(-1, shape[-1]).contiguous()
        scale = scale.contiguous()
        y, mu, rstd = layer_norm_fwd(x2d, scale, bias.contiguous(), eps)
        ctx.save_for_backward(x2d, scale, mu, rstd)
        ctx.bias_dtype = bias.dtype
        return y.reshape(shape)

    @staticmethod
    def backward(ctx, gy):
        x2d, scale, mu, rstd = ctx.saved_tensors
        # under the parallel residual the same output feeds attention and
        # the MLP, so gy may be a strided sum: made dense once
        g2d = gy.reshape(x2d.shape).to(x2d.dtype).contiguous()
        dx, dg, db = layer_norm_bwd(x2d, scale, g2d, mu, rstd)
        return (dx.reshape(gy.shape), dg.to(scale.dtype),
                db.to(ctx.bias_dtype), None)


def fused_layer_norm(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis of any-rank ``x``, differentiable in
    ``x``, ``scale`` and ``bias``.  Where no gradient can be asked for,
    the forward runs without the autograd function and keeps no
    statistics: the same y."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _FusedLayerNorm.apply(x, scale, bias, eps)
    if x.is_cpu:
        h = x.shape[-1]
        return layer_norm_fwd_plain(x.reshape(-1, h), scale, bias,
                                    eps)[0].reshape(x.shape)
    return layer_norm_fwd_kernel(x.contiguous(), scale.contiguous(),
                                 bias.contiguous(), eps, stats=False)[0]
