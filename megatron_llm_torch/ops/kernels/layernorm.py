"""Fused LayerNorm, forward and backward: the CUDA kernels D (the norm
forward of ``csrc/layernorm.cu``, which kernel B shares) and E, and their
plain PyTorch versions.

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
    ``plan``'s (tests and sweeps).  Every check runs in one pass; a call
    that fails one is refused with the reason."""
    global launches
    codes = norm_plan.CODES.get((x.dtype, scale.dtype))
    dev = x.get_device()
    if (codes is None or dev < 0 or x.dim() < 1 or scale.dim() != 1
            or scale.get_device() != dev or bias.get_device() != dev
            or bias.dtype != scale.dtype or bias.shape != scale.shape
            or not (x.is_contiguous() and scale.is_contiguous()
                    and bias.is_contiguous())):
        _refuse_fwd(x, scale, bias)
    h = scale.shape[0]
    xp, sp, bp = x.data_ptr(), scale.data_ptr(), bias.data_ptr()
    if (x.shape[-1] != h or h % (16 // x.element_size())
            or (xp | sp | bp) % 16):
        _refuse_fwd(x, scale, bias)
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


def _refuse_fwd(x, scale, bias) -> None:
    """Raise the error that says why D does not take these inputs."""
    norm_plan.refuse("layernorm", x, scale,
                     ("bias", bias, tuple(scale.shape), scale.dtype))


def layer_norm_bwd_kernel(x2d: torch.Tensor, scale: torch.Tensor,
                          g2d: torch.Tensor, mu: torch.Tensor,
                          rstd: torch.Tensor,
                          force_plan: Optional[Tuple[int, int, int, int]]
                          = None, partials: bool = False):
    """Launch kernel E; returns (dx [n, h] in x's dtype, dgamma [h] fp32,
    dbeta [h] fp32).  ``mu`` and ``rstd`` are the forward's, [n, 1] fp32.
    ``force_plan`` (row_threads, vecs, rows_per_block, grid) replaces
    ``bwd_plan``'s; ``partials=True`` also returns the first pass's
    partial rows [grid, 2h] fp32 (tests).  dgamma and dbeta are views of
    one fp32 allocation that also holds the partial rows: the column pass
    writes every column, so nothing is zeroed."""
    global bwd_launches
    codes = norm_plan.CODES.get((x2d.dtype, scale.dtype))
    dev = x2d.get_device()
    f32 = torch.float32
    if (codes is None or dev < 0 or x2d.dim() != 2 or scale.dim() != 1
            or g2d.dtype != x2d.dtype or g2d.shape != x2d.shape
            or mu.dtype != f32 or rstd.dtype != f32
            or any(t.get_device() != dev for t in (scale, g2d, mu, rstd))
            or not (x2d.is_contiguous() and scale.is_contiguous()
                    and g2d.is_contiguous() and mu.is_contiguous()
                    and rstd.is_contiguous())):
        _refuse_bwd(x2d, scale, g2d, mu, rstd)
    n, h = x2d.shape
    xp, sp, gp = x2d.data_ptr(), scale.data_ptr(), g2d.data_ptr()
    if (scale.shape[0] != h or h % (16 // x2d.element_size())
            or (xp | sp | gp) % 16 or mu.numel() != n or rstd.numel() != n):
        _refuse_bwd(x2d, scale, g2d, mu, rstd)
    dx = torch.empty_like(x2d)
    if n == 0:
        sums = x2d.new_zeros((2 * h,), dtype=f32)
        out = (dx, sums[:h], sums[h:])
        return out + (sums[:0].view(0, 2 * h),) if partials else out
    p = force_plan or bwd_plan(n, h, x2d.dtype, build.sm_count(dev))
    # the sums [2h] first, then the partial rows [grid, 2h]
    buf = x2d.new_empty(((p[3] + 1) * 2 * h,), dtype=f32)
    bptr = buf.data_ptr()
    rc = norm_plan.entry("mlt_layernorm_bwd")(norm_plan.BWD_CALL.pack(
        xp, sp, gp, mu.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
        bptr + 8 * h, bptr, torch._C._cuda_getCurrentRawStream(dev), n, h,
        codes[0], codes[1], p[0], p[1], p[2], p[3]))
    if rc:
        build.check_rc(rc, "layernorm backward")
    bwd_launches += 1
    bwd_plan_launches[p] = bwd_plan_launches.get(p, 0) + 1
    out = (dx, buf[:h], buf[h:2 * h])
    return out + (buf[2 * h:].view(p[3], 2 * h),) if partials else out


def _refuse_bwd(x2d, scale, g2d, mu, rstd) -> None:
    """Raise the error that says why E does not take these inputs."""
    if x2d.dim() != 2:
        raise ValueError(f"layernorm backward takes x [n, h], got "
                         f"{tuple(x2d.shape)}")
    norm_plan.refuse("layernorm backward", x2d, scale,
                     ("g", g2d, tuple(x2d.shape), x2d.dtype),
                     ("mu", mu, None, torch.float32),
                     ("rstd", rstd, None, torch.float32))


def _reference_bwd_partials(x2d: torch.Tensor, scale: torch.Tensor,
                            g2d: torch.Tensor, mu: torch.Tensor,
                            rstd: torch.Tensor,
                            p: Tuple[int, int, int, int]
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """E's walk over the rows and its column pass, in fp32 and in their
    orders, under plan ``p``: (partial [grid, 2h], sums [2h]).  Block b's
    slot s takes rows b * rows + s + k * grid * rows for k = 0, 1, ...,
    adding g * xhat and g to its columns row by row; a block adds its
    slots' sums in slot order into its partial row [dgamma | dbeta]; the
    column pass's warp w (of 8) adds partial rows w, w + 8, ... in order,
    then the warps' sums are added in warp order."""
    _, _, rows, grid = p
    n, h = x2d.shape
    dev = x2d.device
    xf, gf = x2d.float(), g2d.float()
    contrib = torch.cat([gf * ((xf - mu) * rstd), gf], dim=1)  # [n, 2h]
    stride = grid * rows
    trips = -(-n // stride)
    padded = torch.zeros(trips * stride, 2 * h, device=dev)
    padded[:n] = contrib
    acc = torch.zeros(grid, rows, 2 * h, device=dev)
    for k in range(trips):
        acc = acc + padded[k * stride:(k + 1) * stride].view(grid, rows,
                                                             2 * h)
    partial = acc[:, 0]
    for s in range(1, rows):
        partial = partial + acc[:, s]
    warps = []
    for w in range(8):
        part = torch.zeros(2 * h, device=dev)
        for r in range(w, grid, 8):
            part = part + partial[r]
        warps.append(part)
    sums = warps[0]
    for part in warps[1:]:
        sums = sums + part
    return partial, sums


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
