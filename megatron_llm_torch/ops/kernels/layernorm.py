"""Fused LayerNorm, forward and backward: the CUDA kernels
``csrc/layernorm.cu`` (D and E) and their plain PyTorch versions.

The counterpart of ``megatron_llm_tpu/ops/pallas/layernorm.py``: the forward
``_fwd_kernel`` through ``_fwd_call``, the backward ``_bwd_kernel`` through
``_bwd_call``, and ``fused_layer_norm`` with its ``jax.custom_vjp``, here a
``torch.autograd.Function`` whose forward saves mu and rstd and whose
backward reuses them.  A CPU tensor takes the plain versions; a CUDA
tensor launches the kernels or raises.

D keeps each row in registers, split over ``row_threads`` threads of
``vecs`` 16-byte vectors each; ``plan(n, h, dtype, sm_count)`` picks
(row_threads, vecs, rows_per_block, grid) for a call, and the kernel
takes the plan as given.
"""

from __future__ import annotations

import functools
import struct
from typing import Optional, Tuple

import torch

from megatron_llm_torch.ops.kernels import build

# kernel launches since the last reset (plain counts; chip_smoke.py zeroes
# them before driving a path and reads them after).  One backward launch
# is one call of kernel E, which runs its two passes (dx with per-block
# dgamma/dbeta partials, then the column sum).  ``plan_launches`` counts
# D's launches by plan (row_threads, vecs, rows_per_block, grid).
launches = 0
bwd_launches = 0
plan_launches: dict = {}
# most row-blocks of the backward's first pass (each writes one row of
# partial dgamma and dbeta sums): about two per SM of an H100
_BWD_MAX_BLOCKS = 256


# D's limits: 16-byte vectors a thread, threads a block
MAX_VECS = 8
MAX_THREADS = 1024


def max_threads(vecs: int) -> int:
    """Most threads a block of D takes at ``vecs`` vectors a thread (the
    kernel's launch bounds: beyond 4 vectors a thread needs more than the
    64 registers a 1024-thread block leaves)."""
    return MAX_THREADS if vecs <= 4 else MAX_THREADS // 2


# threads a row that decode rows (at most one a block) and training rows
# aim for; threads a training-rows block (rows side by side); blocks an SM
# of a training-rows grid (a block then walks further rows, keeping gamma
# and beta).  The values that timed best at Falcon-7B's 4544 columns on
# the H100 (chip_smoke.py --measure --sweep; PERF.md, PR 6).
_DECODE_ROW_THREADS = 256
_TRAIN_ROW_THREADS = 128
_TRAIN_BLOCK_THREADS = 512
_TRAIN_BLOCKS_PER_SM = 2


@functools.lru_cache(maxsize=1024)
def plan(n: int, h: int, dtype: torch.dtype, sm_count: int = 132
         ) -> Tuple[int, int, int, int]:
    """(row_threads, vecs, rows_per_block, grid) of kernel D on [n, h]
    rows of ``dtype``: a row's h / (16 / itemsize) vectors are spread over
    row_threads threads (a multiple of 32) of vecs vectors each, vector v
    on thread v % row_threads.  Of the pairs that cover the row, decode
    rows (n at most the SM count) take the one whose row_threads is
    nearest 256, one row a block; training rows the one nearest 128 (four
    warps a row), several rows to a block of about 512 threads, two
    blocks an SM.  Ties go to fewer idle vectors."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    if h % vec:
        raise ValueError(f"layernorm needs h % {vec} == 0, got h = {h}")
    nvec = h // vec
    cands = []
    for v in range(1, MAX_VECS + 1):
        t = 32 * -(-nvec // (32 * v))
        if t <= max_threads(v):
            cands.append((t, v))
    if not cands:
        raise ValueError(f"layernorm rows of {h} {dtype} exceed one block's "
                         f"{MAX_THREADS} threads x {MAX_VECS} vectors")
    decode = n <= sm_count
    target = _DECODE_ROW_THREADS if decode else _TRAIN_ROW_THREADS
    t, v = min(cands, key=lambda c: (abs(c[0] - target), c[0] * c[1]))
    if decode:
        return t, v, 1, max(n, 1)
    rows = max(1, min(_TRAIN_BLOCK_THREADS, max_threads(v)) // t)
    return t, v, rows, min(-(-n // rows), _TRAIN_BLOCKS_PER_SM * sm_count)


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


def _check(x2d: torch.Tensor, scale: torch.Tensor) -> Tuple[int, int]:
    build.require_cuda(x2d, "x")
    build.require_cuda(scale, "scale")
    if x2d.dim() != 2 or scale.shape != (x2d.shape[1],):
        raise ValueError(f"layernorm takes x [n, h] and scale [h], got "
                         f"{tuple(x2d.shape)} and {tuple(scale.shape)}")
    if scale.device != x2d.device:
        raise ValueError("x and scale must be on the same device")
    x_code, p_code = build.dtype_code(x2d), build.dtype_code(scale)
    if x_code == build.DTYPE_CODES[torch.float32] and p_code != x_code:
        raise TypeError("a float32 x takes float32 scale and bias")
    h = x2d.shape[1]
    vec = 16 // x2d.element_size()
    if h % vec or x2d.data_ptr() % 16:
        raise ValueError(f"layernorm needs 16-byte aligned rows (h % {vec} "
                         f"== 0), got h = {h}")
    return x_code, p_code


def _check_stat(t: torch.Tensor, n: int, name: str) -> None:
    build.require_cuda(t, name)
    if t.dtype != torch.float32 or t.numel() != n:
        raise ValueError(f"{name} must be the forward's [n, 1] fp32")


# D's C entry takes one packed LnFwdCall (csrc/layernorm.cu): the seven
# pointers x, gamma, beta, y, mu, rstd and the stream; n, h, the two dtype
# codes and the plan (row_threads, vecs, rows_per_block, grid); eps
_FWD_CALL = struct.Struct("=7Q8if")
# (x dtype, parameter dtype) -> their codes, for the pairs D takes
_FWD_CODES = {(x, p): (build.DTYPE_CODES[x], build.DTYPE_CODES[p])
              for x, p in ((torch.bfloat16, torch.bfloat16),
                           (torch.bfloat16, torch.float32),
                           (torch.float32, torch.float32))}
_fwd_entry = None


def _fwd_fn():
    """The library's forward entry, looked up once (no lock a call)."""
    global _fwd_entry
    if _fwd_entry is None:
        _fwd_entry = build.load_library().mlt_layernorm_fwd
    return _fwd_entry


def layer_norm_fwd_kernel(x2d: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, eps: float,
                          force_plan: Optional[Tuple[int, int, int, int]]
                          = None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch kernel D on [n, h] rows; returns (y, mu [n, 1], rstd [n, 1]),
    mu and rstd the two rows of one [2, n, 1] fp32 tensor.
    ``force_plan`` (row_threads, vecs, rows_per_block, grid) replaces
    ``plan``'s (tests and sweeps).  Every check runs in one pass; a call
    that fails one is refused by ``_refuse_fwd`` with the reason."""
    global launches
    codes = _FWD_CODES.get((x2d.dtype, scale.dtype))
    dev = x2d.get_device()
    if (codes is None or dev < 0 or x2d.dim() != 2 or scale.dim() != 1
            or scale.get_device() != dev or bias.get_device() != dev
            or bias.dtype != scale.dtype or bias.shape != scale.shape
            or not (x2d.is_contiguous() and scale.is_contiguous()
                    and bias.is_contiguous())):
        _refuse_fwd(x2d, scale, bias)
    n, h = x2d.shape
    xp, sp, bp = x2d.data_ptr(), scale.data_ptr(), bias.data_ptr()
    if (scale.shape[0] != h or h % (16 // x2d.element_size())
            or (xp | sp | bp) % 16):
        _refuse_fwd(x2d, scale, bias)
    # mu and rstd: the two rows of one allocation (new_empty: less host
    # work than torch.empty with a device argument)
    y = torch.empty_like(x2d)
    stats = x2d.new_empty((2, n, 1), dtype=torch.float32)
    mu, rstd = stats[0], stats[1]
    if n == 0:
        return y, mu, rstd
    p = force_plan or plan(n, h, x2d.dtype, build.sm_count(x2d.device))
    sptr = stats.data_ptr()
    rc = _fwd_fn()(_FWD_CALL.pack(
        xp, sp, bp, y.data_ptr(), sptr, sptr + 4 * n,
        torch._C._cuda_getCurrentRawStream(dev), n, h, codes[0], codes[1],
        p[0], p[1], p[2], p[3], eps))
    if rc:
        build.check_rc(rc, "layernorm")
    launches += 1
    plan_launches[p] = plan_launches.get(p, 0) + 1
    return y, mu, rstd


def _refuse_fwd(x2d, scale, bias) -> None:
    """Raise the error that says why D does not take these inputs."""
    _check(x2d, scale)
    build.require_cuda(bias, "bias")
    if (bias.shape != scale.shape or bias.dtype != scale.dtype
            or bias.device != scale.device):
        raise ValueError(f"bias must match scale ({tuple(scale.shape)}, "
                         f"{scale.dtype}), got {tuple(bias.shape)}, "
                         f"{bias.dtype}")
    if (scale.data_ptr() | bias.data_ptr()) % 16:
        raise ValueError("layernorm needs 16-byte aligned scale and bias")
    raise ValueError("layernorm: inputs not taken")


def layer_norm_bwd_kernel(x2d: torch.Tensor, scale: torch.Tensor,
                          g2d: torch.Tensor, mu: torch.Tensor,
                          rstd: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch kernel E; returns (dx [n, h] in x's dtype, dgamma [h] fp32,
    dbeta [h] fp32).  ``mu`` and ``rstd`` are the forward's, [n, 1] fp32."""
    global bwd_launches
    x_code, p_code = _check(x2d, scale)
    build.require_cuda(g2d, "g")
    n, h = x2d.shape
    if g2d.shape != x2d.shape or g2d.dtype != x2d.dtype:
        raise ValueError(f"g must match x ({tuple(x2d.shape)}, "
                         f"{x2d.dtype}), got {tuple(g2d.shape)}, "
                         f"{g2d.dtype}")
    if g2d.data_ptr() % 16:
        raise ValueError("g must be 16-byte aligned")
    _check_stat(mu, n, "mu")
    _check_stat(rstd, n, "rstd")
    dx = torch.empty_like(x2d)
    sums = torch.zeros(2 * h, dtype=torch.float32, device=x2d.device)
    if n == 0:
        return dx, sums[:h], sums[h:]
    rows = -(-n // min(n, _BWD_MAX_BLOCKS))
    nblocks = -(-n // rows)
    partial = torch.empty((nblocks, 2 * h), dtype=torch.float32,
                          device=x2d.device)
    lib = build.load_library()
    rc = lib.mlt_layernorm_bwd(x2d.data_ptr(), scale.data_ptr(),
                               g2d.data_ptr(), mu.data_ptr(),
                               rstd.data_ptr(), dx.data_ptr(),
                               partial.data_ptr(), sums.data_ptr(), n, h,
                               rows, nblocks, x_code, p_code,
                               build.stream_handle(x2d))
    build.check_rc(rc, "layernorm backward")
    bwd_launches += 1
    return dx, sums[:h], sums[h:]


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
    ``x``, ``scale`` and ``bias``."""
    return _FusedLayerNorm.apply(x, scale, bias, eps)
