"""Fused RMSNorm forward: the CUDA kernel ``csrc/rmsnorm.cu`` and its
plain PyTorch version.

The counterpart of ``megatron_llm_tpu/ops/pallas/rmsnorm.py``'s forward
(``_fwd_kernel`` through ``_fwd_call``).  A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.  The backward
kernel is part of the training slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

from megatron_llm_torch.ops.kernels import build

# kernel launches since the last reset (a plain count; chip_smoke.py
# zeroes it before driving the serving path and reads it after)
launches = 0


def rms_norm_fwd_plain(x2d: torch.Tensor, scale: torch.Tensor, eps: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y [n, h] in x's dtype, rstd [n, 1] fp32), computed in fp32."""
    xf = x2d.float()
    rstd = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    y = xf * rstd * scale.float()
    return y.to(x2d.dtype), rstd


def rms_norm_fwd_kernel(x2d: torch.Tensor, scale: torch.Tensor, eps: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on [n, h] rows; returns (y, rstd [n, 1])."""
    global launches
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
    n, h = x2d.shape
    vec = 16 // x2d.element_size()
    if h % vec or x2d.data_ptr() % 16:
        raise ValueError(f"rmsnorm needs 16-byte aligned rows (h % {vec} "
                         f"== 0), got h = {h}")
    y = torch.empty_like(x2d)
    rstd = torch.empty((n, 1), dtype=torch.float32, device=x2d.device)
    if n == 0:
        return y, rstd
    lib = build.load_library()
    rc = lib.mlt_rmsnorm_fwd(x2d.data_ptr(), scale.data_ptr(), y.data_ptr(),
                             rstd.data_ptr(), n, h, float(eps), x_code,
                             s_code, build.stream_handle(x2d))
    build.check_rc(rc, "rmsnorm")
    launches += 1
    return y, rstd


def rms_norm_fwd(x2d: torch.Tensor, scale: torch.Tensor, eps: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version for a CPU tensor, the kernel for a CUDA one."""
    if x2d.device.type == "cpu":
        return rms_norm_fwd_plain(x2d, scale, eps)
    return rms_norm_fwd_kernel(x2d, scale, eps)


def fused_rms_norm(x: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis of any-rank ``x``."""
    shape = x.shape
    y, _ = rms_norm_fwd(x.reshape(-1, shape[-1]), scale, eps)
    return y.reshape(shape)
