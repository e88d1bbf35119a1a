"""LayerNorm, RMSNorm and the norm dispatch (the counterpart of
``megatron_llm_tpu/ops/layernorm.py``).

``apply_norm(..., use_kernel=True)`` routes RMSNorm through
``ops/kernels/rmsnorm.py`` and LayerNorm through
``ops/kernels/layernorm.py``: the CUDA kernel on a CUDA tensor, its plain
version on a CPU one.  The LayerNorm kernel always accumulates in fp32 and
adds a bias, so it stands in only for ``fp32_compute`` with a bias; any
other LayerNorm takes ``layer_norm`` below.
"""

from __future__ import annotations

from typing import Optional

import torch

from megatron_llm_torch.ops.kernels.layernorm import fused_layer_norm
from megatron_llm_torch.ops.kernels.rmsnorm import fused_rms_norm


def init_norm_params(hidden_size: int, normalization: str,
                     dtype=torch.float32, device=None):
    """RMSNorm: {'scale'}; LayerNorm: {'scale', 'bias'}."""
    if normalization == "rmsnorm":
        return {"scale": torch.ones((hidden_size,), dtype=dtype,
                                    device=device)}
    if normalization == "layernorm":
        return {"scale": torch.ones((hidden_size,), dtype=dtype,
                                    device=device),
                "bias": torch.zeros((hidden_size,), dtype=dtype,
                                    device=device)}
    raise ValueError(f"unknown normalization {normalization!r}")


def layer_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: Optional[torch.Tensor], eps: float = 1e-5,
               fp32_compute: bool = True) -> torch.Tensor:
    """LayerNorm over the last axis (in fp32 by default); the variance is
    the mean of the squared deviations from the mean."""
    dtype = x.dtype
    if fp32_compute:
        x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    y = y * scale.to(y.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y.to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
             fp32_compute: bool = True) -> torch.Tensor:
    """RMSNorm: compute (in fp32 by default), cast back, scale."""
    dtype = x.dtype
    if fp32_compute:
        x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * scale.to(y.dtype)).to(dtype)


def apply_norm(x: torch.Tensor, params, normalization: str,
               eps: float = 1e-5, fp32_compute: bool = True,
               use_kernel: bool = False) -> torch.Tensor:
    if normalization == "rmsnorm":
        if use_kernel:
            return fused_rms_norm(x, params["scale"], eps=eps)
        return rms_norm(x, params["scale"], eps=eps,
                        fp32_compute=fp32_compute)
    if normalization == "layernorm":
        bias = params.get("bias")
        if use_kernel and fp32_compute and bias is not None:
            return fused_layer_norm(x, params["scale"], bias, eps=eps)
        return layer_norm(x, params["scale"], bias, eps=eps,
                          fp32_compute=fp32_compute)
    raise ValueError(f"unknown normalization {normalization!r}")
