"""MLP activations: the GLU family and the gelu variants (the
counterpart of ``megatron_llm_tpu/ops/activations.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Tanh-approximate gelu, with the reference's constants."""
    return 0.5 * x * (1.0 + torch.tanh(
        0.79788456 * x * (1.0 + 0.044715 * x * x)))


def _split2(x: torch.Tensor):
    return torch.chunk(x, 2, dim=-1)


def liglu(x: torch.Tensor) -> torch.Tensor:
    a, b = _split2(x)
    return a * b


def geglu(x: torch.Tensor) -> torch.Tensor:
    a, b = _split2(x)
    return gelu(a) * b


def reglu(x: torch.Tensor) -> torch.Tensor:
    a, b = _split2(x)
    return F.relu(a) * b


def swiglu(x: torch.Tensor) -> torch.Tensor:
    a, b = _split2(x)
    return F.silu(a) * b


GLU_ACTIVATIONS = {
    "liglu": liglu,
    "geglu": geglu,
    "reglu": reglu,
    "swiglu": swiglu,
}


def apply_mlp_activation(h: torch.Tensor, cfg) -> torch.Tensor:
    """The MLP nonlinearity selected by config: a GLU (halves the doubled
    first projection) or gelu ('exact' = erf, else tanh)."""
    if cfg.glu_activation:
        return GLU_ACTIVATIONS[cfg.glu_activation](h)
    if cfg.gelu_variant == "exact":
        return F.gelu(h, approximate="none")
    return gelu(h)
