"""Symmetric absmax int8 quantisation (the counterpart of
``absmax_quantize_int8`` in ``megatron_llm_tpu/quantization.py``), used by
the int8 paged KV cache.  Weight-only int8 of the linear kernels is not
ported."""

from __future__ import annotations

from typing import Tuple

import torch


def absmax_quantize_int8(t: torch.Tensor, axis: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduce ``|t|`` over ``axis``: scale = max / 127 (1.0 where all zero),
    q = clip(round(t / scale), -127, 127), rounding half to even, all in
    fp32.  Returns (q int8 of t's shape, scale fp32 without ``axis``)."""
    t32 = t.float()
    absmax = t32.abs().amax(dim=axis)
    scale = torch.where(absmax > 0, absmax / 127.0,
                        torch.ones_like(absmax))
    q = torch.round(t32 / scale.unsqueeze(axis)).clamp(-127, 127)
    return q.to(torch.int8), scale
