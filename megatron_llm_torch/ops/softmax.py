"""Attention masks and the scale-mask-softmax of ``core_attention`` (the
counterpart of ``megatron_llm_tpu/ops/softmax.py``; True = masked)."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -10000.0  # the reference's mask fill value


def causal_mask(sq: int, sk: int, device=None) -> torch.Tensor:
    """[sq, sk] bool; the last sq rows of an sk-long history are causal."""
    i = torch.arange(sq, device=device)[:, None]
    j = torch.arange(sk, device=device)[None, :]
    return j > (i + (sk - sq))


def sliding_window_mask(sq: int, sk: int, window: int,
                        device=None) -> torch.Tensor:
    """Causal plus a sliding window of ``window`` keys."""
    i = torch.arange(sq, device=device)[:, None] + (sk - sq)
    j = torch.arange(sk, device=device)[None, :]
    return (j > i) | (j <= i - window)


def fused_scale_mask_softmax(scores: torch.Tensor,
                             mask: Optional[torch.Tensor],
                             scale: Optional[float] = None,
                             softmax_in_fp32: bool = True) -> torch.Tensor:
    """scores: [..., sq, sk]; mask: broadcastable bool (True = masked)."""
    dtype = scores.dtype
    if softmax_in_fp32:
        scores = scores.float()
    if scale is not None:
        scores = scores * scale
    if mask is not None:
        scores = scores.masked_fill(mask, NEG_INF)
    return torch.softmax(scores, dim=-1).to(dtype)
