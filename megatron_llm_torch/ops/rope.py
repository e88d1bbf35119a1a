"""Rotary positional embeddings over interleaved feature pairs, with
position-interpolation and Llama-3.1 frequency scaling (the counterpart
of ``megatron_llm_tpu/ops/rope.py``; same (cos, sin) tables and the same
real-valued rotation)."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def llama3_scale_freqs(freqs: torch.Tensor, factor: float = 8.0,
                       low_freq_factor: float = 1.0,
                       high_freq_factor: float = 4.0,
                       original_max_position: int = 8192) -> torch.Tensor:
    """Llama-3.1 NTK-by-parts frequency remap."""
    wavelen = 2.0 * math.pi / freqs
    low_freq_wavelen = original_max_position / low_freq_factor
    high_freq_wavelen = original_max_position / high_freq_factor
    smooth = (original_max_position / wavelen - low_freq_factor) / (
        high_freq_factor - low_freq_factor)
    interp = (1.0 - smooth) * (freqs / factor) + smooth * freqs
    out = torch.where(wavelen > low_freq_wavelen, freqs / factor, freqs)
    in_band = (wavelen <= low_freq_wavelen) & (wavelen >= high_freq_wavelen)
    return torch.where(in_band, interp, out)


def precompute_freqs_cis(dim: int, end: int, theta: float = 10000.0,
                         scaling_factor: float = 1.0,
                         llama3_scaling: dict | None = None,
                         device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (cos, sin), each [end, dim // 2], fp32."""
    freqs = 1.0 / (theta ** (
        torch.arange(0, dim, 2, dtype=torch.float32,
                     device=device)[: dim // 2] / dim))
    if llama3_scaling:
        if scaling_factor != 1.0:
            raise ValueError(
                "rope llama3 scaling and linear scaling_factor "
                f"({scaling_factor}) are mutually exclusive")
        freqs = llama3_scale_freqs(freqs, **llama3_scaling)
    t = torch.arange(end, dtype=torch.float32, device=device) / scaling_factor
    freqs = torch.outer(t, freqs)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rotary_emb(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                     position_ids: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Rotate interleaved feature pairs of ``x`` [..., seq, heads, d];
    ``position_ids`` (optional) index the tables per batch row."""
    orig_dtype = x.dtype
    *lead, s, h, d = x.shape
    rot_d = 2 * cos.shape[-1]
    if rot_d < d:
        out_rot = apply_rotary_emb(x[..., :rot_d], cos, sin, position_ids)
        return torch.cat([out_rot, x[..., rot_d:]], dim=-1)
    if position_ids is None:
        c = cos[:s][:, None, :]
        sn = sin[:s][:, None, :]
    else:
        c = cos[position_ids][..., :, None, :]
        sn = sin[position_ids][..., :, None, :]
    xf = x.float().reshape(*lead, s, h, d // 2, 2)
    x_even = xf[..., 0]
    x_odd = xf[..., 1]
    out_even = x_even * c - x_odd * sn
    out_odd = x_even * sn + x_odd * c
    out = torch.stack([out_even, out_odd], dim=-1).reshape(*lead, s, h, d)
    return out.to(orig_dtype)
