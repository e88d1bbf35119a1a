"""Q-chunked exact attention: the unfused path at long sequences (the
counterpart of ``megatron_llm_tpu/ops/chunked_attention.py``).

Flash-eligible attention (the causal or sliding-window mask and no
attention dropout) that does not take flash attention (``--no_flash_attn``)
comes here at ``CHUNKED_ATTENTION_MIN_SEQ`` query rows or more, as in the
JAX package.  Q is processed in row chunks: each chunk materialises only
[b, g, p, qc, sk] scores with a full softmax over the key axis, so the
chunking is exact, and each chunk runs under ``torch.utils.checkpoint``
so that the backward re-derives its scores instead of keeping the whole
[b, heads, s, s] score tensor (the JAX package's ``jax.checkpoint`` of
each chunk).  The scores are fp32 products of the compute-dtype
operands (``ops/matmul.bmm_f32``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from megatron_llm_torch.ops.matmul import bmm_f32

NEG_INF = -1e30
DEFAULT_Q_CHUNK = 1024
# below this many query rows the plain [s, s] path is one softmax over a
# score tensor of moderate size: no reason to chunk
CHUNKED_ATTENTION_MIN_SEQ = 4096


def _chunk(q_i: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q0: int,
           causal: bool, sliding_window: Optional[int],
           softmax_scale: float) -> torch.Tensor:
    """Attention of the query rows q0 .. q0 + qc - 1: q_i [b, qc, nh, d],
    k, v [b, sk, ng, d] -> [b, qc, nh, d] in q's dtype."""
    b, qc, nh, d = q_i.shape
    sk, ng = k.shape[1], k.shape[2]
    qpg = nh // ng
    # [b, qc, ng, qpg, d] -> [b*ng, qpg*qc, d] against [b*ng, d, sk]: the
    # GQA groups share their K/V without a broadcast
    qg = q_i.reshape(b, qc, ng, qpg, d).permute(0, 2, 3, 1, 4)
    qg = qg.reshape(b * ng, qpg * qc, d)
    kt = k.permute(0, 2, 3, 1).reshape(b * ng, d, sk)
    scores = bmm_f32(qg, kt).reshape(b, ng, qpg, qc, sk) * softmax_scale
    q_pos = q0 + torch.arange(qc, device=q_i.device)
    k_pos = torch.arange(sk, device=q_i.device)
    mask = torch.ones((qc, sk), dtype=torch.bool, device=q_i.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if sliding_window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - sliding_window
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    vg = v.permute(0, 2, 1, 3).reshape(b * ng, sk, d)
    ctx = bmm_f32(probs.reshape(b * ng, qpg * qc, sk), vg)
    ctx = ctx.reshape(b, ng, qpg, qc, d).permute(0, 3, 1, 2, 4)
    return ctx.reshape(b, qc, nh, d).to(q_i.dtype)


def chunked_causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sliding_window: Optional[int] = None,
    softmax_scale: Optional[float] = None,
    q_chunk_size: int = DEFAULT_Q_CHUNK,
) -> torch.Tensor:
    """q [b, sq, nh, d]; k, v [b, sk, ng, d] (GQA when ng < nh) -> ctx
    [b, sq, nh, d].  Exact (the unchunked softmax's numerics up to fp
    association); causal and sliding-window masks, no arbitrary mask and
    no dropout (the flash-eligibility conditions of ``attention``)."""
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(q.shape[-1])
    b, sq, nh, d = q.shape
    # pad sq up to a chunk multiple instead of hunting for a divisor; the
    # pad rows compute attention that is sliced off at the end
    qc = min(q_chunk_size, sq)
    n_qc = -(-sq // qc)
    pad = n_qc * qc - sq
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
    if n_qc == 1:
        out = _chunk(q, k, v, 0, causal, sliding_window, softmax_scale)
        return out[:, :sq] if pad else out
    outs = [checkpoint(_chunk, q[:, i * qc:(i + 1) * qc], k, v, i * qc,
                       causal, sliding_window, softmax_scale,
                       use_reentrant=False)
            for i in range(n_qc)]
    out = torch.cat(outs, dim=1)
    return out[:, :sq] if pad else out
