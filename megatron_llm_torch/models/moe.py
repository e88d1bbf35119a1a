"""Mixture-of-experts MLP (the counterpart of
``megatron_llm_tpu/models/moe.py``), on one device.

The same function as the JAX package's ``moe_mlp``, with its param tree
(``router.kernel [H, E]``, ``experts.w_in [E, H, (2x)F]``,
``experts.w_out [E, F, H]``) and its semantics:

* the router and its softmax in fp32; top-k experts a token, the lower
  expert index first on ties (``jax.lax.top_k``'s order), gates
  renormalised over the k;
* tokens routed within their batch row, each expert holding
  ``c = moe_capacity(cfg, s)`` slots a row; a slot's position is the
  count of earlier slots of the row that chose the same expert, over the
  flattened ``(s, k)`` slots, token-major, so earlier tokens win the
  buffer; slots at or past ``c`` are dropped (their MLP term is zero);
* the expert products in the compute dtype, the gates rounded to it
  before the combine;
* the aux ``[lb, z]`` in fp32: Switch's load balance
  ``E * sum_e(frac_e * mean_prob_e)``, with ``frac`` taken from the
  assignment before the drop, and the mean squared ``logsumexp`` of the
  router logits.

The JAX package dispatches and combines with one-hot einsums over a
``[b, s*k, E, c]`` mask, which GSPMD turns into all-to-alls over the
expert axis.  On one device the port moves rows by index instead: each
kept slot copies its token's row into its expert's buffer
(``index_copy``) and gathers its expert's output row back, so the mask
is never built.  That is the same function, since each (expert, row,
position) of the buffer holds at most one token and each slot reads one
row.  The k terms of a token's combine add up in fp32 and round once to
the compute dtype.  The expert products are ``torch.bmm`` over
``[E, b*c, h]``, as the JAX package leaves them to XLA.  Expert
parallelism (``expert_axis``, the sharding specs) is not ported:
``moe_expert_axis`` is parsed and has no effect on one device.
"""

from __future__ import annotations

import math

import torch

from megatron_llm_torch.config import TransformerConfig
from megatron_llm_torch.ops.activations import apply_mlp_activation
from megatron_llm_torch.parallel.layers import (
    init_method_for,
    scaled_init_method_normal,
)
from megatron_llm_torch.quantization import dequantize_weight


def moe_capacity(cfg: TransformerConfig, seq_len: int) -> int:
    """Slots a (batch row, expert): ``max(moe_min_capacity,
    ceil(s * top_k / E * moe_capacity_factor))``."""
    c = math.ceil(seq_len * cfg.moe_top_k / cfg.num_experts
                  * cfg.moe_capacity_factor)
    return max(cfg.moe_min_capacity, c)


def init_moe_mlp_params(generator, cfg: TransformerConfig, dtype,
                        device=None):
    """{'router': {'kernel': [H, E]},
        'experts': {'w_in': [E, H, (2x)F], 'w_out': [E, F, H]}}"""
    init = init_method_for(cfg)
    out_init = (scaled_init_method_normal(cfg.init_method_std,
                                          cfg.num_layers)
                if cfg.use_scaled_init_method else init)
    E, H, Fd = cfg.num_experts, cfg.hidden_size, cfg.ffn_hidden_size
    mult = 2 if cfg.glu_activation else 1
    return {
        "router": {"kernel": init(generator, (H, E), dtype, device)},
        "experts": {
            "w_in": init(generator, (E, H, mult * Fd), dtype, device),
            "w_out": out_init(generator, (E, Fd, H), dtype, device),
        },
    }


def route(x: torch.Tensor, router_kernel: torch.Tensor,
          cfg: TransformerConfig):
    """The router: (logits [b, s, E] fp32, probs [b, s, E] fp32, gates
    [b, s, k] fp32 renormalised, idx [b, s, k] int64).  Ties go to the
    lower expert index: a stable descending sort keeps equal
    probabilities in index order."""
    logits = torch.matmul(x.float(), router_kernel.float())
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe_top_k
    gates, idx = top[..., :k], idx[..., :k]
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return logits, probs, gates, idx


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int64 one-hot by comparison (``F.one_hot`` checks its range on
    the host, a sync per call on the card)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def slot_positions(idx: torch.Tensor, num_experts: int) -> torch.Tensor:
    """idx [b, s, k] -> each slot's position in its expert's buffer [b,
    s*k]: the count of earlier slots of the row (token-major over the
    flattened (s, k)) that chose the same expert."""
    b = idx.shape[0]
    ohf = _one_hot(idx.reshape(b, -1), num_experts)      # [b, s*k, E]
    before = ohf.cumsum(dim=1) - ohf
    return (before * ohf).sum(dim=-1)


def moe_mlp(x: torch.Tensor, params, cfg: TransformerConfig):
    """x [b, s, h] -> (out [b, s, h] in x's dtype, aux [2] fp32 = [load
    balance, z])."""
    E, k = cfg.num_experts, cfg.moe_top_k
    b, s, h = x.shape
    c = moe_capacity(cfg, s)
    cdt = cfg.compute_torch_dtype
    dev = x.device

    logits, probs, gates, idx = route(x, params["router"]["kernel"], cfg)
    pos = slot_positions(idx, E)                          # [b, s*k]
    keep = pos < c
    expert = idx.reshape(b, s * k)
    row = torch.arange(b, device=dev)[:, None]
    # the slot's row of the [E * b * c, h] buffers; a dropped slot writes
    # to one spare row past the end and reads a kept row with weight 0
    dest = (expert * b + row) * c + pos.clamp(max=c - 1)
    rows = E * b * c
    write = torch.where(keep, dest, rows).reshape(-1)
    token = (row * s + torch.arange(s * k, device=dev)[None, :] // k
             ).reshape(-1)

    # dispatch: each kept slot copies its token's row into its buffer
    xc = x.to(cdt).reshape(b * s, h)
    buf = xc.new_zeros(rows + 1, h).index_copy(0, write,
                                               xc.index_select(0, token))
    expert_in = buf[:rows].view(E, b * c, h)

    # int8 expert banks (``quantization.py``) dequantise on the operand
    w_in = dequantize_weight(params["experts"], "w_in", cdt)
    w_out = dequantize_weight(params["experts"], "w_out", cdt)
    mid = apply_mlp_activation(torch.bmm(expert_in, w_in), cfg)
    expert_out = torch.bmm(mid, w_out).view(rows, h)

    # combine: each slot reads its row back, weighted by its gate rounded
    # to the compute dtype (0 when dropped); the k terms add in fp32
    weight = torch.where(keep, gates.to(cdt).float().reshape(b, s * k),
                         0.0)
    got = expert_out.index_select(0, dest.reshape(-1)).float()
    out = (got.view(b, s, k, h) * weight.view(b, s, k, 1)).sum(dim=2)

    # aux: Switch load balance over the assignment before the drop, and
    # the router z-loss
    frac = _one_hot(idx.reshape(-1), E).sum(dim=0).float() / idx.numel()
    mean_prob = probs.reshape(-1, E).mean(dim=0)
    lb = E * (frac * mean_prob).sum()
    z = torch.logsumexp(logits, dim=-1)
    aux = torch.stack([lb, (z * z).mean()])
    return out.to(cdt).to(x.dtype), aux
