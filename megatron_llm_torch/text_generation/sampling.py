"""Temperature / top-k / top-p sampling (the counterpart of
``megatron_llm_tpu/text_generation/sampling.py``): ``modify_logits`` and
``sample`` with one set of knobs for the whole batch (the legacy generate
path), ``modify_logits_batched`` and ``sample_batched`` with knobs per row
(the serving engine).

Draws come from ``torch.Generator``s: the legacy path's one generator is
seeded by the request's ``random_seed``, and each sampled row of the
engine draws with its own (one per request, seeded from its
``SamplingParams.seed``), so a request's sample stream does not depend on
its batch-mates.  The generators give other numbers than the JAX
package's PRNG keys; greedy rows are an exact argmax in both.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

NEG_INF = -1e10


def modify_logits(logits: torch.Tensor, top_k: int = 0, top_p: float = 0.0,
                  temperature: float = 1.0) -> torch.Tensor:
    """logits [..., V] -> fp32 logits scaled by ``temperature``, then with
    everything below the k-th largest (``top_k`` > 0) and outside the
    smallest set whose mass reaches ``top_p`` (0 < top_p < 1; the top-1
    always stays) set to ``NEG_INF``."""
    logits = logits.float()
    if temperature != 1.0 and temperature > 0:
        logits = logits / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, NEG_INF),
                             logits)
    if 0.0 < top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        cutoff_idx = ((cum - probs) < top_p).sum(dim=-1, keepdim=True) - 1
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx.clamp(min=0))
        logits = torch.where(logits < cutoff,
                             torch.full_like(logits, NEG_INF), logits)
    return logits


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           top_k: int = 0, top_p: float = 0.0, temperature: float = 1.0,
           greedy: bool = False) -> torch.Tensor:
    """Token ids [...] from logits [..., V]: the argmax when ``greedy``,
    ``top_k`` 1 or ``temperature`` 0, else one draw a row from the
    filtered distribution with ``generator``."""
    if greedy or top_k == 1 or temperature == 0.0:
        return torch.argmax(logits.float(), dim=-1)
    probs = torch.softmax(modify_logits(logits, top_k, top_p, temperature),
                          dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    drawn = torch.multinomial(flat, 1, generator=generator)
    return drawn.reshape(probs.shape[:-1])


def modify_logits_batched(logits: torch.Tensor, top_k: torch.Tensor,
                          top_p: torch.Tensor,
                          temperature: torch.Tensor) -> torch.Tensor:
    """logits [S, V] with per-row knobs: temperature scale, then top-k,
    then top-p over what survived top-k (0 = off for both)."""
    logits = logits.float()
    V = logits.shape[-1]
    t = temperature[:, None]
    logits = torch.where(t > 0.0, logits / torch.clamp(t, min=1e-6), logits)
    sorted_l = torch.sort(logits, dim=-1, descending=True).values
    kth = torch.gather(sorted_l, 1,
                       torch.clamp(top_k.long() - 1, 0, V - 1)[:, None])
    k_active = (top_k > 0) & (top_k < V)
    logits = torch.where(k_active[:, None] & (logits < kth),
                         torch.full_like(logits, NEG_INF), logits)
    sorted_p = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_p, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    cutoff_idx = ((cum - probs) < top_p[:, None]).sum(
        dim=-1, keepdim=True) - 1
    cutoff = torch.gather(sorted_p, 1, torch.clamp(cutoff_idx, min=0))
    p_active = (top_p > 0.0) & (top_p < 1.0)
    return torch.where(p_active[:, None] & (logits < cutoff),
                       torch.full_like(logits, NEG_INF), logits)


def sample_batched(logits: torch.Tensor,
                   generators: Sequence[Optional[torch.Generator]],
                   top_k: torch.Tensor, top_p: torch.Tensor,
                   temperature: torch.Tensor) -> torch.Tensor:
    """Row-wise sampling of logits [S, V] -> int64 [S].  Greedy rows
    (temperature 0 or top_k 1) take the argmax; every other row draws
    from its filtered distribution with ``generators[row]``."""
    greedy = (temperature <= 0.0) | (top_k == 1)
    out = torch.argmax(logits.float(), dim=-1)
    sampled = [i for i, g in enumerate(greedy.tolist()) if not g]
    if not sampled:
        return out
    rows = torch.tensor(sampled, device=logits.device)
    filtered = modify_logits_batched(logits[rows], top_k[rows], top_p[rows],
                                     temperature[rows])
    probs = torch.softmax(filtered, dim=-1)
    for n, i in enumerate(sampled):
        gen = generators[i]
        if gen is None:
            raise ValueError(f"row {i} samples but has no generator")
        out[i] = torch.multinomial(probs[n], 1, generator=gen)[0]
    return out
