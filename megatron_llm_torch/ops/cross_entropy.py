"""Cross entropy over the vocabulary (the tp=1 counterpart of
``megatron_llm_tpu/ops/cross_entropy.py``).

``vocab_parallel_cross_entropy`` is the JAX package's function at tensor
parallel size 1: the whole vocabulary lives on one device, so its
all-reduces are plain reductions, and autograd derives the
softmax-minus-one-hot backward.  ``fused_linear_cross_entropy`` (the
chunked LM head, off by default in the JAX package) is a later slice;
``GPTModel`` refuses ``fused_lm_cross_entropy``.
"""

from __future__ import annotations

import torch


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 label_smoothing: float = 0.0
                                 ) -> torch.Tensor:
    """Per-token loss [...] fp32 of logits [..., V] against int labels
    [...]; with ``label_smoothing`` the target is smoothed against the
    uniform distribution over the vocabulary."""
    logits = logits.float()
    logits_max = logits.max(dim=-1, keepdim=True).values.detach()
    shifted = logits - logits_max
    log_z = shifted.exp().sum(dim=-1).log()
    target = shifted.gather(-1, labels.long()[..., None])[..., 0]
    loss = log_z - target
    if label_smoothing > 0.0:
        vocab_size = logits.shape[-1]
        smoothing = label_smoothing * vocab_size / (vocab_size - 1)
        mean_log_probs = shifted.mean(dim=-1) - log_z
        loss = (1.0 - smoothing) * loss - smoothing * mean_log_probs
    return loss


def dense_cross_entropy(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """Per-example loss over a small unsharded class axis, fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[..., None])[..., 0]

