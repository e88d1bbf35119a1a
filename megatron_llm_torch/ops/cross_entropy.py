"""Cross entropy over the vocabulary (the counterpart of
``megatron_llm_tpu/ops/cross_entropy.py``).

``vocab_parallel_cross_entropy`` takes the logits of the whole
vocabulary at tp 1, where its all-reduces are plain reductions and
autograd derives the softmax-minus-one-hot backward.  At tp > 1 the
logits are this rank's vocabulary shard, and it is
``shard_vocab_parallel_cross_entropy``: the reference's hand-written
function (``_VocabParallelCrossEntropy``), an all-reduce(MAX) of the
shards' maxima, the target logit picked on its owning rank and summed,
the shards' sum-exp summed, label smoothing over the whole vocabulary,
and the backward written out on the local shard.
``shard_vocab_parallel_max_indices`` is the argmax across shards (ties
to the lowest id).  ``fused_linear_cross_entropy`` is the LM head and
the loss fused over vocabulary chunks, so that the [tokens, V] logits
are never built; ``GPTModel`` takes it under ``fused_lm_cross_entropy``
(which ``arguments.apply_fused_ce_policy`` turns on at 128k vocabularies
and above with an unsharded vocabulary, as in the JAX package).  Its
chunk products are cuBLAS calls with fp32 outputs (``ops/matmul.mm_f32``),
as the JAX package computes them outside any Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from megatron_llm_torch import topology
from megatron_llm_torch.ops.matmul import mm_f32
from megatron_llm_torch.parallel import mappings


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 label_smoothing: float = 0.0
                                 ) -> torch.Tensor:
    """Per-token loss [...] fp32 of logits [..., V] against int labels
    [...]; with ``label_smoothing`` the target is smoothed against the
    uniform distribution over the vocabulary.  At tp > 1 ``logits`` are
    this rank's vocabulary shard and ``labels`` global ids."""
    if topology.get_tensor_model_parallel_world_size() > 1:
        return shard_vocab_parallel_cross_entropy(logits, labels,
                                                  label_smoothing)
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


class _VocabParallelCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local_logits, labels, label_smoothing, group):
        x = local_logits.float()
        vl = x.shape[-1]
        rank = dist.get_rank(mappings._group(group))
        n = dist.get_world_size(mappings._group(group))
        vocab = vl * n
        # 1) the global max (all-reduce MAX)
        gmax = mappings.collective("all_reduce", x.max(dim=-1).values,
                                   group, reduce="max")
        shifted = x - gmax[..., None]
        # 2) the target logit on its owning rank, summed over the ranks
        local = labels.long() - rank * vl
        inside = (local >= 0) & (local < vl)
        picked = shifted.gather(-1, local.clamp(0, vl - 1)[..., None])[..., 0]
        target = mappings.collective(
            "all_reduce", torch.where(inside, picked, 0.0), group)
        # 3) the shards' sum-exp, summed
        exp = shifted.exp()
        sum_exp = mappings.collective("all_reduce", exp.sum(dim=-1), group)
        log_z = sum_exp.log()
        loss = log_z - target
        smoothing = 0.0
        if label_smoothing > 0.0:
            smoothing = label_smoothing * vocab / (vocab - 1)
            mean_log_probs = mappings.collective(
                "all_reduce", shifted.sum(dim=-1), group) / vocab - log_z
            loss = (1.0 - smoothing) * loss - smoothing * mean_log_probs
        softmax = exp.div_(sum_exp[..., None])
        ctx.save_for_backward(softmax, local.clamp(0, vl - 1), inside)
        ctx.smoothing, ctx.vocab = smoothing, vocab
        ctx.in_dtype = local_logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        softmax, local, inside = ctx.saved_tensors
        # d loss / d logit_j = softmax_j - (1 - s) onehot_j - s / V
        grad = softmax.clone()
        hit = torch.zeros_like(grad).scatter_(
            -1, local[..., None], inside[..., None].to(grad.dtype))
        grad.sub_(hit, alpha=1.0 - ctx.smoothing)
        if ctx.smoothing:
            grad.sub_(ctx.smoothing / ctx.vocab)
        grad.mul_(g[..., None].float())
        return grad.to(ctx.in_dtype), None, None, None


def shard_vocab_parallel_cross_entropy(local_logits: torch.Tensor,
                                       labels: torch.Tensor,
                                       label_smoothing: float = 0.0,
                                       group=None) -> torch.Tensor:
    """Per-token loss [...] fp32 over the local vocab shard
    ``local_logits`` [..., V / tp] of the tp ``group`` (the topology's by
    default); ``labels`` are global ids."""
    return _VocabParallelCrossEntropy.apply(local_logits, labels,
                                            float(label_smoothing), group)


def vocab_parallel_max_indices(logits: torch.Tensor) -> torch.Tensor:
    """The global argmax over the (at tp > 1, sharded) vocabulary."""
    if topology.get_tensor_model_parallel_world_size() > 1:
        return shard_vocab_parallel_max_indices(logits)
    return logits.argmax(dim=-1).int()


def shard_vocab_parallel_max_indices(local_logits: torch.Tensor,
                                     group=None) -> torch.Tensor:
    """The argmax across the tp group's vocab shards, ties to the lowest
    id as a sequential argmax breaks them."""
    vl = local_logits.shape[-1]
    rank = dist.get_rank(mappings._group(group))
    x = local_logits.float()
    local_max, local_arg = x.max(dim=-1)
    local_arg = local_arg.int() + rank * vl
    gmax = mappings.collective("all_reduce", local_max, group, reduce="max")
    cand = torch.where(local_max >= gmax, local_arg,
                       torch.full_like(local_arg, 2 ** 31 - 1))
    return mappings.collective("all_reduce", cand, group, reduce="min")


def dense_cross_entropy(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """Per-example loss over a small unsharded class axis, fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[..., None])[..., 0]



# ---------------------------------------------------------------------------
# fused (chunked) linear + cross entropy
# ---------------------------------------------------------------------------

def _flce_pick_chunk(v: int, chunk: int) -> int:
    """Largest divisor of ``v`` that is <= ``chunk``.  A chunk below 1 is
    refused, and so is a vocabulary whose best divisor is far below the
    request (an unpadded vocabulary would serialise into thousands of
    small products): pad it to a multiple of 128."""
    if chunk < 1:
        raise ValueError(f"fused_ce_chunk_size must be >= 1, got {chunk}")
    c = min(chunk, v)
    while v % c != 0:
        c -= 1
    if c < min(chunk, v) // 16:
        raise ValueError(
            f"vocab size {v} has no divisor near chunk_size {chunk} "
            f"(best is {c}); pad the vocab to a multiple of 128 or pick "
            f"a chunk_size that divides it")
    return c


def _flce_forward(h2, w, labels, chunk):
    """h2 [N, H] (compute dtype), w [V, H], labels [N] -> (loss [N], lse
    [N]), fp32.  An online logsumexp over the vocabulary chunks: one [N,
    chunk] fp32 block of logits lives at a time."""
    n, v = h2.shape[0], w.shape[0]
    vc = _flce_pick_chunk(v, chunk)
    m = torch.full((n,), -torch.inf, dtype=torch.float32, device=h2.device)
    l = torch.zeros(n, dtype=torch.float32, device=h2.device)
    picked = torch.zeros(n, dtype=torch.float32, device=h2.device)
    for off in range(0, v, vc):
        logits = mm_f32(h2, w[off:off + vc].t())              # [N, vc]
        m_new = torch.maximum(m, logits.max(dim=-1).values)
        l = l * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]).sum(dim=-1)
        m = m_new
        local = labels - off
        valid = (local >= 0) & (local < vc)
        got = logits.gather(1, local.clamp(0, vc - 1)[:, None])[:, 0]
        picked = picked + torch.where(valid, got, 0.0)
    lse = m + torch.log(l)
    return lse - picked, lse


def _flce_backward(h2, w, labels, lse, g, chunk):
    """(dh [N, H], dw [V, H]) given d(loss) = g [N].  Each chunk's logits
    are recomputed; the gradient of the loss in them is softmax minus the
    one-hot label.  dh sums in fp32 across the chunks; each dW chunk is
    cast to the weight's dtype."""
    v = w.shape[0]
    vc = _flce_pick_chunk(v, chunk)
    gf = g.float()
    dh = torch.zeros(h2.shape, dtype=torch.float32, device=h2.device)
    dw = torch.empty_like(w)
    cols = torch.arange(vc, device=h2.device)
    for off in range(0, v, vc):
        wc = w[off:off + vc]
        p = torch.exp(mm_f32(h2, wc.t()) - lse[:, None])
        onehot = (cols[None, :] == (labels - off)[:, None]).float()
        dlogits = ((p - onehot) * gf[:, None]).to(h2.dtype)
        dh += mm_f32(dlogits, wc)
        dw[off:off + vc] = mm_f32(dlogits.t(), h2).to(w.dtype)
    return dh.to(h2.dtype), dw


class _FusedLinearCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h2, weight, labels, chunk_size):
        loss, lse = _flce_forward(h2, weight, labels, chunk_size)
        ctx.save_for_backward(h2, weight, labels, lse)
        ctx.chunk_size = chunk_size
        return loss

    @staticmethod
    def backward(ctx, g):
        h2, weight, labels, lse = ctx.saved_tensors
        dh, dw = _flce_backward(h2, weight, labels, lse, g,
                                ctx.chunk_size)
        return dh, dw, None, None


def fused_linear_cross_entropy(h: torch.Tensor, weight: torch.Tensor,
                               labels: torch.Tensor,
                               chunk_size: int = 8192) -> torch.Tensor:
    """Per-token cross entropy [...] fp32 of ``softmax(h @ weight.T)``
    against ``labels`` [...], without the [tokens, V] logits: h [..., H]
    in the compute dtype, weight [V, H].  Equal to
    ``vocab_parallel_cross_entropy(parallel_lm_logits(h, weight))`` up to
    fp association."""
    shape = labels.shape
    h2 = h.reshape(-1, h.shape[-1])
    return _FusedLinearCrossEntropy.apply(
        h2, weight, labels.reshape(-1).long(), chunk_size).reshape(shape)
