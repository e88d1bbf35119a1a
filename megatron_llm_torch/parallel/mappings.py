"""The seven tensor-parallel mappings as ``torch.autograd.Function``s over
the tp process group (the counterpart of
``megatron_llm_tpu/parallel/mappings.py``, which writes them as
``jax.custom_vjp``s for ``shard_map`` code).  Each pairs a forward
collective with its transpose in the backward:

| mapping                                    | forward        | backward       |
|--------------------------------------------|----------------|----------------|
| copy_to_tensor_model_parallel_region       | identity       | all-reduce     |
| reduce_from_tensor_model_parallel_region   | all-reduce     | identity       |
| scatter_to_tensor_model_parallel_region    | split last dim | all-gather     |
| gather_from_tensor_model_parallel_region   | all-gather     | split last dim |
| scatter_to_sequence_parallel_region        | split seq dim  | all-gather     |
| gather_from_sequence_parallel_region       | all-gather     | reduce-scatter |
| reduce_scatter_to_sequence_parallel_region | reduce-scatter | all-gather     |

The sequence mappings take the sequence dim as ``dim``: 0 (the JAX
mappings' first dim, the reference's ``[s, b, h]``) by default; the
model's ``[b, s, h]`` activations pass 1.  The backward of the SP gather
is a reduce-scatter, not a split: its output feeds compute replicated
over tp, so the grads of all ranks must be summed.

Every collective goes through ``collective``, on the (backend, device
type, op) triples of the fixed table ``ROUTES``; any other raises
``NotImplementedError``.  Besides the three of the mappings, ``gather``
(to the group's first rank) moves a checkpoint's pieces to the writer:
on host tensors under gloo, on CUDA tensors under NCCL.  gloo takes CUDA tensors for all three ops and
stages them through the host itself, so no op stages a copy here: two
ranks on one H100 (torch 2.11) took 117, 100 and 49 ms for a tp-2
rank's all-gather, reduce-scatter and all-reduce on gloo's own CUDA
route against 191, 196 and 88 ms through a host copy made in Python
(``chip_smoke.py --tp_only``; ``PERF.md`` §5).  ``calls`` counts the
collectives by triple, so that a run can report them.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist

from megatron_llm_torch import topology

# the (backend, device type, op) triples the collectives run on
ROUTES = frozenset((backend, dev, op)
                   for backend, dev in (("gloo", "cpu"), ("gloo", "cuda"),
                                        ("nccl", "cuda"))
                   for op in ("all_reduce", "all_gather", "reduce_scatter")
                   ) | {("gloo", "cpu", "gather"), ("nccl", "cuda", "gather")}

# (backend, device type, op) -> calls in this process
calls: Counter = Counter()

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}


def _group(group):
    return group if group is not None else \
        topology.get_tensor_model_parallel_group()


def collective(op: str, x: torch.Tensor, group=None, *, dim: int = 0,
               reduce: str = "sum") -> torch.Tensor:
    """One collective over ``group`` (the tp group by default), returning
    a new tensor: ``all_reduce`` (``reduce`` sum, max or min),
    ``all_gather`` (the ranks' ``x`` concatenated along ``dim``, in rank
    order), ``reduce_scatter`` (the sum over the ranks, this rank's
    chunk of it along ``dim``) or ``gather`` (on the group's first rank
    what ``all_gather`` gives, None on the others)."""
    group = _group(group)
    n = dist.get_world_size(group)
    key = (dist.get_backend(group), x.device.type, op)
    if key not in ROUTES:
        raise NotImplementedError(f"no route for {op} over "
                                  f"{key[0]} on {key[1]} tensors")
    calls[key] += 1
    t = x.detach().contiguous()
    if op == "all_reduce":
        out = t.clone()
        dist.all_reduce(out, op=_REDUCE_OPS[reduce], group=group)
    elif op == "all_gather":
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        out = torch.cat(parts, dim=dim)
    elif op == "gather":
        root = dist.get_global_rank(group, 0)
        mine = dist.get_rank() == root
        parts = [torch.empty_like(t) for _ in range(n)] if mine else None
        dist.gather(t, parts, dst=root, group=group)
        out = torch.cat(parts, dim=dim) if mine else None
    elif op == "reduce_scatter":
        if t.shape[dim] % n:
            raise ValueError(f"reduce_scatter: dim {dim} of "
                             f"{tuple(t.shape)} is not divisible by {n}")
        chunks = [c.contiguous() for c in t.chunk(n, dim=dim)]
        out = torch.empty_like(chunks[0])
        dist.reduce_scatter(out, chunks, group=group)
    else:
        raise ValueError(f"unknown collective {op!r}")
    return out


def _split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk of ``x`` along ``dim``."""
    group = _group(group)
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} is not divisible "
                         f"by the tp size {n}")
    return x.chunk(n, dim=dim)[dist.get_rank(group)].contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return collective("all_reduce", g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return collective("all_reduce", x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _split(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return collective("all_gather", g, ctx.group, dim=ctx.dim), None, \
            None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return collective("all_gather", x, group, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _split(g, ctx.dim, ctx.group), None, None


class _SequenceGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return collective("all_gather", x, group, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return collective("reduce_scatter", g, ctx.group, dim=ctx.dim), \
            None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return collective("reduce_scatter", x, group, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return collective("all_gather", g, ctx.group, dim=ctx.dim), None, \
            None


def copy_to_tensor_model_parallel_region(x, group=None):
    """Identity forward, all-reduce backward."""
    return _Copy.apply(x, group)


def reduce_from_tensor_model_parallel_region(x, group=None):
    """All-reduce forward, identity backward."""
    return _Reduce.apply(x, group)


def scatter_to_tensor_model_parallel_region(x, group=None):
    """This rank's chunk of the last dim forward, all-gather backward."""
    return _Scatter.apply(x, x.dim() - 1, group)


def gather_from_tensor_model_parallel_region(x, group=None):
    """All-gather of the last dim forward, this rank's chunk backward."""
    return _Gather.apply(x, x.dim() - 1, group)


def scatter_to_sequence_parallel_region(x, dim: int = 0, group=None):
    """This rank's chunk of the sequence dim forward, all-gather
    backward."""
    return _Scatter.apply(x, dim, group)


def gather_from_sequence_parallel_region(x, dim: int = 0, group=None):
    """All-gather of the sequence dim forward, reduce-scatter backward."""
    return _SequenceGather.apply(x, dim, group)


def reduce_scatter_to_sequence_parallel_region(x, dim: int = 0,
                                               group=None):
    """Reduce-scatter over the sequence dim forward, all-gather
    backward."""
    return _ReduceScatter.apply(x, dim, group)
