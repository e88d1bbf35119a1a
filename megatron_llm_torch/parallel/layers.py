"""Linear layers, embedding lookup and LM logits, at tensor-parallel size
1 and above (the counterpart of ``megatron_llm_tpu/parallel/layers.py``).

Params keep the JAX package's layout, ``{'kernel': [in, out]}`` (one
param dict loads into both packages); at tp > 1 each rank holds its
slice of them (``parallel/sharding.py``).  Where the JAX layers declare
a placement and leave the collectives to GSPMD, these call them
(``parallel/mappings.py``):

* ``vocab_parallel_embedding``: the lookup masks the ids outside this
  rank's vocabulary rows, then all-reduces, or under sequence
  parallelism reduce-scatters over the sequence;
* ``column_parallel_linear``: the input is copied in (all-reduce of its
  grad), or under sequence parallelism all-gathered over the sequence;
* ``row_parallel_linear``: the partial products are all-reduced, or
  reduce-scattered over the sequence; the bias is added once, after the
  reduction;
* ``parallel_lm_logits``: the hidden states are gathered (under sequence
  parallelism) and multiplied by this rank's vocabulary rows: the
  logits stay vocab-parallel for the cross entropy.

The sequence is dim 1 of the ``[b, s, h]`` activations.  A linear whose
dict carries LoRA leaves (``lora.py``) adds its low-rank path; one whose
dict carries int8 ``kernel_q`` / ``kernel_scale`` (``quantization.py``)
takes its operand through ``dequantize_kernel`` (both at tp 1 only).
The dense products stay ``torch.matmul``, as the JAX package leaves them
to XLA.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from megatron_llm_torch import topology
from megatron_llm_torch.parallel import mappings
from megatron_llm_torch.quantization import dequantize_kernel

SEQ_DIM = 1


def init_method_normal(std: float):
    def init(generator: torch.Generator, shape, dtype, device):
        out = torch.empty(shape, dtype=dtype, device=device)
        return out.normal_(0.0, std, generator=generator)

    return init


def init_method_for(cfg):
    """Trunk weight init: normal(std), or xavier-uniform under
    ``init_method_xavier_uniform``."""
    if getattr(cfg, "init_method_xavier_uniform", False):
        def init(generator, shape, dtype, device):
            out = torch.empty(shape, dtype=dtype, device=device)
            if len(shape) < 2:
                return out.zero_()
            bound = math.sqrt(6.0 / (shape[-2] + shape[-1]))
            return out.uniform_(-bound, bound, generator=generator)

        return init
    return init_method_normal(cfg.init_method_std)


def scaled_init_method_normal(std: float, num_layers: int):
    return init_method_normal(std / math.sqrt(2.0 * num_layers))


def init_linear_params(generator, in_dim: int, out_dim: int, *,
                       bias: bool = True, init_method=None,
                       dtype=torch.float32, device=None):
    if init_method is None:
        init_method = init_method_normal(0.02)
    params = {"kernel": init_method(generator, (in_dim, out_dim), dtype,
                                    device)}
    if bias:
        params["bias"] = torch.zeros((out_dim,), dtype=dtype, device=device)
    return params


def init_embedding_params(generator, vocab_size: int, hidden: int, *,
                          init_method=None, dtype=torch.float32, device=None):
    if init_method is None:
        init_method = init_method_normal(0.02)
    return {"embedding": init_method(generator, (vocab_size, hidden), dtype,
                                     device)}


def _cast(t: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    if t is None or dtype is None:
        return t
    return t.to(dtype)


def vocab_parallel_embedding(tokens: torch.Tensor, params,
                             compute_dtype=None, *,
                             sequence_parallel: bool = False
                             ) -> torch.Tensor:
    """Embedding lookup over a vocab-sharded table: at tp 1 a gather; at
    tp > 1 this rank's rows ``[r V / tp, (r + 1) V / tp)`` answer their
    ids, the rest give zeros, and the ranks' lookups are summed (over
    the sequence shards under ``sequence_parallel``)."""
    table = _cast(params["embedding"], compute_dtype)
    tp = topology.get_tensor_model_parallel_world_size()
    if tp == 1:
        return table[tokens]
    vl = table.shape[0]
    local = tokens - topology.get_tensor_model_parallel_rank() * vl
    outside = (local < 0) | (local >= vl)
    out = table[local.clamp(0, vl - 1)].masked_fill(outside[..., None], 0)
    if sequence_parallel:
        return mappings.reduce_scatter_to_sequence_parallel_region(
            out, SEQ_DIM)
    return mappings.reduce_from_tensor_model_parallel_region(out)


def _lora_delta(x: torch.Tensor, params) -> torch.Tensor:
    """The LoRA low-rank path ``(x A) B * scale`` (``lora.py``): two thin
    matmuls, never the materialised [in, out] update.  ``lora_scale`` is a
    constant (alpha / r): detached, it gets no gradient although it rides
    in the trained tree for structure (the optimizer also leaves it out of
    weight decay)."""
    a = params["lora_A"].to(x.dtype)
    b = params["lora_B"].to(x.dtype)
    scale = params["lora_scale"].detach().to(x.dtype)
    return torch.matmul(torch.matmul(x, a), b) * scale


def _matmul(x: torch.Tensor, params, compute_dtype) -> torch.Tensor:
    """x @ W (+ the LoRA path); W is the int8 kernel times its scales
    where the dict holds them."""
    y = torch.matmul(x, dequantize_kernel(params, compute_dtype))
    if "lora_A" in params:
        y = y + _lora_delta(x, params)
    return y


def _add_bias(y: torch.Tensor, params, compute_dtype) -> torch.Tensor:
    bias = _cast(params.get("bias"), compute_dtype)
    return y if bias is None else y + bias


def column_parallel_linear(x: torch.Tensor, params, *,
                           compute_dtype=None,
                           sequence_parallel: bool = False) -> torch.Tensor:
    """y = x @ W (+ b), W and b this rank's output columns at tp > 1; the
    input comes in through the copy (or, under ``sequence_parallel``,
    the sequence all-gather)."""
    if topology.get_tensor_model_parallel_world_size() > 1:
        x = (mappings.gather_from_sequence_parallel_region(x, SEQ_DIM)
             if sequence_parallel
             else mappings.copy_to_tensor_model_parallel_region(x))
    return _add_bias(_matmul(x, params, compute_dtype), params,
                     compute_dtype)


def row_parallel_linear(x: torch.Tensor, params, *,
                        compute_dtype=None,
                        sequence_parallel: bool = False) -> torch.Tensor:
    """y = x @ W (+ b), W this rank's input rows at tp > 1: the partial
    products are all-reduced (reduce-scattered over the sequence under
    ``sequence_parallel``), then the bias is added once."""
    y = _matmul(x, params, compute_dtype)
    if topology.get_tensor_model_parallel_world_size() > 1:
        y = (mappings.reduce_scatter_to_sequence_parallel_region(y, SEQ_DIM)
             if sequence_parallel
             else mappings.reduce_from_tensor_model_parallel_region(y))
    return _add_bias(y, params, compute_dtype)


def parallel_lm_logits(hidden: torch.Tensor, word_embedding_or_head:
                       torch.Tensor, *, compute_dtype=None,
                       sequence_parallel: bool = False) -> torch.Tensor:
    """Logits = hidden @ E^T over the [V, H] head: at tp > 1 this rank's
    vocabulary columns [b, s, V / tp] of the whole sequence."""
    if topology.get_tensor_model_parallel_world_size() > 1:
        hidden = (mappings.gather_from_sequence_parallel_region(hidden,
                                                                SEQ_DIM)
                  if sequence_parallel
                  else mappings.copy_to_tensor_model_parallel_region(hidden))
    return torch.matmul(hidden,
                        _cast(word_embedding_or_head, compute_dtype).t())
