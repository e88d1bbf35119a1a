"""Linear layers, embedding lookup and LM logits at tensor-parallel size 1.

The tp=1 subset of ``megatron_llm_tpu/parallel/layers.py``: column- and
row-parallel linears are plain matmuls over ``{'kernel': [in, out]}``
params (the JAX package's layout, so one param dict loads into both),
the vocab-parallel embedding is a gather, and the logits are a matmul
against the ``[V, H]`` head.  A linear whose dict carries LoRA leaves
(``lora.py``) adds its low-rank path; one whose dict carries int8
``kernel_q`` / ``kernel_scale`` (``quantization.py``) takes its operand
through ``dequantize_kernel``.  The dense products stay ``torch.matmul``,
as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from megatron_llm_torch.quantization import dequantize_kernel


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
                             compute_dtype=None) -> torch.Tensor:
    """Embedding lookup (the whole vocabulary lives on one device)."""
    return _cast(params["embedding"], compute_dtype)[tokens]


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


def column_parallel_linear(x: torch.Tensor, params, *,
                           compute_dtype=None) -> torch.Tensor:
    """y = x @ W (+ the LoRA path) (+ b); W is the int8 kernel times its
    scales where the dict holds them."""
    y = torch.matmul(x, dequantize_kernel(params, compute_dtype))
    if "lora_A" in params:
        y = y + _lora_delta(x, params)
    bias = _cast(params.get("bias"), compute_dtype)
    return y if bias is None else y + bias


def row_parallel_linear(x: torch.Tensor, params, *,
                        compute_dtype=None) -> torch.Tensor:
    """y = x @ W (+ b); at tp=1 the same product as the column linear."""
    return column_parallel_linear(x, params, compute_dtype=compute_dtype)


def parallel_lm_logits(hidden: torch.Tensor, word_embedding_or_head:
                       torch.Tensor, *, compute_dtype=None) -> torch.Tensor:
    """Logits = hidden @ E^T over the [V, H] head."""
    return torch.matmul(hidden,
                        _cast(word_embedding_or_head, compute_dtype).t())
