"""Weight-only int8 for inference, and the symmetric absmax quantiser that
the int8 KV caches share (the counterpart of
``megatron_llm_tpu/quantization.py``).

Decode is weight-bandwidth-bound: each generated token reads every dense
weight again.  Stored as int8 with per-output-channel fp32 scales, the
linear kernels take half their bf16 bytes; the dequantise (``int8 ->
compute dtype, * scale``) sits on the matmul operand
(``dequantize_weight``), where the JAX package leaves XLA to fuse it into
the dot.  Here it is a plain dequantise followed by ``torch.matmul``: the
JAX package has no Pallas kernel for it, so neither has the port.

Scope: the linear kernels (QKV, output projection, MLP) and the MoE expert
banks, the bulk of the weight bytes.  Embeddings, the LM head, norms and
the MoE routers stay float.  Inference only: the training step expects
float ``kernel`` leaves.

Usage::

    from megatron_llm_torch.quantization import quantize_linear_weights_int8
    qparams = quantize_linear_weights_int8(params)
    generate_tokens(model, qparams, ...)   # the same call sites
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from megatron_llm_torch import topology


def absmax_quantize_int8(t: torch.Tensor, axis: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduce ``|t|`` over ``axis``: scale = max / 127 (1.0 where all zero),
    q = clip(round(t / scale), -127, 127), rounding half to even, all in
    fp32.  Returns (q int8 of t's shape, scale fp32 without ``axis``).
    The weight quantiser (axis -2) and the int8 KV caches (axis -1)
    share it."""
    t32 = t.float()
    absmax = t32.abs().amax(dim=axis)
    scale = torch.where(absmax > 0, absmax / 127.0,
                        torch.ones_like(absmax))
    q = torch.round(t32 / scale.unsqueeze(axis)).clamp(-127, 127)
    return q.to(torch.int8), scale


def _quantize_kernel(kernel: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., in, out] float (plain, stacked [L, ...], or an MoE expert bank
    [L, E, ...]) -> (int8 kernel_q, fp32 [..., out] kernel_scale):
    symmetric per-output-channel absmax over the input axis (-2).  A
    stacked kernel is quantised one leading index at a time, so the fp32
    temporaries are one layer's, not the stack's."""
    if kernel.dim() < 3:
        return absmax_quantize_int8(kernel, axis=-2)
    q = torch.empty(kernel.shape, dtype=torch.int8, device=kernel.device)
    scale = torch.empty(kernel.shape[:-2] + kernel.shape[-1:],
                        dtype=torch.float32, device=kernel.device)
    for i in range(kernel.shape[0]):
        q[i], scale[i] = _quantize_kernel(kernel[i])
    return q, scale


#: the weight names the quantiser understands, all stored [..., in, out]:
#: 'kernel' (dense linears), 'w_in' / 'w_out' (MoE expert banks, moe.py)
QUANTIZABLE_WEIGHTS = ("kernel", "w_in", "w_out")


def dequantize_weight(params: dict, name: str,
                      compute_dtype=None) -> torch.Tensor:
    """The matmul operand for a named weight, quantised or not: int8 times
    its scale in ``compute_dtype`` (bf16 when None, as in the JAX
    package), or the float weight cast to ``compute_dtype``."""
    if f"{name}_q" in params:
        dt = compute_dtype if compute_dtype is not None else torch.bfloat16
        scale = params[f"{name}_scale"].to(dt)
        return params[f"{name}_q"].to(dt) * scale.unsqueeze(-2)
    w = params[name]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
    return w


def dequantize_kernel(params: dict, compute_dtype=None) -> torch.Tensor:
    """column/row_parallel_linear's operand (see ``dequantize_weight``)."""
    return dequantize_weight(params, "kernel", compute_dtype)


def quantize_linear_weights_int8(params: Any, min_params: int = 4096,
                                 consume: bool = False):
    """Tree transform: every dict member named in ``QUANTIZABLE_WEIGHTS``
    that is a float tensor of 2 to 4 dims and at least ``min_params``
    elements becomes ``{name}_q`` (int8) and ``{name}_scale`` (fp32
    [..., out]); everything else (biases, norms, embeddings, small
    kernels, MoE routers) is kept, the same tensors.  With ``consume``
    each float leaf is also popped from ``params`` once its int8 copy
    exists, so a caller that holds no other reference frees the float
    tree leaf by leaf instead of holding both trees at once.  Int8
    weights at tp > 1 raise (their specs are a later slice)."""
    topology.refuse_at_tp("int8 weights (--int8_weights)")

    def walk(node):
        if isinstance(node, dict):
            # never quantise MoE routers: their logits choose the experts
            # (a per-expert scale perturbs the top-k) and the [hidden, E]
            # tensor is a negligible share of the bytes
            if "router" in node:
                rest = {key: walk(v) for key, v in node.items()
                        if key != "router"}
                rest["router"] = node["router"]
                return rest
            hits = [key for key in QUANTIZABLE_WEIGHTS
                    if (isinstance(node.get(key), torch.Tensor)
                        and 2 <= node[key].dim() <= 4
                        and node[key].is_floating_point()
                        and node[key].numel() >= min_params)]
            out = {key: walk(v) for key, v in node.items()
                   if key not in hits}
            for key in hits:
                q, scale = _quantize_kernel(
                    node.pop(key) if consume else node[key])
                out[f"{key}_q"] = q
                out[f"{key}_scale"] = scale
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)


def quantize_param_specs(specs: Any, qparams: Any):
    """The sharding-spec counterpart of ``quantize_linear_weights_int8``
    waits for the port's tensor parallelism (ROADMAP item 15): the port
    serves on one device, with no specs to transform."""
    raise NotImplementedError(
        "quantize_param_specs: the port has no sharded serving yet "
        "(ROADMAP item 15)")


def quantized_weight_bytes(params: Any) -> Tuple[int, int]:
    """(int8 bytes, float bytes) over every tensor leaf of ``params``."""
    qb = fb = 0
    stack = [params]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif isinstance(node, torch.Tensor):
            n = node.numel() * node.element_size()
            if node.dtype == torch.int8:
                qb += n
            else:
                fb += n
    return qb, fb
