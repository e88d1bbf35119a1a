"""Products with fp32 outputs from compute-dtype operands: the port's
counterpart of ``preferred_element_type=jnp.float32`` in the JAX
package's chunked attention and fused LM-head cross entropy.

A bf16 ``torch.matmul`` rounds its fp32 accumulator to bf16.  On the card
the ``out_dtype`` overloads of ``torch.mm`` / ``torch.bmm``
(``aten::mm.dtype``, ``aten::bmm.dtype``) keep it in fp32.  PyTorch has no
CPU kernel for those overloads, so a CPU tensor is upcast to fp32 first:
the bf16 products are exact in fp32 either way, only the order of the
sums differs.  The route is chosen by the tensor's device alone.
"""

from __future__ import annotations

import torch


def _product(op, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.dtype == torch.float32:
        return op(a, b)
    if a.device.type == "cuda":
        return op(a, b, out_dtype=torch.float32)
    return op(a.float(), b.float())


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [n, k] @ b [k, m] -> fp32 [n, m]; no autograd (the callers sit
    inside an ``autograd.Function``)."""
    return _product(torch.mm, a, b)


class _BmmF32(torch.autograd.Function):
    """a [B, n, k] @ b [B, k, m] -> fp32 [B, n, m].  The backward casts
    the fp32 cotangent to the operands' dtype and forms the two products
    there, as autograd does for a product in that dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _product(torch.bmm, a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        da = torch.bmm(g, b.transpose(1, 2)) if ctx.needs_input_grad[0] \
            else None
        db = torch.bmm(a.transpose(1, 2), g) if ctx.needs_input_grad[1] \
            else None
        return da, db


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched product with an fp32 output, differentiable."""
    return _BmmF32.apply(a, b)
