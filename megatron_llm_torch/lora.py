"""LoRA finetuning (the counterpart of ``megatron_llm_tpu/lora.py``).

Low-Rank Adaptation: every targeted linear ``W [.., in, out]`` gains a
pair ``A [.., in, r]`` (gaussian / sqrt(r)) and ``B [.., r, out]``
(zeros), and the layer computes ``y = x W + (x A) B * (alpha / r)``
(``parallel/layers.py``): at init B = 0 makes the adapted model exactly
the base model.  Only the adapters train: the train step's tree is the
adapter tree, so grads, fp32 masters and Adam moments exist for it
alone, and the frozen base params are held by ``LoraAdapter``, outside
the trained tree.  The low-rank path stays two thin matmuls: ``W + BA``
is built once, by ``merge_lora`` at export, never in the forward.

The adapter tree holds the JAX package's leaves in the same order: the
JAX tree mirrors the whole param tree with ``None`` at every untargeted
node, which its tree utilities skip; here those nodes are left out,
since the port's trees (``tree.py``) have tensor leaves only.

Usage (library)::

    lora = init_lora(model, params, rank=8, seed=1235)   # adapter tree
    adapter = LoraAdapter(model, params)                  # train-step model
    step = build_train_step(adapter, opt, pc, M)          # opt over lora only
    merged = merge_lora(params, lora)                     # export to base fmt

CLI: ``python -m megatron_llm_torch.finetune --lora_rank=8
[--lora_alpha=16] [--lora_targets=query_key_value,dense,...]``.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Union

import torch

from megatron_llm_torch.tree import tree_leaves

# default targets: the attention projections (the standard LoRA recipe);
# names are the param-dict keys used across the model families
DEFAULT_TARGETS = ("query_key_value", "dense")


def _is_linear(node) -> bool:
    k = node.get("kernel") if isinstance(node, dict) else None
    return isinstance(k, torch.Tensor) and k.dim() >= 2


def init_lora(model, params: Any, rank: int,
              seed: Union[int, torch.Generator],
              alpha: Optional[float] = None,
              targets: Sequence[str] = DEFAULT_TARGETS):
    """Adapter tree over ``params``: each targeted linear dict maps to
    {'lora_A', 'lora_B', 'lora_scale'} (A and B in the kernel's dtype,
    the scale alpha / r in fp32 with the kernel's leading dims); other
    nodes are left out.  ``seed``: an int or a generator on the params'
    device; the A draws follow the sorted key order."""
    alpha = float(alpha if alpha is not None else 2 * rank)
    scaling = alpha / rank
    gen = seed
    if not isinstance(gen, torch.Generator):
        device = tree_leaves(params)[0].device
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))

    def walk(node, name=""):
        if not isinstance(node, dict):
            return None
        if name in targets and _is_linear(node):
            kern = node["kernel"]
            *lead, fan_in, fan_out = kern.shape
            a = torch.randn((*lead, fan_in, rank), generator=gen,
                            dtype=torch.float32, device=kern.device)
            return {
                "lora_A": (a / math.sqrt(float(rank))).to(kern.dtype),
                "lora_B": torch.zeros((*lead, rank, fan_out),
                                      dtype=kern.dtype, device=kern.device),
                # lead dims mirror the kernel's (the layer stack unbinds
                # every leaf's leading axis)
                "lora_scale": torch.full(tuple(lead), scaling,
                                         dtype=torch.float32,
                                         device=kern.device),
            }
        out = {}
        for k in sorted(node):
            sub = walk(node[k], k)
            if sub:
                out[k] = sub
        return out

    return walk(params)


def attach_lora(params: Any, lora: Any):
    """Forward-time view: targeted linear dicts gain the lora leaves
    (``parallel/layers.py`` applies the low-rank path when they are
    present).  Base leaves are shared, not copied."""
    if not lora:
        return params
    if "lora_A" in lora:
        return {**params, **lora}
    return {k: attach_lora(v, lora.get(k)) if isinstance(v, dict) else v
            for k, v in params.items()}


def _merged_kernel(kern: torch.Tensor, ad: dict) -> torch.Tensor:
    """kernel + scale * A @ B in fp32, rounded to the kernel's dtype; one
    [in, out] slice of the leading dims at a time, so the fp32 update is
    never larger than one layer's kernel."""
    fan_in, fan_out = kern.shape[-2:]
    k3 = kern.reshape(-1, fan_in, fan_out)
    a3 = ad["lora_A"].reshape(-1, fan_in, ad["lora_A"].shape[-1])
    b3 = ad["lora_B"].reshape(-1, ad["lora_B"].shape[-2], fan_out)
    s1 = ad["lora_scale"].reshape(-1)
    out = torch.empty_like(k3)
    for i in range(k3.shape[0]):
        upd = torch.matmul(a3[i].float(), b3[i].float()) * s1[i]
        out[i] = (k3[i].float() + upd).to(kern.dtype)
    return out.reshape(kern.shape)


@torch.no_grad()
def merge_lora(params: Any, lora: Any):
    """Export: fold the adapters into the base kernels (kernel += scale *
    A @ B) so the result loads anywhere a base checkpoint does.  The
    update is materialised here, once — never in the forward."""
    if not lora:
        return params
    if "lora_A" in lora:
        return {**params, "kernel": _merged_kernel(params["kernel"], lora)}
    return {k: merge_lora(v, lora.get(k)) if isinstance(v, dict) else v
            for k, v in params.items()}


class LoraAdapter:
    """Model wrapper whose trainable tree is the LoRA tree.

    Quacks like the wrapped model for ``build_train_step`` / ``pretrain``
    / ``MegatronOptimizer``: ``__call__(lora, tokens, ...)`` runs the base
    model with the adapters attached; the frozen base params are held
    here (no grads, no optimizer state, no fp32 masters)."""

    def __init__(self, model, base_params):
        self.model = model
        self.base_params = base_params
        self.cfg = model.cfg
        self.device = model.device

    def __call__(self, lora, *args, **kwargs):
        return self.model(attach_lora(self.base_params, lora), *args,
                          **kwargs)

    def init_lora(self, rank: int, seed, alpha=None,
                  targets: Sequence[str] = DEFAULT_TARGETS):
        return init_lora(self.model, self.base_params, rank, seed,
                         alpha=alpha, targets=targets)

    def num_params(self, lora) -> int:
        return sum(t.numel() for t in tree_leaves(lora))

    def flops_per_token(self, seq_len=None) -> float:
        return self.model.flops_per_token(seq_len)
