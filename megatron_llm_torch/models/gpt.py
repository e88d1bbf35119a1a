"""GPT-style decoder-only model wrapper (the counterpart of
``megatron_llm_tpu/models/gpt.py``): holds the config and the device;
params live in a dict tree owned by the caller."""

from __future__ import annotations

from typing import Optional, Union

import torch

from megatron_llm_torch.config import TransformerConfig
from megatron_llm_torch.models.language_model import (
    flops_per_token,
    init_language_model_params,
    language_model_forward,
    lm_head_weight,
    unsupported_features,
)
from megatron_llm_torch.ops.cross_entropy import (
    fused_linear_cross_entropy,
    vocab_parallel_cross_entropy,
)


class GPTModel:
    def __init__(self, cfg: TransformerConfig, device=None):
        missing = unsupported_features(cfg)
        if missing:
            raise NotImplementedError(
                f"not ported yet: {', '.join(missing)}")
        self.cfg = cfg
        # entry points run on the card unless the caller asks otherwise
        self.device = torch.device(device if device is not None else "cuda")

    def init(self, seed: Union[int, torch.Generator]) -> dict:
        """Random params from ``seed`` (an int, or a generator on the
        model's device), in ``cfg.params_dtype``."""
        if isinstance(seed, torch.Generator):
            gen = seed
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))
        return init_language_model_params(gen, self.cfg, device=self.device)

    def num_params(self, params) -> int:
        total = 0
        stack = [params]
        while stack:
            node = stack.pop()
            if isinstance(node, dict):
                stack.extend(node.values())
            else:
                total += node.numel()
        return total

    def flops_per_token(self, seq_len=None) -> float:
        return flops_per_token(self.cfg, seq_len)

    def __call__(self, params, tokens: torch.Tensor,
                 position_ids: Optional[torch.Tensor] = None,
                 attention_mask: Optional[torch.Tensor] = None,
                 labels: Optional[torch.Tensor] = None, *,
                 rng_key: Optional[int] = None, train: bool = False,
                 kv_caches=None):
        """Per-token loss [b, s] fp32 when ``labels`` are given, else
        logits [b, s, V] (each with the new caches under ``kv_caches``).
        A mixture of experts returns ``(loss, moe_aux)`` on the loss path
        without caches (the routing aux ``[lb, z]``, which the train step
        weights); generation drops the aux.
        ``rng_key``: the micro-batch's dropout key (an integer,
        ``megatron_llm_torch/random.py``); without one nothing is
        dropped."""
        cfg = self.cfg
        moe_on = cfg.num_experts > 1
        if (labels is not None and kv_caches is None
                and cfg.fused_lm_cross_entropy):
            # the head and the loss fused over vocabulary chunks: the [b,
            # s, V] logits are never built; a tied head's gradient joins
            # the embedding lookup's through autograd
            h = language_model_forward(params, tokens, position_ids,
                                       attention_mask, cfg, rng_key=rng_key,
                                       train=train, compute_logits=False)
            moe_aux = None
            if moe_on:
                h, moe_aux = h
            head = lm_head_weight(params).to(cfg.compute_torch_dtype)
            loss = fused_linear_cross_entropy(
                h, head, labels, chunk_size=cfg.fused_ce_chunk_size)
            return (loss, moe_aux) if moe_on else loss
        out = language_model_forward(params, tokens, position_ids,
                                     attention_mask, cfg, rng_key=rng_key,
                                     train=train, kv_caches=kv_caches)
        moe_aux = new_caches = None
        if kv_caches is not None:
            logits, new_caches = out
        elif moe_on:
            logits, moe_aux = out
        else:
            logits = out
        if labels is None:
            # generation: the routing aux is not needed
            return (logits, new_caches) if kv_caches is not None else logits
        loss = vocab_parallel_cross_entropy(logits.float(), labels)
        if kv_caches is not None:
            return loss, new_caches
        return (loss, moe_aux) if moe_on else loss
