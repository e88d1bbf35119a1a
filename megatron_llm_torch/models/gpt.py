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
        ``rng_key``: the micro-batch's dropout key (an integer,
        ``megatron_llm_torch/random.py``); without one nothing is
        dropped."""
        cfg = self.cfg
        if (labels is not None and kv_caches is None
                and cfg.fused_lm_cross_entropy):
            # the head and the loss fused over vocabulary chunks: the [b,
            # s, V] logits are never built; a tied head's gradient joins
            # the embedding lookup's through autograd
            h = language_model_forward(params, tokens, position_ids,
                                       attention_mask, cfg, rng_key=rng_key,
                                       train=train, compute_logits=False)
            head = lm_head_weight(params).to(cfg.compute_torch_dtype)
            return fused_linear_cross_entropy(
                h, head, labels, chunk_size=cfg.fused_ce_chunk_size)
        out = language_model_forward(params, tokens, position_ids,
                                     attention_mask, cfg, rng_key=rng_key,
                                     train=train, kv_caches=kv_caches)
        if labels is None:
            return out
        logits, new_caches = out if kv_caches is not None else (out, None)
        loss = vocab_parallel_cross_entropy(logits.float(), labels)
        if kv_caches is not None:
            return loss, new_caches
        return loss
