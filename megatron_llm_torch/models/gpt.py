"""GPT-style decoder-only model wrapper (the counterpart of
``megatron_llm_tpu/models/gpt.py``): holds the config and the device;
params live in a dict tree owned by the caller.  At tp > 1 the tree is
this rank's slices (``parallel/sharding.py``), the loss the
vocab-parallel cross entropy over this rank's logits, and the logits of
a call without labels are gathered to the whole vocabulary."""

from __future__ import annotations

from typing import Optional, Union

import torch

from megatron_llm_torch import topology
from megatron_llm_torch.config import TransformerConfig
from megatron_llm_torch.models.language_model import (
    flops_per_token,
    init_params_at_tp,
    language_model_forward,
    lm_head_weight,
    make_generator,
    num_params,
    unsupported_features,
)
from megatron_llm_torch.ops.cross_entropy import (
    fused_linear_cross_entropy,
    vocab_parallel_cross_entropy,
)
from megatron_llm_torch.parallel import mappings


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
        model's device), in ``cfg.params_dtype``: at tp > 1 this rank's
        slices of the one-device draws."""
        return init_params_at_tp(make_generator(seed, self.device),
                                 self.cfg, device=self.device)

    def num_params(self, params) -> int:
        return num_params(params)

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
        tp = topology.get_tensor_model_parallel_world_size()
        if cfg.fused_lm_cross_entropy and tp > 1:
            raise NotImplementedError(
                "fused_lm_cross_entropy over a vocab sharded at tp > 1 is "
                "not ported (the vocab-parallel cross entropy already "
                "avoids the full logits)")
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
            if tp > 1:
                logits = mappings.gather_from_tensor_model_parallel_region(
                    logits)
            # generation: the routing aux is not needed
            return (logits, new_caches) if kv_caches is not None else logits
        loss = vocab_parallel_cross_entropy(logits.float(), labels)
        if kv_caches is not None:
            return loss, new_caches
        return (loss, moe_aux) if moe_on else loss
