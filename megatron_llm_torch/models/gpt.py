"""GPT-style decoder-only model wrapper (the counterpart of
``megatron_llm_tpu/models/gpt.py``): holds the config and the device;
params live in a dict tree owned by the caller."""

from __future__ import annotations

from typing import Optional, Union

import torch

from megatron_llm_torch.config import TransformerConfig
from megatron_llm_torch.models.language_model import (
    init_language_model_params,
    language_model_forward,
    unsupported_features,
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

    def __call__(self, params, tokens: torch.Tensor,
                 position_ids: Optional[torch.Tensor] = None,
                 attention_mask: Optional[torch.Tensor] = None,
                 labels: Optional[torch.Tensor] = None, *, kv_caches=None):
        """Logits [b, s, V] (and the new caches with ``kv_caches``)."""
        if labels is not None:
            raise NotImplementedError(
                "the training loss is part of the training slice")
        return language_model_forward(params, tokens, position_ids,
                                      attention_mask, self.cfg,
                                      kv_caches=kv_caches)
