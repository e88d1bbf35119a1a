"""Sequence classification and multiple-choice heads on a BERT trunk (the
counterpart of ``megatron_llm_tpu/models/classification.py``): the BERT
language model, the pooler, dropout and a dense head; multiple choice
flattens [b, num_choices, s] into the batch and scores each choice."""

from __future__ import annotations

from typing import Optional, Union

import torch

from megatron_llm_torch import random as mrandom
from megatron_llm_torch import topology
from megatron_llm_torch.config import TransformerConfig
from megatron_llm_torch.models.bert import (
    bert_extended_attention_mask,
    bert_position_ids,
    init_pooler_params,
    pooler,
)
from megatron_llm_torch.models.language_model import (
    init_language_model_params,
    language_model_forward,
    make_generator,
    num_params,
)
from megatron_llm_torch.models.transformer import _dropout
from megatron_llm_torch.ops.cross_entropy import dense_cross_entropy
from megatron_llm_torch.parallel.layers import (
    column_parallel_linear,
    init_linear_params,
    init_method_normal,
)


class ClassificationModel:
    """BERT trunk + pooler + a ``num_classes`` head."""

    def __init__(self, cfg: TransformerConfig, num_classes: int,
                 device=None):
        if cfg.num_experts > 1:
            raise NotImplementedError(
                "MoE (num_experts > 1) is only wired for the decoder-only "
                "GPT family")
        topology.refuse_at_tp("the classification heads")
        self.cfg = cfg
        self.num_classes = num_classes
        self.device = torch.device(device if device is not None else "cuda")

    def init(self, seed: Union[int, torch.Generator, None] = 0,
             device=None) -> dict:
        device = device or self.device
        gen = None if seed is None else make_generator(seed, device)
        dtype = self.cfg.params_torch_dtype
        params = init_language_model_params(gen, self.cfg, device=device)
        params["pooler"] = init_pooler_params(gen, self.cfg, dtype, device)
        params["classification_head"] = init_linear_params(
            gen, self.cfg.hidden_size, self.num_classes, bias=True,
            init_method=init_method_normal(self.cfg.init_method_std),
            dtype=dtype, device=device)
        return params

    def template(self) -> dict:
        return self.init(None, device="meta")

    def num_params(self, params) -> int:
        return num_params(params)

    def _trunk(self, params, tokens, attention_mask, tokentype_ids,
               rng_key, train):
        if attention_mask is None:
            attention_mask = torch.ones(tokens.shape, dtype=torch.int32,
                                        device=tokens.device)
        hidden = language_model_forward(
            params, tokens, bert_position_ids(tokens),
            bert_extended_attention_mask(attention_mask), self.cfg,
            tokentype_ids=tokentype_ids, rng_key=rng_key, train=train,
            compute_logits=False)
        return pooler(hidden, params["pooler"])

    def __call__(self, params, tokens: torch.Tensor,
                 attention_mask: Optional[torch.Tensor] = None,
                 labels: Optional[torch.Tensor] = None, *,
                 tokentype_ids: Optional[torch.Tensor] = None,
                 rng_key: Optional[int] = None, train: bool = False,
                 **_unused):
        """Per-example CE loss [b] with ``labels``, else logits [b,
        num_classes]."""
        k_drop = None
        if rng_key is not None:
            rng_key, k_drop = mrandom.split(rng_key)
        pooled = self._trunk(params, tokens, attention_mask, tokentype_ids,
                             rng_key, train)
        pooled = _dropout(pooled, self.cfg.hidden_dropout, k_drop, train)
        logits = column_parallel_linear(pooled,
                                        params["classification_head"],
                                        compute_dtype=pooled.dtype)
        if labels is None:
            return logits
        return dense_cross_entropy(logits, labels)


class MultipleChoiceModel(ClassificationModel):
    """[b, num_choices, s] inputs scored per choice by a 1-logit head."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__(cfg, num_classes=1, device=device)

    def __call__(self, params, tokens: torch.Tensor,
                 attention_mask: Optional[torch.Tensor] = None,
                 labels: Optional[torch.Tensor] = None, *,
                 tokentype_ids: Optional[torch.Tensor] = None,
                 rng_key: Optional[int] = None, train: bool = False,
                 **_unused):
        b, nc, s = tokens.shape

        def flat(x):
            return None if x is None else x.reshape(b * nc, s)

        logits = super().__call__(
            params, flat(tokens), flat(attention_mask), None,
            tokentype_ids=flat(tokentype_ids), rng_key=rng_key,
            train=train)
        logits = logits.reshape(b, nc)
        if labels is None:
            return logits
        return dense_cross_entropy(logits, labels)
