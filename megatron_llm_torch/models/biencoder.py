"""The biencoder (query and context BERT towers) for ICT and REALM-style
retrieval (the counterpart of ``megatron_llm_tpu/models/biencoder.py``):
two towers, or one shared, each pooling the [CLS] position, with an
optional linear projection to ``projection_dim``; and the in-batch
softmax retrieval loss with its top-k accuracies."""

from __future__ import annotations

from typing import Optional, Union

import torch

from megatron_llm_torch import random as mrandom
from megatron_llm_torch import topology
from megatron_llm_torch.config import TransformerConfig
from megatron_llm_torch.models.bert import (
    bert_extended_attention_mask,
    bert_position_ids,
)
from megatron_llm_torch.models.language_model import (
    init_language_model_params,
    language_model_forward,
    make_generator,
    num_params,
)
from megatron_llm_torch.parallel.layers import (
    column_parallel_linear,
    init_linear_params,
    init_method_normal,
)


class BiEncoderModel:
    """``params``: {"query": <tower>, "context": <tower>} or {"shared":
    <tower>} under ``shared_query_context``; a tower is the language
    model's tree, with a "projection" linear when ``projection_dim``."""

    def __init__(self, cfg: TransformerConfig, projection_dim: int = 0,
                 shared_query_context: bool = False,
                 only_query: bool = False, only_context: bool = False,
                 device=None):
        assert not (only_query and only_context)
        if cfg.num_experts > 1:
            raise NotImplementedError(
                "MoE (num_experts > 1) is only wired for the decoder-only "
                "GPT family")
        topology.refuse_at_tp("the biencoder (ICT)")
        self.cfg = cfg
        self.projection_dim = projection_dim
        self.shared = shared_query_context
        self.use_query = not only_context
        self.use_context = not only_query
        self.device = torch.device(device if device is not None else "cuda")

    def _init_tower(self, gen, device):
        tower = init_language_model_params(gen, self.cfg, device=device)
        if self.projection_dim > 0:
            tower["projection"] = init_linear_params(
                gen, self.cfg.hidden_size, self.projection_dim, bias=True,
                init_method=init_method_normal(self.cfg.init_method_std),
                dtype=self.cfg.params_torch_dtype, device=device)
        return tower

    def init(self, seed: Union[int, torch.Generator, None] = 0,
             device=None) -> dict:
        device = device or self.device
        gen = None if seed is None else make_generator(seed, device)
        if self.shared:
            return {"shared": self._init_tower(gen, device)}
        out = {}
        if self.use_query:
            out["query"] = self._init_tower(gen, device)
        if self.use_context:
            out["context"] = self._init_tower(gen, device)
        return out

    def template(self) -> dict:
        return self.init(None, device="meta")

    def num_params(self, params) -> int:
        return num_params(params)

    def _embed(self, tower, tokens, pad_mask, tokentype_ids, rng_key, train):
        hidden = language_model_forward(
            tower, tokens, bert_position_ids(tokens),
            bert_extended_attention_mask(pad_mask), self.cfg,
            tokentype_ids=tokentype_ids, rng_key=rng_key, train=train,
            compute_logits=False)
        pooled = hidden[:, 0, :]
        if "projection" in tower:
            pooled = column_parallel_linear(pooled, tower["projection"],
                                            compute_dtype=pooled.dtype)
        return pooled

    def embed_query(self, params, tokens, pad_mask, *, tokentype_ids=None,
                    rng_key=None, train=False):
        assert self.use_query
        tower = params["shared"] if self.shared else params["query"]
        return self._embed(tower, tokens, pad_mask, tokentype_ids, rng_key,
                           train)

    def embed_context(self, params, tokens, pad_mask, *, tokentype_ids=None,
                      rng_key=None, train=False):
        assert self.use_context
        tower = params["shared"] if self.shared else params["context"]
        return self._embed(tower, tokens, pad_mask, tokentype_ids, rng_key,
                           train)

    def __call__(self, params, query_tokens, query_pad_mask, context_tokens,
                 context_pad_mask, *, rng_key: Optional[int] = None,
                 train: bool = False):
        """(query embeddings [b, d], context embeddings [b, d])."""
        kq, kc = (mrandom.split(rng_key) if rng_key is not None
                  else (None, None))
        q = self.embed_query(params, query_tokens, query_pad_mask,
                             rng_key=kq, train=train)
        c = self.embed_context(params, context_tokens, context_pad_mask,
                               rng_key=kc, train=train)
        return q, c


def ict_retrieval_loss(query_logits: torch.Tensor,
                       context_logits: torch.Tensor, *,
                       score_scaling: bool = False,
                       hidden_size: Optional[int] = None,
                       topk: tuple = (1, 5)):
    """The in-batch softmax retrieval loss over the batch's [B, B] scores
    and the top-k accuracies (%) of the true (diagonal) context."""
    scores = query_logits @ context_logits.t()
    if score_scaling:
        # an fp32 divisor, as in the JAX package: bf16 scores widen
        assert hidden_size is not None
        scores = scores.float() / torch.tensor(
            float(hidden_size), dtype=torch.float32).sqrt().item()
    scores = scores.float()
    logp = torch.log_softmax(scores, dim=1)
    diag = torch.arange(scores.shape[0], device=scores.device)
    loss = -logp[diag, diag].mean()
    rank = (scores > scores[diag, diag][:, None]).sum(dim=1)
    stats = {f"top{k}_acc": (rank < k).float().mean() * 100.0 for k in topk}
    return loss, stats
