"""T5, the encoder-decoder (the counterpart of
``megatron_llm_tpu/models/t5.py``, with its param tree).

The encoder and decoder are two stacks that share one word embedding
and one learned position table; the encoder runs bidirectionally over a
padding mask, the decoder runs causal + padding self-attention and the
cross-attention over the encoder's output (``transformer.py``
``cross_attention``).  Every mask goes through ``core_attention``
(``use_flash_attn=False``)::

  {'embedding': {'word', 'position'},
   'encoder': {'layers': [L, ...], 'final_norm'},
   'decoder': {'layers': [L, ...] (+ inter_attention), 'final_norm'},
   'lm_head': {'bias': [V]}}
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from megatron_llm_torch import random as mrandom
from megatron_llm_torch import topology
from megatron_llm_torch.config import PositionEmbeddingType, TransformerConfig
from megatron_llm_torch.models.language_model import (
    embedding_forward,
    flops_per_token,
    make_generator,
    num_params,
)
from megatron_llm_torch.models.transformer import (
    init_stack_params,
    transformer_stack,
)
from megatron_llm_torch.ops.cross_entropy import vocab_parallel_cross_entropy
from megatron_llm_torch.parallel.layers import (
    init_embedding_params,
    init_method_normal,
    parallel_lm_logits,
)

T5_ARCH_FLAGS = dict(
    position_embedding_type=PositionEmbeddingType.learned_absolute,
    normalization="layernorm",
    glu_activation=None,
    add_bias_linear=True,
    tie_embed_logits=True,
    parallel_attn=False,
    use_flash_attn=False,  # explicit masks go through core attention
)


def t5_config(**overrides) -> TransformerConfig:
    defaults = dict(T5_ARCH_FLAGS)
    defaults.update(overrides)
    return TransformerConfig(**defaults)


def t5_extended_attention_mask(masks):
    """[b, sq, sk] 1 = attend masks -> [b, 1, sq, sk] bool, True = masked
    (the ``< 0.5`` rule).  [b, 1, sq, sk] masks are taken too: bool as
    they are, numeric inverted by the same rule.  None stays None."""
    out = []
    for m in masks:
        if m is None:
            out.append(None)
        elif m.ndim == 3:
            out.append((m < 0.5)[:, None])
        elif m.ndim == 4:
            out.append(m if m.dtype == torch.bool else (m < 0.5))
        else:
            raise ValueError(
                f"T5 attention masks must be [b, sq, sk] (1=attend) or "
                f"[b, 1, sq, sk]; got ndim={m.ndim}")
    return out


def t5_position_ids(token_ids: torch.Tensor) -> torch.Tensor:
    s = token_ids.shape[1]
    return torch.arange(s, device=token_ids.device)[None, :].expand(
        token_ids.shape)


class T5Model:
    def __init__(self, cfg: TransformerConfig, device=None):
        if cfg.num_experts > 1:
            raise NotImplementedError(
                "MoE (num_experts > 1) is only wired for the decoder-only "
                "GPT family")
        topology.refuse_at_tp("T5")
        self.cfg = cfg
        self.device = torch.device(device if device is not None else "cuda")

    def init(self, seed: Union[int, torch.Generator, None] = 0,
             device=None) -> dict:
        """Random params from ``seed`` in ``cfg.params_dtype`` (``seed``
        None with ``device="meta"``: the tree's shapes alone)."""
        cfg = self.cfg
        device = device or self.device
        gen = None if seed is None else make_generator(seed, device)
        dtype = cfg.params_torch_dtype
        init = init_method_normal(cfg.init_method_std)
        return {
            "embedding": {
                "word": init_embedding_params(
                    gen, cfg.padded_vocab_size, cfg.hidden_size,
                    init_method=init, dtype=dtype, device=device),
                "position": init_embedding_params(
                    gen, cfg.max_position_embeddings, cfg.hidden_size,
                    init_method=init, dtype=dtype, device=device),
            },
            "encoder": init_stack_params(gen, cfg, dtype, device, "encoder"),
            "decoder": init_stack_params(gen, cfg, dtype, device, "decoder"),
            "lm_head": {"bias": torch.zeros((cfg.padded_vocab_size,),
                                            dtype=dtype, device=device)},
        }

    def template(self) -> dict:
        return self.init(None, device="meta")

    def num_params(self, params) -> int:
        return num_params(params)

    def flops_per_token(self, seq_len=None) -> float:
        # the encoder and decoder stacks: ~2x one stack of the same depth
        return 2.0 * flops_per_token(self.cfg, seq_len)

    def __call__(self, params, encoder_input_ids: torch.Tensor,
                 decoder_input_ids: Optional[torch.Tensor] = None,
                 encoder_attn_mask: Optional[torch.Tensor] = None,
                 decoder_attn_mask: Optional[torch.Tensor] = None,
                 encoder_decoder_attn_mask: Optional[torch.Tensor] = None,
                 *, tokentype_ids: Optional[torch.Tensor] = None,
                 lm_labels: Optional[torch.Tensor] = None,
                 labels: Optional[torch.Tensor] = None,
                 rng_key: Optional[int] = None, train: bool = False):
        """Masks: [b, sq, sk] with 1 = attend (the T5 dataset's).  Returns
        the per-token loss [b, s_dec] with ``lm_labels`` (or ``labels``,
        the train step's name), else the logits [b, s_dec, V]."""
        cfg = self.cfg
        if lm_labels is None:
            lm_labels = labels
        if decoder_input_ids is None:
            raise ValueError("T5Model needs decoder_input_ids in the batch")
        enc_mask, dec_mask, enc_dec_mask = t5_extended_attention_mask(
            [encoder_attn_mask, decoder_attn_mask,
             encoder_decoder_attn_mask])
        k_enc_emb, k_enc, k_dec_emb, k_dec = (
            mrandom.split(rng_key, 4) if rng_key is not None
            else (None,) * 4)
        enc_h = embedding_forward(
            encoder_input_ids, t5_position_ids(encoder_input_ids),
            params["embedding"], cfg, tokentype_ids=tokentype_ids,
            rng_key=k_enc_emb, train=train)
        if enc_mask is None:
            s = encoder_input_ids.shape[1]
            enc_mask = torch.zeros((1, 1, s, s), dtype=torch.bool,
                                   device=encoder_input_ids.device)
        enc_out = transformer_stack(enc_h, params["encoder"], cfg,
                                    attention_mask=enc_mask, rng_key=k_enc,
                                    train=train)
        dec_h = embedding_forward(
            decoder_input_ids, t5_position_ids(decoder_input_ids),
            params["embedding"], cfg, rng_key=k_dec_emb, train=train)
        dec_out = transformer_stack(dec_h, params["decoder"], cfg,
                                    attention_mask=dec_mask, rng_key=k_dec,
                                    train=train, encoder_output=enc_out,
                                    enc_dec_mask=enc_dec_mask)
        logits = parallel_lm_logits(dec_out,
                                    params["embedding"]["word"]["embedding"],
                                    compute_dtype=cfg.compute_torch_dtype)
        logits = logits + params["lm_head"]["bias"].to(logits.dtype)
        if lm_labels is None:
            return logits
        return vocab_parallel_cross_entropy(logits.float(), lm_labels)
