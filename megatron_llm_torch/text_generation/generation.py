"""KV-cache allocation for the serving engine (the counterpart of
``init_paged_kv_caches`` in ``megatron_llm_tpu/text_generation/
generation.py``; the int8 pools are a later slice)."""

from __future__ import annotations

import torch

from megatron_llm_torch.config import TransformerConfig


def init_paged_kv_caches(cfg: TransformerConfig, num_blocks: int,
                         block_size: int, dtype=None, device="cuda",
                         quantized: bool = False):
    """Per-layer page pools ``[num_blocks, block_size, groups, head_dim]``
    in the compute dtype on ``device``, shared by every active request
    through per-slot block tables.  Block 0 is the reserved garbage
    block."""
    if quantized:
        raise NotImplementedError("int8 KV pools are not ported yet")
    dtype = dtype or cfg.compute_torch_dtype
    shape = (num_blocks, block_size, cfg.num_query_groups, cfg.head_dim)
    return [{"k_pages": torch.zeros(shape, dtype=dtype, device=device),
             "v_pages": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.num_layers)]
