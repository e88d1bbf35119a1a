"""KV-cache allocation for the serving engine (the counterpart of
``init_paged_kv_caches`` in ``megatron_llm_tpu/text_generation/
generation.py``)."""

from __future__ import annotations

import torch

from megatron_llm_torch.config import TransformerConfig


def init_paged_kv_caches(cfg: TransformerConfig, num_blocks: int,
                         block_size: int, dtype=None, device="cuda",
                         quantized: bool = False):
    """Per-layer page pools ``[num_blocks, block_size, groups, head_dim]``
    on ``device``, shared by every active request through per-slot block
    tables: ``k_pages`` / ``v_pages`` in the compute dtype, or, when
    ``quantized``, int8 ``k_pages_q`` / ``v_pages_q`` with fp32 absmax
    scales ``k_pages_scale`` / ``v_pages_scale`` ``[num_blocks, block_size,
    groups]`` (ones until written).  Block 0 is the reserved garbage
    block."""
    dtype = dtype or cfg.compute_torch_dtype
    shape = (num_blocks, block_size, cfg.num_query_groups, cfg.head_dim)
    if quantized:
        return [{"k_pages_q": torch.zeros(shape, dtype=torch.int8,
                                          device=device),
                 "k_pages_scale": torch.ones(shape[:3], dtype=torch.float32,
                                             device=device),
                 "v_pages_q": torch.zeros(shape, dtype=torch.int8,
                                          device=device),
                 "v_pages_scale": torch.ones(shape[:3], dtype=torch.float32,
                                             device=device)}
                for _ in range(cfg.num_layers)]
    return [{"k_pages": torch.zeros(shape, dtype=dtype, device=device),
             "v_pages": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.num_layers)]
