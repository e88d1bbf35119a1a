"""Continuous-batching serving engine over a paged KV pool (PyTorch).

Layering, as in ``megatron_llm_tpu/serving``: ``kv_blocks`` (host-side
pool bookkeeping and the refcounted prefix cache) -> ``request``
(lifecycle and admission queue) -> ``scheduler`` (slot admission,
prefill/decode interleaving) -> ``engine`` (the background thread and the
device programs).  ``kv_blocks``, ``request``, ``scheduler``,
``cache_observatory`` and ``loop_profiler`` are copies of the JAX
package's host-side modules with only their imports changed.  The HTTP
front-end is ``megatron_llm_torch.text_generation_server``.
"""

from megatron_llm_torch.serving.cache_observatory import CacheObservatory
from megatron_llm_torch.serving.engine import EngineConfig, InferenceEngine
from megatron_llm_torch.serving.kv_blocks import (
    BlockManager,
    NoCapacity,
    chain_block_digests,
    derive_num_blocks,
)
from megatron_llm_torch.serving.loop_profiler import LoopProfiler
from megatron_llm_torch.serving.request import (
    EngineError,
    QueueFull,
    Request,
    RequestQueue,
    SamplingParams,
)
from megatron_llm_torch.serving.scheduler import Scheduler

__all__ = [
    "BlockManager",
    "CacheObservatory",
    "EngineConfig",
    "EngineError",
    "InferenceEngine",
    "LoopProfiler",
    "NoCapacity",
    "QueueFull",
    "Request",
    "RequestQueue",
    "SamplingParams",
    "Scheduler",
    "chain_block_digests",
    "derive_num_blocks",
]
