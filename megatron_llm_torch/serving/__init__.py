"""Continuous-batching serving engine over a paged KV pool (PyTorch).

Layering, as in ``megatron_llm_tpu/serving``: ``kv_blocks`` (host-side
pool bookkeeping and the refcounted prefix cache) -> ``request``
(lifecycle and admission queue) -> ``scheduler`` (slot admission,
prefill/decode interleaving) -> ``engine`` (the background thread and the
device programs).  ``kv_blocks``, ``request``, ``scheduler``,
``cache_observatory``, ``loop_profiler``, ``drafter`` (prompt-lookup
drafts for speculative decoding), ``host_cache`` (the host KV tier),
``resilience`` (the fault injector and the engine watchdog) and
``alerts`` (the SLO sentinel) are copies of the JAX package's host-side
modules with only their imports changed (``resilience`` keeps its own
stack and memory dump).  The HTTP front-end is
``megatron_llm_torch.text_generation_server``.
"""

from megatron_llm_torch.serving.cache_observatory import CacheObservatory
from megatron_llm_torch.serving.engine import EngineConfig, InferenceEngine
from megatron_llm_torch.serving.host_cache import HostKVCache
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
from megatron_llm_torch.serving.resilience import (
    EngineWatchdog,
    ServingFaultInjector,
)
from megatron_llm_torch.serving.scheduler import Scheduler

__all__ = [
    "BlockManager",
    "CacheObservatory",
    "EngineConfig",
    "EngineError",
    "EngineWatchdog",
    "HostKVCache",
    "InferenceEngine",
    "LoopProfiler",
    "NoCapacity",
    "QueueFull",
    "Request",
    "RequestQueue",
    "SamplingParams",
    "Scheduler",
    "ServingFaultInjector",
    "chain_block_digests",
    "derive_num_blocks",
]
