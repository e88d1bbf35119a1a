"""Continuous-batching serving engine over a paged KV pool (PyTorch).

Layering, as in ``megatron_llm_tpu/serving``: ``kv_blocks`` (host-side
pool bookkeeping and the refcounted prefix cache) -> ``request``
(lifecycle and admission queue) -> ``scheduler`` (slot admission,
prefill/decode interleaving) -> ``engine`` (the background thread and the
device programs).  ``kv_blocks``, ``request``, ``scheduler``,
``cache_observatory``, ``loop_profiler``, ``drafter`` (prompt-lookup
drafts for speculative decoding), ``host_cache`` (the host KV tier),
``resilience`` (the fault injector and the engine watchdog) and
``alerts`` (the SLO sentinel), ``router`` (the multi-replica front door)
and ``supervisor`` (the fleet's control loop) are copies of the JAX
package's host-side modules with only their imports changed
(``resilience`` keeps its own stack and memory dump).  The HTTP
front-end is ``megatron_llm_torch.text_generation_server``.
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
    FINISH_NONFINITE,
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
from megatron_llm_torch.serving.router import (
    AllBackendsThrottled,
    Backend,
    NoBackendAvailable,
    ReplicaRouter,
    RouterServer,
)
from megatron_llm_torch.serving.scheduler import Scheduler
from megatron_llm_torch.serving.supervisor import (
    FleetSnapshot,
    FleetSupervisor,
    LocalProcessBackend,
    PolicyConfig,
    ReplicaBackend,
    ReplicaInfo,
    Respawn,
    RouterScaleDown,
    RouterScaleUp,
    RouterTierClient,
    ScaleDown,
    ScaleUp,
    ScalingPolicy,
)

__all__ = [
    "AllBackendsThrottled",
    "Backend",
    "BlockManager",
    "CacheObservatory",
    "EngineConfig",
    "EngineError",
    "EngineWatchdog",
    "FINISH_NONFINITE",
    "FleetSnapshot",
    "FleetSupervisor",
    "HostKVCache",
    "InferenceEngine",
    "LocalProcessBackend",
    "LoopProfiler",
    "NoBackendAvailable",
    "NoCapacity",
    "PolicyConfig",
    "QueueFull",
    "ReplicaBackend",
    "ReplicaInfo",
    "ReplicaRouter",
    "Request",
    "RequestQueue",
    "Respawn",
    "RouterScaleDown",
    "RouterScaleUp",
    "RouterServer",
    "RouterTierClient",
    "SamplingParams",
    "ScaleDown",
    "ScaleUp",
    "ScalingPolicy",
    "Scheduler",
    "ServingFaultInjector",
    "chain_block_digests",
    "derive_num_blocks",
]
