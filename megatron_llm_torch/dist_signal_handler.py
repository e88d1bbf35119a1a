"""Signal-coordinated checkpoint-and-exit on SIGTERM and SIGINT (the
counterpart of ``megatron_llm_tpu/dist_signal_handler.py``).

The handler sets a flag; the train loop polls it after each iteration
and, when it is set, saves a checkpoint and exits.  In one process
``signals_received`` reads the local flag.  In a world of ranks (tp x
dp under torchrun) no rank acts alone: without ``consensus`` the answer
is False, and with it the flag is max-reduced over the world, as the
JAX package reduces it over hosts, so every rank enters the save's
collectives together.
"""

from __future__ import annotations

import signal


class DistributedSignalHandler:
    """Installs handlers for preemption-style signals.  SIGTERM is what
    cluster schedulers send ahead of eviction; SIGINT makes ctrl-C on an
    interactive run take the same graceful save-and-exit path."""

    def __init__(self, sig=(signal.SIGTERM, signal.SIGINT)):
        self.sigs = tuple(sig) if isinstance(sig, (tuple, list)) else (sig,)
        self._received = False
        self._prev = {}

    def __enter__(self):
        for s in self.sigs:
            self._prev[s] = signal.getsignal(s)
            signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            if prev is not None:
                signal.signal(s, prev)
        self._prev = {}
        return False

    def install(self):
        return self.__enter__()

    def _handler(self, signum, frame):
        self._received = True

    def signals_received(self, consensus: bool = False) -> bool:
        """Whether to stop for a signal.  ``consensus=False``: the local
        flag in one process, False in a world of ranks.
        ``consensus=True``: the flag max-reduced over the world (a
        collective: call it only where every rank is in lockstep, the
        train loop's log and save boundaries)."""
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()) \
                or dist.get_world_size() == 1:
            return self._received
        if not consensus:
            return False
        import torch

        from megatron_llm_torch.parallel import mappings

        world = dist.group.WORLD
        dev = "cuda" if dist.get_backend(world) == "nccl" else "cpu"
        flag = torch.tensor(1.0 if self._received else 0.0, device=dev)
        return bool(mappings.collective("all_reduce", flag, world,
                                        reduce="max") > 0)
