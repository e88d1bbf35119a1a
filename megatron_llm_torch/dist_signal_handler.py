"""Signal-coordinated checkpoint-and-exit on SIGTERM and SIGINT (the
counterpart of ``megatron_llm_tpu/dist_signal_handler.py``).

The handler sets a flag; the train loop polls it after each iteration
and, when it is set, saves a checkpoint and exits.  The port trains in
one process, so ``signals_received`` reads the local flag with or
without ``consensus`` and gathers nothing.
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
        """Whether to stop for a signal: the local flag (one process, so
        ``consensus`` changes nothing)."""
        return self._received
