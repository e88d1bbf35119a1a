"""The run's host-side counters (the counters of
``megatron_llm_tpu/global_vars.py``).

One process-wide ``defaultdict(int)``: the loop's ``tokens`` and
``samples``, the recovery counters (``rewinds``, ``save_retries``,
``watchdog_fires``, ``signal_saves``) and the tracer's ``recompiles``
and ``straggler_events``.  The JAX module's other singletons (args,
timers, tokenizer, writers, the micro-batch calculator) are not used by
the port.
"""

from __future__ import annotations

from collections import defaultdict

_GLOBAL_COUNTERS: "defaultdict[str, int]" = defaultdict(int)


def get_counters():
    return _GLOBAL_COUNTERS


def reset_counters() -> None:
    _GLOBAL_COUNTERS.clear()
