"""Hierarchical timers with log levels (the single-host part of
``megatron_llm_tpu/timers.py``): a registry of named timers with
per-timer log levels (0-2), optional synchronised start/stop, and the
``--timing_log_option`` (``max``/``minmax``/``all``) formats.

PyTorch launches work on the card asynchronously, so a wall-clock timer
sees only the enqueue unless it waits: ``Timer.stop(barrier=True)``
synchronises the current CUDA device (the JAX package calls
``jax.effects_barrier()``).  One host runs the port's training slice, so
the cross-host gather returns one value per name; multi-host timing
comes with the parallelism slice.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

_LOG_OPTIONS = ("max", "minmax", "all")


def _barrier() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def gather_across_hosts(elapsed: Dict[str, float]) -> Dict[str, List[float]]:
    """Per-name list of per-host values; one host: one-element lists."""
    return {n: [v] for n, v in elapsed.items()}


class Timer:
    def __init__(self, name: str):
        self.name = name
        self._elapsed = 0.0
        self._started = False
        self._start_time = 0.0
        self._count = 0

    def start(self, barrier: bool = False):
        if self._started:
            raise RuntimeError(f"timer {self.name} has already been started")
        if barrier:
            _barrier()
        self._start_time = time.perf_counter()
        self._started = True

    def stop(self, barrier: bool = False):
        if not self._started:
            raise RuntimeError(f"timer {self.name} is not started")
        if barrier:
            _barrier()
        self._elapsed += time.perf_counter() - self._start_time
        self._count += 1
        self._started = False

    def reset(self):
        self._elapsed = 0.0
        self._count = 0

    def elapsed(self, reset: bool = True) -> float:
        started = self._started
        if started:
            self.stop()
        elapsed = self._elapsed
        if reset:
            self.reset()
        if started:
            self.start()
        return elapsed

    @property
    def count(self) -> int:
        return self._count


class _DummyTimer:
    """Returned for timers above the configured log level (reference:
    timers.py:107-121)."""

    def start(self, barrier=False):
        pass

    def stop(self, barrier=False):
        pass

    def reset(self):
        pass

    def elapsed(self, reset=True):
        raise RuntimeError("elapsed() on a dummy timer")


class Timers:
    """Reference: timers.py:123-303."""

    def __init__(self, log_level: int = 0, log_option: str = "minmax"):
        if log_option not in _LOG_OPTIONS:
            raise ValueError(
                f"log_option {log_option!r} not in {_LOG_OPTIONS}")
        self._log_level = log_level
        self._log_option = log_option
        self._timers: Dict[str, Timer] = {}
        self._log_levels: Dict[str, int] = {}
        self._dummy = _DummyTimer()
        self._max_log_level = 2

    def __call__(self, name: str, log_level: Optional[int] = None):
        if name in self._timers:
            return self._timers[name]
        if log_level is None:
            log_level = self._max_log_level
        if log_level > self._log_level:
            return self._dummy
        t = Timer(name)
        self._timers[name] = t
        self._log_levels[name] = log_level
        return t

    def names(self) -> List[str]:
        return list(self._timers)

    def get_elapsed(self, names=None, reset=True,
                    normalizer=1.0) -> Dict[str, float]:
        if names is None:
            names = self.names()
        out = {}
        for n in names:
            if n in self._timers:
                out[n] = self._timers[n].elapsed(reset=reset) / normalizer
        return out

    # -- cross-host reduction -------------------------------------------

    def _gather_across_hosts(
            self, elapsed: Dict[str, float]) -> Dict[str, List[float]]:
        return gather_across_hosts(elapsed)

    # -- formatting per --timing_log_option -----------------------------

    def _header(self) -> str:
        # every variant keeps the literal "time (ms)" so greppability (and
        # downstream log parsers) survive the option switch
        if self._log_option == "minmax":
            return "(min, max) time (ms)"
        if self._log_option == "max":
            return "max time (ms)"
        return "time (ms) across hosts"

    def _format_entry(self, values: List[float]) -> str:
        ms = [v * 1000.0 for v in values]
        if len(ms) == 1:
            # single host: every option degenerates to the plain value
            return f"{ms[0]:.2f}"
        if self._log_option == "minmax":
            return f"({min(ms):.2f}, {max(ms):.2f})"
        if self._log_option == "max":
            return f"{max(ms):.2f}"
        return "[" + ", ".join(f"{m:.2f}" for m in ms) + "]"

    def _format_line(self, gathered: Dict[str, List[float]]) -> str:
        string = self._header()
        for n, values in gathered.items():
            string += f" | {n}: {self._format_entry(values)}"
        return string

    def _write_gathered(self, gathered: Dict[str, List[float]],
                        writer, iteration: int):
        for n, values in gathered.items():
            if len(values) == 1:
                writer.add_scalar(f"{n}-time", values[0], iteration)
            elif self._log_option == "minmax":
                writer.add_scalar(f"{n}-time-min", min(values), iteration)
                writer.add_scalar(f"{n}-time-max", max(values), iteration)
            elif self._log_option == "max":
                writer.add_scalar(f"{n}-time-max", max(values), iteration)
            else:
                for r, v in enumerate(values):
                    writer.add_scalar(f"{n}-time/host{r}", v, iteration)

    # -- public reporting -----------------------------------------------

    def log(self, names=None, normalizer=1.0, reset=True, printer=print):
        elapsed = self.get_elapsed(names, reset=reset, normalizer=normalizer)
        if not elapsed:
            return
        printer(self._format_line(self._gather_across_hosts(elapsed)))

    def write(self, names, writer, iteration, normalizer=1.0, reset=False):
        """Write timer values to a tensorboard-like writer
        (reference: timers.py:264-303)."""
        elapsed = self.get_elapsed(names, reset=reset, normalizer=normalizer)
        self._write_gathered(self._gather_across_hosts(elapsed),
                             writer, iteration)

    def report(self, writer=None, iteration: int = 0, normalizer: float = 1.0,
               names=None, printer=print):
        """Write + log from ONE elapsed snapshot, then reset.

        ``write()``-then-``log()`` is order-fragile: ``log(reset=True)``
        zeroes the accumulators, so a caller that logs first writes zeros
        (and writing first then logging reads each timer twice).  One
        snapshot feeds both sinks; the cross-host gather also happens once
        instead of twice.

        Returns the gathered per-host snapshot ({name: [secs per host]},
        already normalized) so the caller can reuse the allgather — the
        straggler detector feeds on exactly this."""
        elapsed = self.get_elapsed(names, reset=True, normalizer=normalizer)
        if not elapsed:
            return {}
        gathered = self._gather_across_hosts(elapsed)
        if writer is not None:
            self._write_gathered(gathered, writer, iteration)
        printer(self._format_line(gathered))
        return gathered
