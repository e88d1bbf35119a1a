"""Fault-tolerant training runtime: step sentinel & rewind, hang watchdog,
deterministic fault injection (the counterpart of
``megatron_llm_tpu/resilience.py``).

Motivation (MegaScale, arXiv:2402.15627 §3-4): at pod scale the dominant
goodput losses are loss blow-ups, flaky storage, silent hangs, and
preemption — and the recovery has to live *in the framework*, not in an
operator's terminal.  The reference Megatron-LM only handles the easy half
(fp16 loss-scale skip inside the step, arXiv:2104.04473); everything here
is the other half, wrapped around the train step:

* **StepSentinel / rewind** (``ResilienceManager``): the train loop inspects
  ``lm loss`` / ``grad_norm`` at check boundaries for non-finite values
  and configurable spikes (loss > ``spike_factor`` x EMA), keeps a rolling
  in-host-memory snapshot of ``(params, opt_state, iteration, scheduler)``
  every ``snapshot_interval`` iterations, and after ``patience``
  consecutive bad steps rewinds to the snapshot — optionally shrinking the
  LR (``rewind_lr_factor``).  The RNG stream needs no special handling:
  step keys are folded from the iteration number, so restoring the
  iteration restores the stream.  The data window that produced the blow-up
  is naturally skipped — the batch iterator keeps moving forward, so the
  replayed iterations see fresh data (``skip_data_batches`` can widen the
  skip for iteration-keyed samplers).

* **HangWatchdog**: a daemon thread armed around the train step.  If no
  iteration completes within ``timeout_secs`` it dumps Python stacks for
  every thread plus the CUDA allocator's counters, writes a *rescue
  checkpoint* from the latest host snapshot, and optionally hard-exits
  (``os._exit``) so the scheduler restarts the job from the rescue
  checkpoint.  The watchdog thread makes no CUDA call: the main thread
  may be wedged behind a stream, the snapshot is host memory, and the
  allocator's counters never synchronize.

The port's optimizer updates params, masters and moments *in place*, so a
snapshot cannot keep references (and on the CPU ``t.cpu()`` returns the
live tensor itself): ``take_snapshot`` copies every leaf with ``copy_``
into host buffers allocated once (pinned when the leaf is on the card)
and waits for the copies, and ``rewind`` copies them back with ``copy_``
into the very tensors the model and the optimizer hold.  A snapshot
being written is no rescue target: the watchdog finds none until the
copy is done.

At tp x dp above 1 (the train step's ``TensorParallelPlan``) each rank
snapshots its own pieces for the rewind, and the ranks agree on the
finite check; when a rescue is bound, the snapshot also gathers the
one-device tree into rank 0's host memory (``checkpointing.
gather_one_layout``), at the step boundary where every rank is live, as
the JAX package's snapshot is host numpy of the global arrays.  The
rescue save then writes it from rank 0 with no collective, so a hung
rank's watchdog never enters one; the other ranks' watchdogs write
nothing.

* **FaultInjector**: a deterministic chaos hook (flag- or env-driven,
  ``--fault_inject`` / ``MEGATRON_FAULT_INJECT``) that can poison the
  gradients of iteration i with NaN (by NaN-ing the loss mask — the NaN
  flows through loss -> grads exactly like a real blow-up), raise
  transient IOError on the first M checkpoint-save attempts, stall a step
  past the watchdog timeout, and deliver a real SIGTERM — used by the
  tests to prove every recovery path end-to-end.

Recovery counters (``rewinds``, ``save_retries``, ``watchdog_fires``,
``signal_saves``) accumulate in the global counters dict
(``global_vars.get_counters``) and surface in the training log, the
TB/W&B writer, and ``bench.py`` artifacts.
"""

from __future__ import annotations

import json
import math
import os
import signal
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from megatron_llm_torch.global_vars import get_counters
from megatron_llm_torch.optimizer.optimizer import OptimizerState
from megatron_llm_torch.tree import tree_leaves, tree_unflatten

# counter keys, in the order reports list them
RECOVERY_COUNTER_KEYS = (
    "rewinds", "save_retries", "watchdog_fires", "signal_saves")

# Fleet restart-me exit code, shared between the hang watchdog's hard
# exit and the multi-slice preemption rescue (multislice.py): a SIGTERM
# on any one slice reaches every host through the boundary consensus in
# DistributedSignalHandler.signals_received(consensus=True), the train
# loop writes a rescue checkpoint, and the whole fleet exits with this
# code so the supervisor restarts it — possibly at a different
# dp x slice shape (elastic resume).  Single-job runs keep exit 0
# (--preempt_exit_code overrides either way).
PREEMPT_EXIT_CODE = 17


def recovery_counters() -> Dict[str, int]:
    """The recovery counters as plain ints (zeros when nothing fired)."""
    c = get_counters()
    return {k: int(c.get(k, 0)) for k in RECOVERY_COUNTER_KEYS}


# ---------------------------------------------------------------------------
# Fault injection
# ---------------------------------------------------------------------------

@dataclass
class FaultInjector:
    """Deterministic chaos hook for the resilience paths.

    Spec grammar (comma-separated tokens, ``--fault_inject`` or the
    ``MEGATRON_FAULT_INJECT`` env var)::

        nan@I          poison iteration I's gradients with NaN
        save_io*M      first M save attempts raise a transient IOError
        hang@I:S       stall S seconds before dispatching iteration I
        sigterm@I      deliver SIGTERM to this process before iteration I

    e.g. ``nan@3,save_io*2,sigterm@6``.  All triggers are keyed on the
    1-based iteration about to run, so a given spec reproduces exactly.
    Each trigger fires once: a rewound run replays iteration numbers, and
    re-poisoning the replay would turn one injected fault into an
    unrecoverable loop.
    """

    nan_iters: set = field(default_factory=set)
    save_io_failures: int = 0
    hang_at: Optional[int] = None
    hang_secs: float = 0.0
    sigterm_at: Optional[int] = None

    @classmethod
    def from_spec(cls, spec: Optional[str]) -> Optional["FaultInjector"]:
        if not spec:
            return None
        nan_iters, save_io, hang_at, hang_secs, sigterm_at = \
            set(), 0, None, 0.0, None
        for tok in spec.split(","):
            tok = tok.strip()
            if not tok:
                continue
            if tok.startswith("nan@"):
                nan_iters.add(int(tok[4:]))
            elif tok.startswith("save_io*"):
                save_io = int(tok[8:])
            elif tok.startswith("hang@"):
                it, _, secs = tok[5:].partition(":")
                hang_at, hang_secs = int(it), float(secs or "1.0")
            elif tok.startswith("sigterm@"):
                sigterm_at = int(tok[8:])
            else:
                raise ValueError(f"unknown fault_inject token {tok!r} "
                                 f"(grammar: nan@I, save_io*M, hang@I:S, "
                                 f"sigterm@I)")
        return cls(nan_iters=set(nan_iters), save_io_failures=save_io,
                   hang_at=hang_at, hang_secs=hang_secs,
                   sigterm_at=sigterm_at)

    def __bool__(self) -> bool:
        return bool(self.nan_iters or self.save_io_failures
                    or self.hang_at is not None
                    or self.sigterm_at is not None)

    # -- train-loop hooks -------------------------------------------------------

    def before_iteration(self, iteration: int) -> None:
        """Called with the 1-based iteration about to run, before the batch
        is fetched: stalls (watchdog chaos) and signal delivery."""
        if self.hang_at == iteration and self.hang_secs > 0:
            self.hang_at = None
            print(f" [fault-inject] stalling {self.hang_secs:.2f}s before "
                  f"iteration {iteration}", flush=True)
            time.sleep(self.hang_secs)
        if self.sigterm_at == iteration:
            self.sigterm_at = None
            print(f" [fault-inject] delivering SIGTERM before iteration "
                  f"{iteration}", flush=True)
            os.kill(os.getpid(), signal.SIGTERM)

    def poison_batch(self, iteration: int, batch: dict) -> dict:
        """NaN the loss mask for a poisoned iteration: the NaN flows through
        loss -> grads, indistinguishable from a genuine blow-up."""
        if iteration not in self.nan_iters:
            return batch
        self.nan_iters.discard(iteration)
        print(f" [fault-inject] poisoning iteration {iteration} with NaN "
              f"gradients", flush=True)
        batch = dict(batch)
        batch["loss_mask"] = batch["loss_mask"] * float("nan")
        return batch

    def maybe_fail_save(self) -> None:
        """Transient-storage chaos: raises IOError while the failure budget
        lasts (checkpointing's retry loop calls this per attempt)."""
        if self.save_io_failures > 0:
            self.save_io_failures -= 1
            raise IOError("[fault-inject] transient checkpoint IO failure "
                          f"({self.save_io_failures} more to come)")


# The save-attempt hook checkpointing.py consults; installed by
# ResilienceManager (or a test) so checkpointing never imports this module.
_SAVE_FAULT_HOOK: Optional[Callable[[], None]] = None


def set_save_fault_hook(hook: Optional[Callable[[], None]]) -> None:
    global _SAVE_FAULT_HOOK
    _SAVE_FAULT_HOOK = hook


def get_save_fault_hook() -> Optional[Callable[[], None]]:
    return _SAVE_FAULT_HOOK


# ---------------------------------------------------------------------------
# Hang watchdog
# ---------------------------------------------------------------------------

def dump_stacks_and_memory(printer: Callable[[str], None] = print) -> str:
    """Python stacks for every thread + each card's allocator counters
    (``telemetry.device_memory_stats``: no CUDA synchronize, safe from a
    watchdog thread while the main thread is wedged).  Returns the dump
    as a string (also sent through ``printer``)."""
    lines = ["==== watchdog: python stacks ===="]
    # shared all-thread stack capture (telemetry.py): the same report
    # the serving alert engine's postmortem bundles embed, so training
    # and serving forensics read identically
    from megatron_llm_torch import telemetry as _telemetry

    lines.append(_telemetry.capture_thread_stacks())
    lines.append("==== watchdog: device memory ====")
    try:
        n = (torch.cuda.device_count() if torch.cuda.is_initialized()
             else 0)
        for i in range(n):
            stats = _telemetry.device_memory_stats(i)
            lines.append(f"-- cuda:{i} -- bytes_in_use="
                         f"{stats.get('bytes_in_use', 'n/a')} "
                         f"peak_bytes_in_use="
                         f"{stats.get('peak_bytes_in_use', 'n/a')}")
        if n == 0:
            lines.append("-- cpu -- bytes_in_use=n/a peak_bytes_in_use=n/a")
    except Exception as e:       # diagnostics must never raise
        lines.append(f"(device stats unavailable: {e})")
    # flight recorder (telemetry.py): the last K step records tell you what
    # the run was doing when it wedged — MegaScale §5.3 forensics.  Dumped
    # as flight_recorder.json next to the run's JSONL stream AND inlined in
    # the printed report (the file may be unreachable post-mortem).
    try:
        recorder = _telemetry.get_flight_recorder()
        if recorder is not None and len(recorder):
            path = _telemetry.dump_flight_recorder(reason="stack dump")
            lines.append("==== watchdog: flight recorder "
                         f"(last {len(recorder)} records"
                         f"{', dumped to ' + path if path else ''}) ====")
            for rec in recorder.records():
                lines.append(json.dumps(rec))
    except Exception as e:
        lines.append(f"(flight recorder unavailable: {e})")
    # span trace (tracing.py): the Perfetto-loadable timeline of what ran
    # when — written beside the JSONL stream so the post-mortem has the
    # wall-clock story, not just the last K records
    try:
        from megatron_llm_torch import tracing

        tpath = tracing.dump_trace(reason="stack dump")
        if tpath:
            lines.append(f"==== watchdog: span trace dumped to {tpath} ====")
    except Exception as e:
        lines.append(f"(span trace unavailable: {e})")
    dump = "\n".join(lines)
    printer(dump)
    return dump


class HangWatchdog:
    """Daemon thread that fires when no training iteration completes within
    ``timeout_secs``.

    The loop calls ``progress()`` after every dispatch and device sync;
    ``start()`` arms the timer, ``stop()`` disarms it (eval/checkpoint
    phases with their own budgets can ``pause()``/``resume()``).  On fire:
    stack + memory diagnostics, ``counters['watchdog_fires'] += 1``, the
    ``on_fire`` callback (the train loop wires a rescue save of the latest
    host snapshot here), and — with ``hard_exit`` — ``os._exit(17)`` so a
    wedged step becomes a restartable job instead of a dead one.
    """

    EXIT_CODE = PREEMPT_EXIT_CODE

    def __init__(self, timeout_secs: float,
                 on_fire: Optional[Callable[[], None]] = None,
                 hard_exit: bool = False,
                 poll_interval: Optional[float] = None,
                 printer: Callable[[str], None] = print):
        self.timeout_secs = float(timeout_secs)
        self.on_fire = on_fire
        self.hard_exit = hard_exit
        self.poll_interval = poll_interval or max(self.timeout_secs / 4, 0.02)
        self.printer = printer
        self.fired = False
        self.last_dump: Optional[str] = None
        self._last_progress = time.monotonic()
        self._armed = threading.Event()
        self._stopping = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HangWatchdog":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="hang-watchdog", daemon=True)
            self._thread.start()
        self.resume()
        return self

    def progress(self) -> None:
        self._last_progress = time.monotonic()

    def pause(self) -> None:
        self._armed.clear()

    def resume(self) -> None:
        self.progress()
        self._armed.set()

    def stop(self) -> None:
        self._armed.clear()
        self._stopping.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stopping.is_set():
            if self._stopping.wait(self.poll_interval):
                break
            if not self._armed.is_set() or self.fired:
                continue
            stalled = time.monotonic() - self._last_progress
            if stalled > self.timeout_secs:
                self._fire(stalled)

    def _fire(self, stalled: float) -> None:
        self.fired = True
        get_counters()["watchdog_fires"] += 1
        try:
            from megatron_llm_torch import tracing

            tracing.instant("watchdog_fire", "watchdog",
                            stalled_secs=float(stalled),
                            timeout_secs=self.timeout_secs)
        except Exception:
            pass
        self.printer(
            f" [watchdog] no iteration completed in {stalled:.1f}s "
            f"(timeout {self.timeout_secs:.1f}s) — dumping diagnostics")
        try:
            self.last_dump = dump_stacks_and_memory(self.printer)
        except Exception:
            pass
        if self.on_fire is not None:
            try:
                self.on_fire()
            except Exception:
                self.printer(" [watchdog] on_fire callback failed:\n"
                             + traceback.format_exc())
        if self.hard_exit:
            self.printer(f" [watchdog] hard exit {self.EXIT_CODE}: restart "
                         f"resumes from the rescue checkpoint")
            os._exit(self.EXIT_CODE)


# ---------------------------------------------------------------------------
# Step sentinel & rewind
# ---------------------------------------------------------------------------

@dataclass
class ResilienceConfig:
    snapshot_interval: int = 50     # host-snapshot cadence (iterations)
    check_interval: int = 0         # 0 = inspect at log boundaries only
    spike_factor: float = 3.0       # bad if loss > factor * EMA (0 = off)
    spike_ema_beta: float = 0.98    # EMA smoothing for the spike baseline
    patience: int = 1               # consecutive bad checks before rewind
    rewind_lr_factor: float = 1.0   # multiply LR by this on every rewind
    max_rewinds: int = 8            # hard stop against rewind loops
    skip_data_batches: int = 0      # extra batches to discard after rewind


@dataclass
class _Snapshot:
    iteration: int
    params: Any                     # host tensor tree (the buffers)
    opt_state: Any                  # OptimizerState of host trees (or None)
    scheduler_steps: Optional[int]


def _opt_trees(opt_state) -> List[Any]:
    """The param-shaped trees of an OptimizerState (None for absent)."""
    return [opt_state.master_params, opt_state.exp_avg, opt_state.exp_avg_sq]


class ResilienceManager:
    """Orchestrates the sentinel, snapshots, rewind, watchdog and injector
    for one training run.  Nothing here enters the train step: the
    snapshot and the rewind are copies between the live tensors and host
    buffers, made between steps.
    """

    def __init__(self, config: Optional[ResilienceConfig] = None,
                 injector: Optional[FaultInjector] = None,
                 watchdog: Optional[HangWatchdog] = None,
                 rewind_enabled: bool = True):
        self.config = config or ResilienceConfig()
        self.injector = injector
        self.watchdog = watchdog
        self.rewind_enabled = rewind_enabled
        self.lr_scale = 1.0
        self._ema: Optional[float] = None
        self._bad_streak = 0
        self._rewinds = 0
        self._snapshot: Optional[_Snapshot] = None
        # at tp x dp: the plan, and rank 0's one-device host trees of the
        # snapshot (params, optimizer tree) when a rescue is bound
        self._plan = None
        self._rescue_trees = None
        self._rescue_bound = False
        # host buffers, one per leaf of (params, masters, m, v), allocated
        # by the first snapshot and written in place by every later one
        self._buffers: Optional[List[torch.Tensor]] = None
        # latest model-health record (health.to_record shape) + iteration,
        # fed by the train loop when --log_layer_stats_interval is on; lets a
        # rewind name the offending layers instead of just "non-finite loss"
        self._layer_stats: Optional[dict] = None
        self._layer_stats_iteration: Optional[int] = None
        if injector is not None:
            set_save_fault_hook(injector.maybe_fail_save)

    # -- snapshots ----------------------------------------------------------

    def snapshot_due(self, iteration: int) -> bool:
        k = self.config.snapshot_interval
        return (self.rewind_enabled
                and (self._snapshot is None
                     or (k > 0 and iteration % k == 0)))

    def take_snapshot(self, iteration: int, params, opt_state,
                      scheduler=None, plan=None) -> bool:
        """Copy the training state into the host buffers.  Rejected
        (returns False) when any param is non-finite — a snapshot must be
        a known-good rewind target, and detection can lag the blow-up by
        up to a check interval.  The copies are complete when this
        returns: the next step updates the live tensors in place.  At
        tp x dp every rank calls it with the step's ``plan``: the finite
        check is agreed, and a bound rescue gathers the one-device tree
        into rank 0's host memory."""
        if plan is not None:
            self._plan = plan
        live = tree_leaves(params)
        floats = [t for t in live if t.is_floating_point()]
        finite = (torch.stack([torch.isfinite(t).all() for t in floats]
                              ).all().float() if floats else
                  torch.ones((), device=live[0].device) if live else None)
        if finite is not None and self._plan is not None:
            finite = self._plan.all_finite(finite)
        if finite is not None and float(finite) < 1.0:
            print(f" [resilience] refusing snapshot at iteration "
                  f"{iteration}: non-finite parameters", flush=True)
            return False
        trees = [params] + (_opt_trees(opt_state) if opt_state is not None
                            else [])
        live = [t for tree in trees if tree is not None
                for t in tree_leaves(tree)]
        from megatron_llm_torch.checkpointing import copy_to_host

        self._snapshot = None           # no rescue target mid-copy
        self._rescue_trees = None
        if self._plan is not None and self._rescue_bound:
            from megatron_llm_torch.checkpointing import (
                _opt_state_to_tree,
                gather_one_layout,
            )

            p_h, o_h, _ = gather_one_layout(
                self._plan, params, None if opt_state is None else
                _opt_state_to_tree(opt_state))
            self._rescue_trees = None if p_h is None else (p_h, o_h)
        bufs = self._buffers = copy_to_host(live, self._buffers)
        it = iter(bufs)

        def host(tree):
            return (None if tree is None else
                    tree_unflatten(tree, [next(it) for _ in
                                          tree_leaves(tree)]))

        host_params = host(params)
        host_opt = None
        if opt_state is not None:
            m, a, v = (host(t) for t in _opt_trees(opt_state))
            host_opt = OptimizerState(step=opt_state.step, master_params=m,
                                      exp_avg=a, exp_avg_sq=v,
                                      grad_scaler=opt_state.grad_scaler)
        self._snapshot = _Snapshot(
            iteration=iteration,
            params=host_params,
            opt_state=host_opt,
            scheduler_steps=getattr(scheduler, "num_steps", None),
        )
        return True

    @property
    def snapshot_iteration(self) -> Optional[int]:
        return self._snapshot.iteration if self._snapshot else None

    def host_snapshot(self) -> Optional[_Snapshot]:
        return self._snapshot

    # -- sentinel -----------------------------------------------------------

    def check_due(self, iteration: int, at_log_boundary: bool) -> bool:
        ci = self.config.check_interval
        if ci > 0:
            return iteration % ci == 0
        return at_log_boundary

    def record_metrics(self, iteration: int, loss: float,
                       grad_norm: Optional[float] = None) -> bool:
        """Feed one check's observations; returns True when this check is
        *bad* (non-finite, or a spike vs the EMA baseline)."""
        cfg = self.config
        bad = not math.isfinite(loss)
        if grad_norm is not None and not math.isfinite(grad_norm):
            bad = True
        if (not bad and cfg.spike_factor > 0 and self._ema is not None
                and loss > cfg.spike_factor * self._ema):
            bad = True
        if bad:
            self._bad_streak += 1
            print(f" [resilience] bad step at iteration {iteration}: "
                  f"loss={loss:.4g} grad_norm="
                  f"{'n/a' if grad_norm is None else f'{grad_norm:.4g}'} "
                  f"(streak {self._bad_streak}/{cfg.patience})", flush=True)
        else:
            self._bad_streak = 0
            b = cfg.spike_ema_beta
            self._ema = (loss if self._ema is None
                         else b * self._ema + (1.0 - b) * loss)
        return bad

    def observe_layer_stats(self, iteration: int, record: dict,
                            announce: bool = False) -> None:
        """Store the latest per-layer health record (``health.to_record``
        shape).  With ``announce`` (the train loop sets it on a bad check),
        print the offender diagnosis right next to the bad-step line so the
        console names suspects before any rewind happens."""
        self._layer_stats = record
        self._layer_stats_iteration = iteration
        if announce:
            desc = self._offender_summary()
            if desc is not None:
                print(f" [resilience] suspect layers at iteration "
                      f"{iteration}: {desc}", flush=True)

    def _offender_summary(self) -> Optional[str]:
        if self._layer_stats is None:
            return None
        from megatron_llm_torch import health

        return health.describe_offenders(
            health.find_offenders(self._layer_stats))

    def should_rewind(self) -> bool:
        return (self.rewind_enabled
                and self._snapshot is not None
                and self._bad_streak >= self.config.patience)

    def rewind(self, live_params, live_opt_state, scheduler=None,
               batch_iterator=None):
        """Copy the snapshot back into the live tensors (``copy_``: the
        model and the optimizer keep their tensors) and return
        ``(params, opt_state, iteration)``: the live params tree, the
        live optimizer state with the snapshot's step and grad-scaler
        state, and the snapshot's iteration.  The scheduler goes back to
        the snapshot's step; the dropout keys are folded from the
        iteration, so they follow.  LR shrinks by ``rewind_lr_factor``
        (applied by the train loop via ``lr_scale``)."""
        from megatron_llm_torch import tracing

        with tracing.span("rewind", "rewind",
                          target_iteration=(self._snapshot.iteration
                                            if self._snapshot else -1)):
            return self._rewind_impl(live_params, live_opt_state, scheduler,
                                     batch_iterator)

    def _rewind_impl(self, live_params, live_opt_state, scheduler,
                     batch_iterator):
        assert self._snapshot is not None
        self._rewinds += 1
        get_counters()["rewinds"] += 1
        if self._rewinds > self.config.max_rewinds:
            raise RuntimeError(
                f"resilience: exceeded max_rewinds="
                f"{self.config.max_rewinds} — the run cannot make progress "
                f"(persistent blow-up; inspect data/LR)")
        snap = self._snapshot

        def _restore(host_tree, live_tree):
            if host_tree is None or live_tree is None:
                return
            with torch.no_grad():
                for h, t in zip(tree_leaves(host_tree),
                                tree_leaves(live_tree)):
                    t.copy_(h, non_blocking=True)

        _restore(snap.params, live_params)
        params, opt_state = live_params, live_opt_state
        if snap.opt_state is not None and live_opt_state is not None:
            for h, t in zip(_opt_trees(snap.opt_state),
                            _opt_trees(live_opt_state)):
                _restore(h, t)
            opt_state = live_opt_state._replace(
                step=snap.opt_state.step,
                grad_scaler=snap.opt_state.grad_scaler)
        if scheduler is not None and snap.scheduler_steps is not None:
            scheduler.num_steps = snap.scheduler_steps
        self.lr_scale *= self.config.rewind_lr_factor
        self._bad_streak = 0
        self._ema = None            # baseline restarts from the rewound run
        if batch_iterator is not None:
            for _ in range(self.config.skip_data_batches):
                next(batch_iterator)
        suspects = self._offender_summary()
        print(f" [resilience] rewind #{self._rewinds} -> iteration "
              f"{snap.iteration} (lr_scale={self.lr_scale:g}); the "
              f"offending data window is skipped (iterator moves forward)"
              + (f"; suspect layers: {suspects}" if suspects else ""),
              flush=True)
        if self._layer_stats is not None:
            # leave the forensic trail: a "health" record in the flight
            # recorder (carrying the full per-layer stats of the bad step)
            # and a dump whose reason names the suspects
            from megatron_llm_torch import health, telemetry

            fr = telemetry.get_flight_recorder()
            if fr is not None:
                fr.record({
                    "kind": "health",
                    "time_unix": time.time(),
                    "iteration": self._layer_stats_iteration,
                    "rewind": self._rewinds,
                    "offenders": health.find_offenders(self._layer_stats),
                    "layer_stats": self._layer_stats,
                })
            telemetry.dump_flight_recorder(
                reason=f"rewind #{self._rewinds}"
                       + (f": {suspects}" if suspects else ""))
        return params, opt_state, snap.iteration

    # -- watchdog wiring ----------------------------------------------------

    def bind_rescue(self, save_dir: Optional[str], save_args=None) -> None:
        """Point the watchdog's on_fire at a rescue save of the latest host
        snapshot (no-op without a watchdog or save_dir)."""
        if self.watchdog is None or not save_dir:
            return
        if self.watchdog.on_fire is not None:
            return                   # caller installed a custom handler
        self._rescue_bound = True

        def rescue():
            self.save_rescue(save_dir, save_args)

        self.watchdog.on_fire = rescue

    def save_rescue(self, save_dir: str, save_args=None) -> Optional[str]:
        """Write the latest host snapshot as a normal checkpoint (callable
        from the watchdog thread: the snapshot is host memory, so this
        never touches the wedged device stream).  At tp x dp rank 0
        writes its one-device host trees and issues no collective; the
        other ranks write nothing."""
        if self._snapshot is None:
            print(" [resilience] no snapshot to rescue-save", flush=True)
            return None
        from megatron_llm_torch import checkpointing, tracing

        snap = self._snapshot
        if self._plan is not None:
            if self._rescue_trees is None:
                print(" [resilience] the rescue checkpoint is rank 0's to "
                      "write", flush=True)
                return None
            params, opt_tree = self._rescue_trees
            opt_state = (None if opt_tree is None else
                         checkpointing._tree_to_opt_state(opt_tree))
        else:
            params, opt_state = snap.params, snap.opt_state
        with tracing.span("rescue_save", "checkpoint",
                          iteration=snap.iteration):
            path = checkpointing.save_checkpoint(
                save_dir, snap.iteration, params, opt_state,
                args=save_args,
                consumed_samples=get_counters().get("samples", 0),
                gathered=self._plan is not None,
            )
        print(f" [resilience] rescue checkpoint written: {path}", flush=True)
        return path

    def close(self) -> None:
        if self.watchdog is not None:
            self.watchdog.stop()
        if self.injector is not None:
            set_save_fault_hook(None)


def build_resilience(args) -> Optional[ResilienceManager]:
    """CLI wiring: a ResilienceManager from parsed args, or None when no
    resilience feature is requested."""
    injector = FaultInjector.from_spec(
        getattr(args, "fault_inject", None)
        or os.environ.get("MEGATRON_FAULT_INJECT"))
    timeout = getattr(args, "watchdog_timeout_secs", None)
    watchdog = (HangWatchdog(timeout,
                             hard_exit=not getattr(
                                 args, "watchdog_no_hard_exit", False))
                if timeout else None)
    rewind = bool(getattr(args, "rewind_on_spike", False))
    if not (rewind or injector or watchdog):
        return None
    cfg = ResilienceConfig(
        snapshot_interval=getattr(args, "snapshot_interval", 50),
        check_interval=getattr(args, "resilience_check_interval", 0),
        spike_factor=getattr(args, "spike_factor", 3.0),
        spike_ema_beta=getattr(args, "spike_ema_beta", 0.98),
        patience=getattr(args, "rewind_patience", 1),
        rewind_lr_factor=getattr(args, "rewind_lr_factor", 1.0),
        max_rewinds=getattr(args, "max_rewinds", 8),
    )
    return ResilienceManager(cfg, injector=injector, watchdog=watchdog,
                             rewind_enabled=rewind)
