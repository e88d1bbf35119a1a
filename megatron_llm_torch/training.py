"""Training runtime on one device: the train step and the pretrain loop
(the counterpart of ``megatron_llm_tpu/training.py``).

``build_train_step`` returns a step with the JAX package's signature and
metrics: a loop over the micro-batches, each a forward and
``torch.autograd.grad`` whose grads are added into fp32 accumulators (the
JAX package's ``lax.scan``), then ``MegatronOptimizer.step``.  PyTorch
runs eagerly, so there is nothing to compile and nothing is donated: the
optimizer updates the params and its state in place.  ``pretrain`` runs
the loop with the scheduler, the ``batch-generator`` / ``train-step``
timers, the JAX package's log line (throughput and MFU included),
``skip_iters``, ``exit_interval``, ``exit_duration_in_mins``, resuming
(``start_iteration``, ``opt_state``), checkpoint saving every
``save_interval`` iterations, evaluation every ``eval_interval`` (a
forward-only step over ``eval_iters`` batches) and the params norm and
the count of zero grads in the log line; eval and save time is left out
of the logged time per iteration, as in the JAX package.  ``pretrain``
counts the samples consumed from its ``consumed_samples`` argument on,
and a checkpoint records that count.

Dropout keys follow the JAX package: the step's key is the base key of
``TrainConfig.seed`` folded with the iteration, and each micro-batch's
is the step's folded with the micro-batch index
(``megatron_llm_torch/random.py``); the model splits it further by
layer and site.  A resumed run therefore draws the masks of an
uninterrupted one.  Resilience, asynchronous saves, the layer-stats
observatory, the JSONL stream, the tracer and TensorBoard writers are
later slices: asking for one raises ``NotImplementedError``.
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Dict, Optional

import torch

from megatron_llm_torch import checkpointing
from megatron_llm_torch import random as mrandom
from megatron_llm_torch.config import ParallelConfig, TrainConfig
from megatron_llm_torch.optimizer import (
    MegatronOptimizer,
    OptimizerParamScheduler,
)
from megatron_llm_torch.optimizer.optimizer import global_grad_norm
from megatron_llm_torch.telemetry import ThroughputCalculator
from megatron_llm_torch.timers import Timers
from megatron_llm_torch.tree import tree_leaves, tree_unflatten


def default_loss_func(loss_tok: torch.Tensor, loss_mask: torch.Tensor):
    """Masked token-mean loss."""
    loss_mask = loss_mask.float()
    return (loss_tok * loss_mask).sum() / loss_mask.sum().clamp(min=1.0)


def _micro(batch: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in batch.items()}


def build_train_step(
    model,
    optimizer: MegatronOptimizer,
    parallel_cfg: ParallelConfig,
    num_microbatches: int,
    loss_func: Callable = default_loss_func,
    forward_only: bool = False,
    log_num_zeros_in_grad: bool = False,
):
    """One global training step.

    Batch layout: dict of tensors with leading axes [num_micro, batch,
    seq] on the model's device; keys tokens, labels, loss_mask (others
    go to the model as keyword arguments).  Returns
    ``train_step(params, opt_state, batch, rng_key, lr, wd) ->
    (params, opt_state, metrics)``, or with ``forward_only`` the eval
    step ``(params, batch, rng_key) -> mean loss``.  ``rng_key`` is the
    step's dropout key (an integer, or None to drop nothing); micro-batch
    i trains on ``random.fold_in(rng_key, i)``.  The eval step draws
    nothing.  ``log_num_zeros_in_grad`` adds the count of zero entries of
    the accumulated grads as ``num zeros``.

    A mixture of experts (``model.cfg.num_experts > 1``) returns its
    routing aux ``[lb, z]`` with the per-token loss: the optimized
    objective adds ``moe_aux_loss_coeff * lb + moe_z_loss_coeff * z`` to
    the LM loss, which is logged alone as ``lm loss``, with the balance
    loss as ``moe aux loss`` and, when its coefficient is above 0, the
    z-loss as ``moe z loss``."""
    if parallel_cfg.world_size != 1:
        raise NotImplementedError("the port trains on one device")
    cfg = getattr(model, "cfg", None)
    moe_on = getattr(cfg, "num_experts", 0) > 1

    def microbatch_loss(params, micro, scale, train, rng_key=None):
        extra = {k: v for k, v in micro.items()
                 if k not in ("tokens", "labels", "loss_mask")}
        loss_tok = model(params, micro["tokens"], labels=micro["labels"],
                         rng_key=rng_key, train=train, **extra)
        moe_aux = None
        if moe_on:
            loss_tok, moe_aux = loss_tok
        out = loss_func(loss_tok, micro["loss_mask"])
        # loss_func may return (total, {metric: scalar})
        loss, aux = out if isinstance(out, tuple) else (out, {})
        total = loss
        if moe_aux is not None:
            aux = {**aux, "moe aux loss": moe_aux[0]}
            if cfg.moe_z_loss_coeff > 0.0:
                aux["moe z loss"] = moe_aux[1]
            total = (loss + cfg.moe_aux_loss_coeff * moe_aux[0]
                     + cfg.moe_z_loss_coeff * moe_aux[1])
        return total * scale / num_microbatches, loss, aux

    if forward_only:
        @torch.no_grad()
        def eval_step(params, batch, rng_key=None):
            losses = [microbatch_loss(params, _micro(batch, i), 1.0,
                                      False)[1]
                      for i in range(num_microbatches)]
            return torch.stack(losses).mean()

        return eval_step

    def train_step(params, opt_state, batch, rng_key, lr, wd):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        scale = opt_state.grad_scaler.scale
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves]
        losses, auxes = [], {}
        for i in range(num_microbatches):
            mkey = (mrandom.fold_in(rng_key, i) if rng_key is not None
                    else None)
            total, loss, aux = microbatch_loss(params, _micro(batch, i),
                                               scale, True, mkey)
            g = torch.autograd.grad(total, leaves, allow_unused=True)
            del total
            # accumulate in fp32 and drop each micro-batch's own grads
            for acc, gi in zip(grads, g):
                if gi is not None:
                    acc.add_(gi)
            del g
            losses.append(loss.detach())
            for k, v in aux.items():
                auxes.setdefault(k, []).append(v.detach())
        # counted before the optimizer, which may scale the grads in place
        num_zeros = (torch.stack([(g == 0.0).sum() for g in grads]).sum()
                     if log_num_zeros_in_grad else None)
        grad_tree = tree_unflatten(params, grads)
        params, opt_state, stats = optimizer.step(params, grad_tree,
                                                  opt_state, lr, wd)
        metrics = {
            "lm loss": torch.stack(losses).mean(),
            "grad_norm": stats["grad_norm"],
            "loss_scale": stats["loss_scale"],
            "skipped_iter": int(stats["found_inf"]),
        }
        if num_zeros is not None:
            metrics["num zeros"] = num_zeros
        metrics.update({k: torch.stack(v).mean() for k, v in auxes.items()})
        return params, opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def training_log(
    iteration: int,
    train_iters: int,
    metrics: Dict[str, float],
    elapsed_per_iter: float,
    tokens_per_iter: float,
    lr: float,
    printer=print,
    throughput: Optional[Dict] = None,
    interval_time: Optional[float] = None,
):
    """One console log line, in the JAX package's format (null MFU fields
    are omitted, never printed as numbers)."""
    tps = tokens_per_iter / max(elapsed_per_iter, 1e-9)
    line = (
        f" iteration {iteration:8d}/{train_iters:8d} |"
        f" elapsed time per iteration (ms): {elapsed_per_iter * 1000.0:.1f} |"
    )
    if interval_time is not None:
        line += (f" interval time per iteration (ms):"
                 f" {interval_time * 1000.0:.1f} |")
    line += f" tokens per second: {tps:.1f} |"
    if throughput is not None:
        line += (f" tokens per second per device:"
                 f" {throughput['tokens_per_sec_per_device']:.1f} |")
        if throughput.get("tflops_per_device") is not None:
            line += (f" TFLOPs per device:"
                     f" {throughput['tflops_per_device']:.1f} |")
        if throughput.get("mfu") is not None:
            line += f" MFU: {throughput['mfu'] * 100.0:.1f}% |"
    line += (
        f" learning rate: {lr:.3E} |"
        f" lm loss: {float(metrics.get('lm loss', 0.0)):.6E} |"
        f" loss scale: {float(metrics.get('loss_scale', 1.0)):.1f} |"
        f" grad norm: {float(metrics.get('grad_norm', 0.0)):.3f} |"
        f" skipped iterations: {int(metrics.get('skipped_iter', 0))} |"
    )
    known = {"lm loss", "loss_scale", "grad_norm", "skipped_iter"}
    for k in sorted(set(metrics) - known):
        v = metrics[k]
        line += (f" {k}: {v} |" if isinstance(v, int)
                 else f" {k}: {float(v):.6E} |")
    printer(line)
    return tps


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


_UNPORTED = {
    "async_save": "asynchronous checkpoint saving",
    "exit_signal_handler": "the signal handler",
    "log_layer_stats_interval": "the layer-stats observatory",
    "writer": "metrics writers", "resilience": "resilience",
    "telemetry": "the JSONL stream, profiler and tracer",
    "train_step": "a custom train step",
}


def pretrain(
    model,
    params,
    train_cfg: TrainConfig,
    parallel_cfg: ParallelConfig,
    batch_iterator,
    *,
    scheduler: Optional[OptimizerParamScheduler] = None,
    optimizer: Optional[MegatronOptimizer] = None,
    loss_func: Callable = default_loss_func,
    log_interval: int = 10,
    save_interval: Optional[int] = None,
    save_dir: Optional[str] = None,
    eval_iterator=None,
    eval_interval: Optional[int] = None,
    eval_iters: int = 10,
    start_iteration: int = 0,
    consumed_samples: int = 0,
    opt_state=None,
    timers=None,
    skip_iters=(),
    exit_interval: Optional[int] = None,
    exit_duration_in_mins: Optional[float] = None,
    save_fn=None,
    log_params_norm: bool = False,
    log_num_zeros_in_grad: bool = False,
    **unported,
):
    """The training loop from ``start_iteration``; returns ``(params,
    opt_state, iteration)``.

    ``batch_iterator`` yields batch dicts shaped [num_micro, batch, seq].
    ``opt_state``: a restored optimizer state (else a fresh one).
    ``consumed_samples``: the samples consumed before ``start_iteration``
    (a resumed checkpoint's); the loop adds each batch's sequences.
    ``save_interval`` / ``save_dir``: save a checkpoint at every multiple
    (through ``save_fn(save_dir, it, params, opt_state, scheduler,
    consumed_samples)`` when given), recording the samples consumed so
    far.  ``eval_iterator`` / ``eval_interval``: the mean loss of
    ``eval_iters`` forward-only batches, printed at every multiple.
    ``skip_iters``: iteration numbers that run forward-only (the loss is
    logged, nothing is updated).  ``exit_interval``: save (with a
    ``save_dir``) and exit (``sys.exit(0)``) at a multiple of it;
    ``exit_duration_in_mins``: the same once the loop has run that long.
    ``log_params_norm`` adds the params' L2 norm to each log line,
    ``log_num_zeros_in_grad`` the count of zero grads.  The
    JAX package's other keyword arguments (resilience, telemetry,
    writers, layer stats, signal handling, asynchronous saves, a custom
    step) raise ``NotImplementedError`` when set."""
    for name, value in unported.items():
        if name not in _UNPORTED:
            raise TypeError(f"pretrain() got an unexpected keyword "
                            f"argument {name!r}")
        if value not in (None, False, 0):
            raise NotImplementedError(f"{_UNPORTED[name]} ({name}) is not "
                                      f"ported yet")
    if timers is None:
        timers = Timers(log_level=2)
    throughput = ThroughputCalculator.from_model(model)
    skip_iters = frozenset(skip_iters or ())
    num_micro = max(train_cfg.global_batch_size
                    // (train_cfg.micro_batch_size
                        * parallel_cfg.data_parallel_size), 1)
    if optimizer is None:
        optimizer = MegatronOptimizer(
            train_cfg, params_dtype=model.cfg.params_torch_dtype)
    if opt_state is None:
        opt_state = optimizer.init(params)
    if scheduler is None:
        swd = train_cfg.start_weight_decay
        ewd = train_cfg.end_weight_decay
        scheduler = OptimizerParamScheduler(
            max_lr=train_cfg.lr,
            min_lr=train_cfg.min_lr,
            lr_warmup_steps=train_cfg.lr_warmup_iters,
            lr_decay_steps=(train_cfg.lr_decay_iters
                            or max(train_cfg.train_iters, 1)),
            lr_decay_style=train_cfg.lr_decay_style,
            start_wd=swd if swd is not None else train_cfg.weight_decay,
            end_wd=ewd if ewd is not None else train_cfg.weight_decay,
            wd_incr_steps=max(train_cfg.train_iters, 1),
            wd_incr_style=train_cfg.weight_decay_incr_style,
        )
        scheduler.num_steps = start_iteration
    train_step = build_train_step(model, optimizer, parallel_cfg, num_micro,
                                  loss_func,
                                  log_num_zeros_in_grad=log_num_zeros_in_grad)
    eval_step = (build_train_step(model, optimizer, parallel_cfg, num_micro,
                                  loss_func, forward_only=True)
                 if eval_iterator is not None else None)
    skip_step = None
    consumed = int(consumed_samples)
    device = model.device
    base_key = mrandom.base_key(train_cfg.seed)
    iteration = start_iteration
    last_time = train_start = time.perf_counter()
    # eval and checkpoint-save wall time inside the current log interval,
    # left out of the logged time per iteration (tokens/s and MFU)
    non_train = 0.0

    def _save(it):
        nonlocal non_train
        t0 = time.perf_counter()
        timers("save-checkpoint", log_level=0).start()
        if save_fn is not None:
            save_fn(save_dir, it, params, opt_state, scheduler, consumed)
        else:
            checkpointing.save_checkpoint(
                save_dir, it, params, opt_state, scheduler,
                consumed_samples=consumed,
                args=checkpointing.config_to_args(
                    getattr(model, "cfg", None)))
        timers("save-checkpoint").stop()
        non_train += time.perf_counter() - t0

    while iteration < train_cfg.train_iters:
        timers("batch-generator", log_level=1).start()
        batch = next(batch_iterator)
        timers("batch-generator").stop()
        lr, wd = scheduler.step(1)
        step_key = mrandom.fold_in(base_key, iteration)
        if (iteration + 1) in skip_iters:
            print(" IMPORTANT! skipping backprop for this iteration!",
                  flush=True)
            if skip_step is None:
                skip_step = eval_step or build_train_step(
                    model, optimizer, parallel_cfg, num_micro, loss_func,
                    forward_only=True)
            metrics = {"lm loss": skip_step(params, batch, step_key),
                       "skipped_iter": 1}
        else:
            timers("train-step", log_level=1).start()
            params, opt_state, metrics = train_step(
                params, opt_state, batch, step_key, lr, wd)
            timers("train-step").stop()
        iteration += 1
        tokens = batch["tokens"].numel()
        # one sample is one sequence: every leading axis but seq
        consumed += tokens // batch["tokens"].shape[-1]

        if log_interval and iteration % log_interval == 0:
            if log_params_norm:
                with torch.no_grad():
                    metrics = {**metrics,
                               "params norm": global_grad_norm(params)}
            timers("train-step-sync", log_level=1).start()
            _sync(device)
            timers("train-step-sync").stop()
            now = time.perf_counter()
            interval_time = (now - last_time) / log_interval
            elapsed = max(now - last_time - non_train, 1e-9) / log_interval
            non_train = 0.0
            last_time = now
            log_metrics = {k: (v if isinstance(v, int) else float(v))
                           for k, v in metrics.items()}
            training_log(iteration, train_cfg.train_iters, log_metrics,
                         elapsed, tokens, lr,
                         throughput=throughput.compute(tokens, elapsed),
                         interval_time=interval_time)
            timers.report(None, iteration, normalizer=log_interval)

        if eval_step is not None and eval_interval \
                and iteration % eval_interval == 0:
            t_eval0 = time.perf_counter()
            timers("eval-time", log_level=0).start()
            losses = [float(eval_step(params, next(eval_iterator), None))
                      for _ in range(eval_iters)]
            timers("eval-time").stop()
            non_train += time.perf_counter() - t_eval0
            val = sum(losses) / len(losses)
            print(f" validation loss at iteration {iteration}: {val:.6E}",
                  flush=True)

        saved = False
        if save_interval and save_dir and iteration % save_interval == 0:
            _save(iteration)
            saved = True

        train_mins = (time.perf_counter() - train_start) / 60.0
        if exit_duration_in_mins and train_mins > exit_duration_in_mins:
            why = f"after {train_mins:.1f} minutes"
        elif exit_interval and iteration % exit_interval == 0:
            why = f"at iteration {iteration}"
        else:
            continue
        if save_dir and not saved:
            _save(iteration)
        print(f" exiting program {why}", flush=True)
        sys.exit(0)
    return params, opt_state, iteration
