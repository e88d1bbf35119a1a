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
``skip_iters`` and ``exit_interval``.  Resilience, evaluation,
checkpoint saving, the layer-stats observatory, the JSONL stream, the
tracer and TensorBoard writers are later slices: asking for one raises
``NotImplementedError``.
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Dict, Optional

import torch

from megatron_llm_torch.config import ParallelConfig, TrainConfig
from megatron_llm_torch.optimizer import (
    MegatronOptimizer,
    OptimizerParamScheduler,
)
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
):
    """One global training step.

    Batch layout: dict of tensors with leading axes [num_micro, batch,
    seq] on the model's device; keys tokens, labels, loss_mask (others
    go to the model as keyword arguments).  Returns
    ``train_step(params, opt_state, batch, rng_key, lr, wd) ->
    (params, opt_state, metrics)``, or with ``forward_only`` the eval
    step ``(params, batch, rng_key) -> mean loss``.  ``rng_key`` feeds
    dropout in the JAX package; with dropout off nothing draws from it."""
    if parallel_cfg.world_size != 1:
        raise NotImplementedError("the port trains on one device")

    def microbatch_loss(params, micro, scale, train):
        extra = {k: v for k, v in micro.items()
                 if k not in ("tokens", "labels", "loss_mask")}
        loss_tok = model(params, micro["tokens"], labels=micro["labels"],
                         train=train, **extra)
        out = loss_func(loss_tok, micro["loss_mask"])
        # loss_func may return (total, {metric: scalar})
        loss, aux = out if isinstance(out, tuple) else (out, {})
        return loss * scale / num_microbatches, loss, aux

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
            total, loss, aux = microbatch_loss(params, _micro(batch, i),
                                               scale, True)
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
        grad_tree = tree_unflatten(params, grads)
        params, opt_state, stats = optimizer.step(params, grad_tree,
                                                  opt_state, lr, wd)
        metrics = {
            "lm loss": torch.stack(losses).mean(),
            "grad_norm": stats["grad_norm"],
            "loss_scale": stats["loss_scale"],
            "skipped_iter": int(stats["found_inf"]),
        }
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
    "save_interval": "checkpoint saving", "save_dir": "checkpoint saving",
    "save_fn": "checkpoint saving", "async_save": "checkpoint saving",
    "eval_iterator": "evaluation", "eval_interval": "evaluation",
    "exit_signal_handler": "the signal handler",
    "log_params_norm": "--log_params_norm",
    "log_num_zeros_in_grad": "--log_num_zeros_in_grad",
    "log_layer_stats_interval": "the layer-stats observatory",
    "writer": "metrics writers", "resilience": "resilience",
    "telemetry": "the JSONL stream, profiler and tracer",
    "start_iteration": "resuming", "opt_state": "resuming",
    "train_step": "a custom train step",
    "exit_duration_in_mins": "--exit_duration_in_mins",
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
    timers=None,
    skip_iters=(),
    exit_interval: Optional[int] = None,
    **unported,
):
    """The training loop from iteration 0; returns ``(params, opt_state,
    iteration)``.

    ``batch_iterator`` yields batch dicts shaped [num_micro, batch, seq].
    ``skip_iters``: iteration numbers that run forward-only (the loss is
    logged, nothing is updated).  ``exit_interval``: exit
    (``sys.exit(0)``) at a multiple of it.  The JAX package's other
    keyword arguments (resuming, saving, evaluation, resilience,
    telemetry, writers, layer stats, signal handling, a custom step)
    raise ``NotImplementedError`` when set."""
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
    train_step = build_train_step(model, optimizer, parallel_cfg, num_micro,
                                  loss_func)
    skip_step = None
    device = model.device
    iteration = 0
    last_time = time.perf_counter()
    while iteration < train_cfg.train_iters:
        timers("batch-generator", log_level=1).start()
        batch = next(batch_iterator)
        timers("batch-generator").stop()
        lr, wd = scheduler.step(1)
        if (iteration + 1) in skip_iters:
            print(" IMPORTANT! skipping backprop for this iteration!",
                  flush=True)
            if skip_step is None:
                skip_step = build_train_step(
                    model, optimizer, parallel_cfg, num_micro, loss_func,
                    forward_only=True)
            metrics = {"lm loss": skip_step(params, batch, None),
                       "skipped_iter": 1}
        else:
            timers("train-step", log_level=1).start()
            params, opt_state, metrics = train_step(
                params, opt_state, batch, None, lr, wd)
            timers("train-step").stop()
        iteration += 1
        tokens = batch["tokens"].numel()

        if log_interval and iteration % log_interval == 0:
            timers("train-step-sync", log_level=1).start()
            _sync(device)
            timers("train-step-sync").stop()
            now = time.perf_counter()
            elapsed = max(now - last_time, 1e-9) / log_interval
            last_time = now
            log_metrics = {k: (v if isinstance(v, int) else float(v))
                           for k, v in metrics.items()}
            training_log(iteration, train_cfg.train_iters, log_metrics,
                         elapsed, tokens, lr,
                         throughput=throughput.compute(tokens, elapsed),
                         interval_time=elapsed)
            timers.report(None, iteration, normalizer=log_interval)

        if exit_interval and iteration % exit_interval == 0:
            print(f" exiting program at iteration {iteration}", flush=True)
            sys.exit(0)
    return params, opt_state, iteration
