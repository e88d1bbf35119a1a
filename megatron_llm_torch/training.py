"""Training runtime: the train step and the pretrain loop (the
counterpart of ``megatron_llm_tpu/training.py``), on one device or at
tensor- and data-parallel sizes above 1.

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
uninterrupted one.

At tp > 1 every rank runs the same step on its slices of the params:
the step finishes the grads with the ``TensorParallelPlan`` of
``parallel/sharding.py`` (under sequence parallelism the replicated
leaves' grads, which each saw one sequence shard, are summed over the
tp group; so are the K/V columns ranks share), and the optimizer clips
and skips over the tp group.  The loss is the vocab-parallel cross
entropy's, the same on every rank.

At dp > 1 each rank holds its rows of every micro batch
(``data_samplers.dp_rows``).  A micro batch's loss is normalised as the
JAX package's over the global micro batch: this rank's masked sum over
the dp-summed mask count, so that the dp ranks' losses and grads add up
to the global ones even where their masks differ.  The grads are summed
over the dp group (an all-reduce, or under ZeRO-1 a reduce-scatter onto
each rank's state slice, ``TensorParallelPlan.reduce_grads``), and
``lm loss`` is the dp-global mean.  The mixture of experts and losses
other than the masked token mean (BERT, T5, ICT) are refused at dp > 1
(ROADMAP item 15 (f), (g)).

``pretrain`` carries the JAX loop's runtime hooks, all host-side:
resilience (``resilience.py``: snapshots, the NaN/spike sentinel and
rewind, the hang watchdog and the fault injector), the layer-stats
observatory (``health.py``, the optimizer step's per-group stats),
telemetry (``telemetry.py``: the schema-13 JSONL stream and its flight
recorder, the status endpoint, the ``torch.profiler`` window), the span
tracer with its goodput accounting (``tracing.py``: the root ``train``
span and the ``data_next``, ``step``, ``step_sync``,
``checkpoint_save`` and ``eval`` spans), a metrics writer
(``wandb_logger.WandbTBShim``), the signal handler's save-and-exit and
asynchronous checkpoint saves, finalized on every exit path.  A custom
train step (the JAX package's pipelined engine) is the one keyword the
port refuses.
"""

from __future__ import annotations

import math
import sys
import time
from typing import Callable, Dict, Optional

import torch

from megatron_llm_torch import checkpointing, health, topology, tracing
from megatron_llm_torch import random as mrandom
from megatron_llm_torch.config import ParallelConfig, TrainConfig
from megatron_llm_torch.global_vars import get_counters
from megatron_llm_torch.optimizer import (
    MegatronOptimizer,
    OptimizerParamScheduler,
)
from megatron_llm_torch.optimizer.optimizer import global_grad_norm
from megatron_llm_torch.parallel.sharding import plan_for
from megatron_llm_torch.telemetry import Telemetry
from megatron_llm_torch.timers import Timers
from megatron_llm_torch.tree import (
    tree_leaves,
    tree_leaves_with_path,
    tree_unflatten,
)


def kernel_launches() -> Dict[str, int]:
    """The training kernels' wrapper counts in this process, by their row
    names in ``chip_smoke.py``'s kernels line: F (``flash_fwd``), G
    (``flash_bwd_fused``), H (``flash_bwd``), B and C (``rmsnorm``,
    ``rmsnorm_bwd``), D and E (``layernorm``, ``layernorm_bwd``).  They
    count launches on the card only."""
    from megatron_llm_torch.ops.kernels import flash_attention as fa
    from megatron_llm_torch.ops.kernels import layernorm as ln
    from megatron_llm_torch.ops.kernels import rmsnorm as rn

    return {"flash_fwd": fa.fwd_launches,
            "flash_bwd_fused": fa.bwd_fused_launches,
            "flash_bwd": fa.bwd_launches, "rmsnorm": rn.launches,
            "rmsnorm_bwd": rn.bwd_launches, "layernorm": ln.launches,
            "layernorm_bwd": ln.bwd_launches}


def default_loss_func(loss_tok: torch.Tensor, loss_mask: torch.Tensor):
    """Masked token-mean loss."""
    loss_mask = loss_mask.float()
    return (loss_tok * loss_mask).sum() / loss_mask.sum().clamp(min=1.0)


def _micro(batch: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in batch.items()}


def _dp_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over this rank's dp group (itself at dp 1)."""
    if topology.get_data_parallel_world_size() == 1:
        return x
    from megatron_llm_torch.parallel import mappings

    return mappings.collective("all_reduce", x,
                               topology.get_data_parallel_group())


def _global_mask_counts(batch) -> torch.Tensor:
    """[num_micro] loss-mask counts of the global micro batches (the dp
    ranks' rows together), at least 1: the denominators of the JAX
    package's ``default_loss_func`` over ``[mb x dp, seq]``."""
    mask = batch["loss_mask"].float()
    return _dp_sum(mask.reshape(mask.shape[0], -1).sum(dim=1)
                   ).clamp(min=1.0)


def refuse_at_dp(cfg, loss_func) -> None:
    """The features whose loss or params this slice does not split over
    dp raise at dp > 1."""
    if getattr(cfg, "num_experts", 0) > 1:
        topology.refuse_at_dp("the mixture of experts", "(f)")
    if loss_func is not default_loss_func:
        topology.refuse_at_dp("a loss other than the masked token mean "
                              "(BERT, T5, ICT)", "(g)")


def build_train_step(
    model,
    optimizer: MegatronOptimizer,
    parallel_cfg: ParallelConfig,
    num_microbatches: int,
    loss_func: Callable = default_loss_func,
    forward_only: bool = False,
    log_num_zeros_in_grad: bool = False,
    log_layer_stats: bool = False,
    plan=None,
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
    the accumulated grads as ``num zeros``; ``log_layer_stats`` adds the
    optimizer step's per-group stats as ``layer_stats`` (a dict of [G]
    tensors, ``health.compute_layer_stats``'s).

    A mixture of experts (``model.cfg.num_experts > 1``) returns its
    routing aux ``[lb, z]`` with the per-token loss: the optimized
    objective adds ``moe_aux_loss_coeff * lb + moe_z_loss_coeff * z`` to
    the LM loss, which is logged alone as ``lm loss``, with the balance
    loss as ``moe aux loss`` and, when its coefficient is above 0, the
    z-loss as ``moe z loss``.

    At tp x dp > 1 (``topology``) ``params`` are this rank's slices and
    the batch its rows of each micro batch; the step finishes the grads
    over the tp group and sums them over dp (``TensorParallelPlan``,
    ``plan`` or one built from the params and ``parallel_cfg``'s ZeRO-1
    flag) before the optimizer, and the num-zeros count counts each
    element once."""
    tp = topology.get_tensor_model_parallel_world_size()
    dp = topology.get_data_parallel_world_size()
    if (parallel_cfg.tensor_model_parallel_size,
            parallel_cfg.data_parallel_size) != (tp, dp):
        raise ValueError(
            f"the parallel config's tp x dp "
            f"({parallel_cfg.tensor_model_parallel_size} x "
            f"{parallel_cfg.data_parallel_size}) is not the topology's "
            f"({tp} x {dp}): initialize_model_parallel first")
    cfg = getattr(model, "cfg", None)
    refuse_at_dp(cfg, loss_func)
    plans = {"plan": plan} if plan is not None else {}
    moe_on = getattr(cfg, "num_experts", 0) > 1

    def microbatch_loss(params, micro, scale, train, rng_key=None,
                        count=None):
        extra = {k: v for k, v in micro.items()
                 if k not in ("tokens", "labels", "loss_mask")}
        loss_tok = model(params, micro["tokens"], labels=micro["labels"],
                         rng_key=rng_key, train=train, **extra)
        moe_aux = None
        if moe_on:
            loss_tok, moe_aux = loss_tok
        if count is None:
            out = loss_func(loss_tok, micro["loss_mask"])
        else:
            # this rank's share of the global micro batch's token mean
            out = (loss_tok * micro["loss_mask"].float()).sum() / count
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

    def counts(batch):
        return _global_mask_counts(batch) if dp > 1 else \
            [None] * num_microbatches

    if forward_only:
        @torch.no_grad()
        def eval_step(params, batch, rng_key=None):
            cs = counts(batch)
            losses = [microbatch_loss(params, _micro(batch, i), 1.0,
                                      False, count=cs[i])[1]
                      for i in range(num_microbatches)]
            return _dp_sum(torch.stack(losses).mean())

        return eval_step

    def train_step(params, opt_state, batch, rng_key, lr, wd):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        scale = opt_state.grad_scaler.scale
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves]
        losses, auxes = [], {}
        cs = counts(batch)
        for i in range(num_microbatches):
            mkey = (mrandom.fold_in(rng_key, i) if rng_key is not None
                    else None)
            total, loss, aux = microbatch_loss(params, _micro(batch, i),
                                               scale, True, mkey, cs[i])
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
        if "plan" not in plans:
            plans["plan"] = plan_for(
                params, cfg, bool(getattr(cfg, "sequence_parallel", False)),
                parallel_cfg.use_distributed_optimizer)
        plan = plans["plan"]
        if plan is not None:
            named = list(zip([p for p, _ in tree_leaves_with_path(params)],
                             grads))
            plan.finish_grads(named)
            # under ZeRO-1 the whole accumulators go once sliced
            grads = [g for _, g in plan.reduce_grads(named)]
            del named
        grad_tree = tree_unflatten(params, grads)
        # counted before the optimizer, which may scale the grads in place
        num_zeros = None
        if log_num_zeros_in_grad:
            num_zeros = (plan.global_sum(tree_leaves_with_path(grad_tree),
                                         lambda t: (t == 0.0).sum(),
                                         plan.zero1)
                         if plan is not None else
                         torch.stack([(g == 0.0).sum() for g in grads]).sum())
        del grads
        params, opt_state, stats = optimizer.step(
            params, grad_tree, opt_state, lr, wd,
            layer_stats=log_layer_stats, plan=plan)
        metrics = {
            "lm loss": _dp_sum(torch.stack(losses).mean()),
            "grad_norm": stats["grad_norm"],
            "loss_scale": stats["loss_scale"],
            "skipped_iter": int(stats["found_inf"]),
        }
        if log_layer_stats:
            metrics["layer_stats"] = stats["layer_stats"]
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
    writer=None,
):
    """One console log line, in the JAX package's format (null MFU fields
    are omitted, never printed as numbers), and with a ``writer`` its
    scalars."""
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
    if writer is not None:
        for k, v in metrics.items():
            writer.add_scalar(k, float(v), iteration)
        writer.add_scalar("tokens_per_sec", tps, iteration)
        writer.add_scalar("learning_rate", lr, iteration)
        if interval_time is not None:
            writer.add_scalar("interval-time-per-iteration", interval_time,
                              iteration)
        if throughput is not None:
            writer.add_scalar("tokens_per_sec_per_device",
                              throughput["tokens_per_sec_per_device"],
                              iteration)
            if throughput.get("tflops_per_device") is not None:
                writer.add_scalar("tflops_per_device",
                                  throughput["tflops_per_device"], iteration)
            if throughput.get("mfu") is not None:
                writer.add_scalar("mfu", throughput["mfu"], iteration)
    return tps


def build_scheduler(train_cfg: TrainConfig,
                    start_iteration: int = 0) -> OptimizerParamScheduler:
    """The learning-rate and weight-decay schedule of ``train_cfg``,
    stepped to ``start_iteration``."""
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
    return scheduler


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


_UNPORTED = {"train_step": "a custom train step"}


def _world_max(x: float) -> torch.Tensor:
    """The largest ``x`` over the world."""
    import torch.distributed as dist

    from megatron_llm_torch.parallel import mappings

    world = dist.group.WORLD
    dev = "cuda" if dist.get_backend(world) == "nccl" else "cpu"
    return mappings.collective("all_reduce", torch.tensor(x, device=dev),
                               world, reduce="max")


def _layer_stats_host(stats) -> Dict[str, list]:
    """The step's [G] stat tensors as host lists, in one device sync."""
    keys = sorted(stats)
    flat = torch.cat([stats[k].double() for k in keys]).tolist()
    out, i = {}, 0
    for k in keys:
        n = stats[k].numel()
        out[k] = flat[i:i + n]
        i += n
    return out


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
    exit_signal_handler=None,
    start_iteration: int = 0,
    consumed_samples: int = 0,
    opt_state=None,
    on_metrics=None,
    timers=None,
    skip_iters=(),
    exit_interval: Optional[int] = None,
    exit_duration_in_mins: Optional[float] = None,
    save_fn=None,
    log_params_norm: bool = False,
    log_num_zeros_in_grad: bool = False,
    log_layer_stats_interval: int = 0,
    writer=None,
    tensorboard_log_interval: int = 1,
    log_timers: bool = True,
    async_save: bool = False,
    log_memory: bool = False,
    log_batch_size: bool = False,
    log_world_size: bool = False,
    log_validation_ppl: bool = False,
    resilience=None,
    telemetry=None,
    preempt_exit_code: int = 0,
    **unported,
):
    """The training loop from ``start_iteration``; returns ``(params,
    opt_state, iteration)``.

    ``batch_iterator`` yields batch dicts shaped [num_micro, batch, seq].
    ``opt_state``: a restored optimizer state (else a fresh one).
    ``consumed_samples``: the samples consumed before ``start_iteration``
    (a resumed checkpoint's); the loop adds each batch's sequences, also
    into ``counters['samples']`` (and its tokens into
    ``counters['tokens']``).  ``save_interval`` / ``save_dir``: save a
    checkpoint at every multiple (through ``save_fn(save_dir, it,
    params, opt_state, scheduler, consumed_samples)`` when given, else
    ``checkpointing.save_checkpoint`` with ``async_save``), recording the
    samples consumed so far.  ``eval_iterator`` / ``eval_interval``: the
    mean loss of ``eval_iters`` forward-only batches, printed at every
    multiple.  ``skip_iters``: iteration numbers that run forward-only
    (the loss is logged, nothing is updated).  ``exit_interval``: save
    (with a ``save_dir``) and exit (``sys.exit(0)``) at a multiple of it;
    ``exit_duration_in_mins``: the same once the loop has run that long.
    ``log_params_norm`` adds the params' L2 norm to each log line,
    ``log_num_zeros_in_grad`` the count of zero grads.

    The JAX loop's runtime arguments, with its semantics:

    * ``resilience`` (a ``resilience.ResilienceManager``): snapshots
      before the step when due, the injector's stall/SIGTERM before the
      batch and its NaN in the batch's loss mask, the sentinel at check
      boundaries (``check_due``/``record_metrics``) with rewind
      (``should_rewind``/``rewind``; the batch iterator moves on), the
      layer stats of a bad step handed to the NaN localizer, the LR
      scaled by ``lr_scale``, and the watchdog armed after the first
      step, paused around saves, evaluation and rewinds; its rescue save
      goes to ``save_dir``.
    * ``log_layer_stats_interval``: the optimizer step returns per-group
      stats; they are read at log boundaries (feeding
      ``--log_params_norm`` and the resilience localizer) and go into the
      JSONL record and the writer every ``interval`` iterations.
    * ``telemetry`` (a ``telemetry.Telemetry``; default throughput-only):
      throughput/MFU in the log line, the stream's per-iteration
      ``record_dispatch`` and per-boundary ``emit`` (the JAX record's
      keys, ``schema`` 13), the profiler window (``maybe_start`` /
      ``maybe_stop`` after a synchronize), and its tracer: the root
      ``train`` span and the ``data_next``, ``step``, ``step_sync``,
      ``checkpoint_save`` and ``eval`` spans, the goodput summary in the
      record, and the recompile and straggler detectors.
    * ``writer`` (``add_scalar``/``flush``): the log line's scalars every
      ``tensorboard_log_interval`` iterations, the timers
      (``log_timers``), memory, batch size, world size, the layer stats
      and the validation loss (and ppl).
    * ``exit_signal_handler``: after a signal, save (with a ``save_dir``,
      counted in ``counters['signal_saves']``) and ``sys.exit``
      (``preempt_exit_code``).
    * ``async_save``: checkpoint writes in the background;
      ``checkpointing.finalize_async_saves()`` runs before the next save
      and on every exit path.

    At tp x dp > 1 every rank runs this loop on its pieces and its rows:
    the loop builds the step's ``TensorParallelPlan`` (ZeRO-1 under
    ``parallel_cfg.use_distributed_optimizer``), whose state slices the
    fresh optimizer state takes, and which the saves, the snapshots, the
    params norm and the layer stats use; the samples and tokens it counts
    are the global batch's.

    A custom ``train_step`` raises ``NotImplementedError``."""
    for name, value in unported.items():
        if name not in _UNPORTED:
            raise TypeError(f"pretrain() got an unexpected keyword "
                            f"argument {name!r}")
        if value not in (None, False, 0):
            raise NotImplementedError(f"{_UNPORTED[name]} ({name}) is not "
                                      f"ported yet")
    refuse_at_dp(getattr(model, "cfg", None), loss_func)
    dp = topology.get_data_parallel_world_size()
    # at tp x dp the step's grads, the params norm, the saves and the
    # snapshots go through one plan
    plan = (plan_for(params, model.cfg, bool(getattr(
        model.cfg, "sequence_parallel", False)),
        parallel_cfg.use_distributed_optimizer)
        if hasattr(model, "cfg") else None)
    if timers is None:
        timers = Timers(log_level=2)
    if telemetry is None:
        telemetry = Telemetry.default(model)
    stream = telemetry.stream
    profiler = telemetry.profiler
    trace = getattr(telemetry, "tracing", None)
    if trace is not None:
        tracing.install_tracing(trace)
    recompile = trace.recompile if trace is not None else None
    straggler = trace.straggler if trace is not None else None
    skip_iters = frozenset(skip_iters or ())
    num_micro = max(train_cfg.global_batch_size
                    // (train_cfg.micro_batch_size
                        * parallel_cfg.data_parallel_size), 1)
    if optimizer is None:
        optimizer = MegatronOptimizer(
            train_cfg, params_dtype=model.cfg.params_torch_dtype)
    if opt_state is None:
        opt_state = optimizer.init(params, plan)
    if scheduler is None:
        scheduler = build_scheduler(train_cfg, start_iteration)
    train_step = build_train_step(
        model, optimizer, parallel_cfg, num_micro, loss_func,
        log_num_zeros_in_grad=log_num_zeros_in_grad,
        log_layer_stats=log_layer_stats_interval > 0, plan=plan)
    eval_step = (build_train_step(model, optimizer, parallel_cfg, num_micro,
                                  loss_func, forward_only=True)
                 if eval_iterator is not None else None)
    skip_step = None
    counters = get_counters()
    consumed = int(consumed_samples)
    counters["samples"] = consumed
    device = model.device
    base_key = mrandom.base_key(train_cfg.seed)
    iteration = start_iteration
    last_time = train_start = time.perf_counter()
    # eval and checkpoint-save wall time inside the current log interval,
    # left out of the logged time per iteration (tokens/s and MFU)
    non_train = 0.0
    ls_names = None   # health group names, resolved on first stats fetch

    def _layer_stats_record(ls_dev):
        """The step's stat tensors -> the host JSONL record ({groups,
        grad_norm, param_norm, update_norm, update_ratio,
        nonfinite_grads})."""
        nonlocal ls_names
        if ls_names is None:
            ls_names = health.layer_group_names(params)
        return health.to_record(ls_names, _layer_stats_host(ls_dev))

    injector = resilience.injector if resilience is not None else None
    watchdog = resilience.watchdog if resilience is not None else None
    if resilience is not None:
        resilience.bind_rescue(
            save_dir,
            checkpointing.config_to_args(getattr(model, "cfg", None)))
    if watchdog is not None:
        # armed only after the first step completes: the first step
        # builds the kernels' library, which can dwarf a hang timeout
        watchdog.start()
        watchdog.pause()

    def _save(it):
        nonlocal non_train
        if watchdog is not None:
            watchdog.pause()        # storage latency is not a hang
        t0 = time.perf_counter()
        with tracing.span("checkpoint_save", "checkpoint", iteration=it):
            timers("save-checkpoint", log_level=0).start()
            if save_fn is not None:
                save_fn(save_dir, it, params, opt_state, scheduler, consumed)
            else:
                checkpointing.save_checkpoint(
                    save_dir, it, params, opt_state, scheduler,
                    consumed_samples=consumed,
                    args=checkpointing.config_to_args(
                        getattr(model, "cfg", None)),
                    async_save=async_save, plan=plan)
            timers("save-checkpoint").stop()
        non_train += time.perf_counter() - t0
        if watchdog is not None:
            watchdog.resume()

    # one root span spans the whole loop (category "run" is trace-only,
    # so goodput never counts it); the finally below closes it on every
    # exit path (SystemExit included)
    root_span = tracing.span("train", "run", start_iteration=start_iteration)
    root_span.__enter__()
    try:
        while iteration < train_cfg.train_iters:
            if resilience is not None and resilience.snapshot_due(iteration):
                # host-copy the last known-good state BEFORE this step
                # runs: the step updates the live tensors in place
                resilience.take_snapshot(iteration, params, opt_state,
                                         scheduler, plan=plan)
            if injector is not None:
                injector.before_iteration(iteration + 1)
            if profiler is not None:
                profiler.maybe_start(iteration + 1)
            timers("batch-generator", log_level=1).start()
            with tracing.span("data_next", "data"):
                batch = next(batch_iterator)
            timers("batch-generator").stop()
            if injector is not None:
                batch = injector.poison_batch(iteration + 1, batch)
            lr, wd = scheduler.step(1)
            if resilience is not None:
                lr = lr * resilience.lr_scale
            step_key = mrandom.fold_in(base_key, iteration)
            if (iteration + 1) in skip_iters:
                print(" IMPORTANT! skipping backprop for this iteration!",
                      flush=True)
                if recompile is not None:
                    recompile.pause()
                if skip_step is None:
                    skip_step = eval_step or build_train_step(
                        model, optimizer, parallel_cfg, num_micro,
                        loss_func, forward_only=True)
                metrics = {"lm loss": skip_step(params, batch, step_key),
                           "skipped_iter": 1}
                if recompile is not None:
                    recompile.resume()
            else:
                timers("train-step", log_level=1).start()
                t_step0 = time.perf_counter()
                with tracing.span("step", "step", iteration=iteration + 1):
                    params, opt_state, metrics = train_step(
                        params, opt_state, batch, step_key, lr, wd)
                step_secs = time.perf_counter() - t_step0
                timers("train-step").stop()
                if recompile is not None:
                    # the kernels' build inside the step span is not
                    # productive step time — reattribute it to 'compile'
                    _, csecs = recompile.drain()
                    if csecs > 0.0 and trace is not None:
                        trace.tracer.goodput.move("step", "compile", csecs)
                    recompile.observe_step_time(step_secs)
            if watchdog is not None:
                watchdog.resume()   # (re)arms; the first arm is post-build
            iteration += 1
            if recompile is not None and iteration == start_iteration + 1:
                recompile.mark_steady()
            if profiler is not None:
                # sync so the window holds the device work of its last
                # step, not just that step's launches
                profiler.maybe_stop(iteration, sync=lambda: _sync(device))
            # the global batch's: every dp rank trained on its rows
            tokens = batch["tokens"].numel() * dp
            counters["tokens"] += tokens
            # one sample is one sequence: every leading axis but seq
            consumed += tokens // batch["tokens"].shape[-1]
            counters["samples"] = consumed
            if stream is not None:
                # host-side fields only: never a device sync
                stream.record_dispatch({
                    "iteration": iteration,
                    "lr": float(lr),
                    "tokens": int(tokens),
                })

            at_log_boundary = bool(log_interval
                                   and iteration % log_interval == 0)
            if (resilience is not None
                    and resilience.check_due(iteration, at_log_boundary)):
                loss_val = float(metrics["lm loss"])    # device sync
                if watchdog is not None:
                    watchdog.progress()
                gn = metrics.get("grad_norm")
                bad = resilience.record_metrics(
                    iteration, loss_val,
                    None if gn is None else float(gn))
                if bad and "layer_stats" in metrics:
                    # NaN localization: hand the sentinel this step's
                    # per-group stats so the rewind names the offenders
                    resilience.observe_layer_stats(
                        iteration,
                        _layer_stats_record(metrics["layer_stats"]),
                        announce=True)
                if bad and resilience.should_rewind():
                    if watchdog is not None:
                        watchdog.pause()
                    params, opt_state, iteration = resilience.rewind(
                        params, opt_state, scheduler, batch_iterator)
                    if watchdog is not None:
                        watchdog.resume()
                    last_time = time.perf_counter()
                    non_train = 0.0
                    continue

            if at_log_boundary:
                ls_host = None
                if "layer_stats" in metrics:
                    # read once here; fans out to params norm,
                    # resilience, the writer and the JSONL record
                    metrics = dict(metrics)
                    ls_host = _layer_stats_record(metrics.pop("layer_stats"))
                    if resilience is not None:
                        resilience.observe_layer_stats(iteration, ls_host)
                at_stats_boundary = bool(
                    ls_host is not None and log_layer_stats_interval
                    and iteration % log_layer_stats_interval == 0)
                if log_params_norm:
                    metrics = dict(metrics)
                    if ls_host is not None:
                        # the per-group norms partition the sum of squares
                        metrics["params norm"] = health.derived_params_norm(
                            ls_host)
                    else:
                        with torch.no_grad():
                            metrics["params norm"] = global_grad_norm(
                                params, plan)
                timers("train-step-sync", log_level=1).start()
                with tracing.span("step_sync", "step", iteration=iteration):
                    _sync(device)
                timers("train-step-sync").stop()
                now = time.perf_counter()
                interval_time = (now - last_time) / log_interval
                elapsed = max(now - last_time - non_train, 1e-9) \
                    / log_interval
                non_train = 0.0
                last_time = now
                # --tensorboard_log_interval is an absolute iteration
                # interval; metrics only exist at log boundaries, so the
                # cadence is their intersection
                use_writer = (writer if writer is not None
                              and iteration % max(tensorboard_log_interval, 1)
                              == 0 else None)
                if use_writer is not None:
                    if log_batch_size:
                        use_writer.add_scalar("batch-size",
                                              train_cfg.global_batch_size,
                                              iteration)
                    if log_world_size:
                        use_writer.add_scalar("world-size",
                                              parallel_cfg.world_size,
                                              iteration)
                    if log_memory:
                        from megatron_llm_torch.telemetry import (
                            device_memory_stats,
                        )
                        stats = device_memory_stats()
                        use_writer.add_scalar(
                            "mem-bytes-in-use",
                            stats.get("bytes_in_use", 0), iteration)
                        if "peak_bytes_in_use" in stats:
                            use_writer.add_scalar(
                                "mem-peak-bytes-in-use",
                                stats["peak_bytes_in_use"], iteration)
                        if "num_allocs" in stats:
                            use_writer.add_scalar(
                                "mem-num-allocs",
                                stats["num_allocs"], iteration)
                    if at_stats_boundary:
                        # grouped scalars: layer_stats/<stat>/<group>
                        ur = ls_host.get("update_ratio")
                        for i, g in enumerate(ls_host["groups"]):
                            for key in ("grad_norm", "param_norm",
                                        "update_norm"):
                                if key in ls_host:
                                    use_writer.add_scalar(
                                        f"layer_stats/{key}/{g}",
                                        health.record_value(ls_host[key][i]),
                                        iteration)
                            if ur is not None and ur[i] is not None:
                                use_writer.add_scalar(
                                    f"layer_stats/update_ratio/{g}",
                                    ur[i], iteration)
                log_metrics = {k: (v if isinstance(v, int) else float(v))
                               for k, v in metrics.items()}
                if resilience is not None:
                    from megatron_llm_torch.resilience import (
                        recovery_counters,
                    )
                    log_metrics.update(recovery_counters())
                throughput = (telemetry.throughput.compute(tokens, elapsed)
                              if telemetry.throughput is not None else None)
                training_log(iteration, train_cfg.train_iters, log_metrics,
                             elapsed, tokens, lr, writer=use_writer,
                             throughput=throughput,
                             interval_time=interval_time)
                # one snapshot feeds the writer and the console line; the
                # per-host values feed the straggler detector
                gathered = timers.report(
                    use_writer if log_timers else None, iteration,
                    normalizer=log_interval)
                if straggler is not None and gathered:
                    straggler.check(gathered, iteration)
                if stream is not None:
                    from megatron_llm_torch.resilience import (
                        recovery_counters,
                    )
                    from megatron_llm_torch.telemetry import (
                        device_memory_stats,
                    )
                    rec = {
                        "iteration": iteration,
                        "train_iters": train_cfg.train_iters,
                        "lm_loss": log_metrics.get("lm loss"),
                        "grad_norm": log_metrics.get("grad_norm"),
                        "loss_scale": log_metrics.get("loss_scale"),
                        "skipped_iter": int(log_metrics.get("skipped_iter",
                                                            0)),
                        "learning_rate": float(lr),
                        "step_time_secs": elapsed,
                        "interval_time_secs": interval_time,
                        "tokens_per_iter": int(tokens),
                        **(throughput or {}),
                        "memory": device_memory_stats(),
                        "recovery": recovery_counters(),
                    }
                    if trace is not None:
                        g = trace.goodput_summary()
                        rec["goodput_pct"] = g["goodput_pct"]
                        rec["goodput"] = {
                            k: round(v, 4) if isinstance(v, (int, float))
                            else v
                            for k, v in g.items()}
                        rec["recompiles"] = int(
                            counters.get("recompiles", 0))
                        rec["straggler_events"] = int(
                            counters.get("straggler_events", 0))
                    if at_stats_boundary:
                        rec["layer_stats"] = ls_host
                    stream.emit(rec)
                if use_writer is not None and hasattr(use_writer, "flush"):
                    use_writer.flush()
                if on_metrics is not None:
                    on_metrics(iteration, metrics)

            if eval_step is not None and eval_interval \
                    and iteration % eval_interval == 0:
                if watchdog is not None:
                    watchdog.pause()    # eval has its own duration budget
                if recompile is not None:
                    recompile.pause()
                t_eval0 = time.perf_counter()
                with tracing.span("eval", "eval", iteration=iteration):
                    timers("eval-time", log_level=0).start()
                    losses = [float(eval_step(params, next(eval_iterator),
                                              None))
                              for _ in range(eval_iters)]
                    timers("eval-time").stop()
                non_train += time.perf_counter() - t_eval0
                if recompile is not None:
                    recompile.resume()
                if watchdog is not None:
                    watchdog.resume()
                val = sum(losses) / len(losses)
                print(f" validation loss at iteration {iteration}: "
                      f"{val:.6E}", flush=True)
                if writer is not None:
                    writer.add_scalar("validation loss", val, iteration)
                    if log_validation_ppl:
                        writer.add_scalar("validation ppl",
                                          math.exp(min(val, 20.0)),
                                          iteration)
                    if hasattr(writer, "flush"):
                        writer.flush()

            saved = False
            if save_interval and save_dir and iteration % save_interval == 0:
                _save(iteration)
                saved = True

            # one process: the local flag is the answer at every iteration;
            # a world of ranks agrees at the boundaries
            at_boundary = (saved or at_log_boundary
                           or iteration >= train_cfg.train_iters)
            if exit_signal_handler is not None \
                    and exit_signal_handler.signals_received(
                        consensus=at_boundary):
                print("exiting on termination signal: saving checkpoint",
                      flush=True)
                if save_dir:
                    if not saved:
                        _save(iteration)
                    counters["signal_saves"] += 1
                code = int(preempt_exit_code or 0)
                if code and stream is not None:
                    stream.emit({"kind": "preempt_rescue",
                                 "iteration": iteration,
                                 "exit_code": code,
                                 "saved": bool(save_dir)})
                sys.exit(code)

            train_mins = (time.perf_counter() - train_start) / 60.0
            if exit_duration_in_mins and topology.is_distributed():
                # every rank leaves at the same iteration: the slowest
                # clock decides
                train_mins = float(_world_max(train_mins))
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
    finally:
        # every exit path — completion, sys.exit, an exception — closes
        # the root span and flushes the in-flight async save
        root_span.__exit__(None, None, None)
        if watchdog is not None:
            watchdog.stop()
        if profiler is not None:
            profiler.close()
        checkpointing.finalize_async_saves()
    return params, opt_state, iteration
