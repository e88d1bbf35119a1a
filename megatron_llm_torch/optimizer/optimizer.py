"""Mixed-precision optimizer with fp32 master params, global-norm clipping
and the inf/nan skip (the counterpart of
``megatron_llm_tpu/optimizer/optimizer.py``, single device).

``init(params) -> OptimizerState``;
``step(params, grads, state, lr, wd) -> (params, state, stats)``, with
the JAX package's arithmetic: grads unscaled in fp32, a global inf/nan
check, a global-norm clip, Adam(W) with decoupled weight decay (no decay
for biases and norm scales) or SGD with momentum, fp32 masters under
low-precision params, and moments stored in fp32 or bf16 with the math
in fp32.  The JAX step is functional; this one updates the params, the
masters and the moments in place, leaf by leaf, so the step's transient
memory is a few temporaries the size of the largest leaf, not a second
copy of the state.  The inf/nan check is read on the host: a step that
finds one changes no param or moment, only the loss scaler.  The update
is plain tensor code, as the JAX package leaves it to XLA.  With
``layer_stats`` the step also returns the health observatory's per-group
stats (``health.py``), accumulated inside the same leaf loop: the grad
norms and non-finite counts of the unscaled grads before the clip, the
param norms of the masters before the update, and the update norms of
the master after the step minus the master before it, one stacked row at
a time so that no second copy of the masters is made.  A step that
finds an inf/nan gets the same record with zero updates.  At tp x dp
above 1 the step takes the train step's ``TensorParallelPlan``
(``parallel/sharding.py``): the grad norm sums the squares of every
element once over tp x dp, the inf/nan check is agreed over the world,
so that every rank clips by the same norm and skips the same step, and
the layer stats' per-group sums count each element once the same way.
At pp > 1 the plan adds the stages' sums over the pp group (each
stage's rows of the layer stack once, the leaves every stage holds on
stage 0 only) and the inf/nan consensus is the world's, so that every
stage clips by the whole model's norm and skips the same steps.
Under ZeRO-1 (the plan's ``zero1``: ``--use_distributed_optimizer`` at
dp > 1) a rank holds the masters and moments of its dp slice of each
leaf that has one (``init(params, plan)``; the JAX package's
``state_specs(zero1=True)``), takes that slice of the grads (the train
step reduce-scatters them), updates it, and all-gathers the updated
compute-dtype slices over dp into the live params.  Adam is elementwise,
so given the same clip coefficient the update equals plain dp's bit for
bit.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from megatron_llm_torch import health
from megatron_llm_torch.config import TrainConfig
from megatron_llm_torch.optimizer.grad_scaler import (
    ConstantGradScaler,
    DynamicGradScaler,
    GradScalerState,
)
from megatron_llm_torch.tree import (
    tree_leaves,
    tree_leaves_with_path,
    tree_map,
    tree_unflatten,
)


class OptimizerState(NamedTuple):
    step: int
    master_params: Any   # fp32 copies when params are low precision, else None
    exp_avg: Any         # adam m (or the SGD momentum buffer)
    exp_avg_sq: Any      # adam v (None for SGD)
    grad_scaler: GradScalerState


def _no_weight_decay(path: Sequence[str], leaf=None) -> bool:
    """Weight decay applies to matmul weights only: biases and norm
    scales are excluded (embeddings are weight matrices and decay)."""
    names = [str(p) for p in path]
    if "bias" in names or "scale" in names or "lora_scale" in names:
        return True
    return any("norm" in n for n in names)


def _sumsq(t: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(t.float()).square()


def global_grad_norm(grads, plan=None, sliced: bool = False
                     ) -> torch.Tensor:
    """L2 norm over the whole grad tree, in fp32 (a 0-dim tensor); with a
    ``plan``, over the whole tree of tp x dp, each element once
    (``sliced``: the tree holds the ZeRO-1 slices)."""
    if plan is not None:
        return plan.global_sum(tree_leaves_with_path(grads), _sumsq,
                               sliced).sqrt()
    leaves = tree_leaves(grads)
    sq = torch.stack([_sumsq(g) for g in leaves])
    return sq.sum().sqrt()


class MegatronOptimizer:
    """Adam(W) / SGD with Megatron mixed-precision semantics."""

    def __init__(self, train_cfg: TrainConfig,
                 params_dtype: torch.dtype = torch.float32):
        self.cfg = train_cfg
        self.params_dtype = params_dtype
        self.is_low_precision = params_dtype != torch.float32
        self.state_dtype = (torch.bfloat16
                            if train_cfg.optimizer_state_dtype == "bf16"
                            else torch.float32)
        if train_cfg.optimizer not in ("adam", "sgd"):
            raise ValueError(f"unknown optimizer {train_cfg.optimizer!r}")
        # loss scaling only for fp16 (bf16 trains unscaled)
        if train_cfg.fp16:
            if train_cfg.loss_scale is not None:
                self.grad_scaler = ConstantGradScaler(train_cfg.loss_scale)
            else:
                self.grad_scaler = DynamicGradScaler(
                    initial_scale=train_cfg.initial_loss_scale,
                    min_scale=train_cfg.min_loss_scale,
                    growth_interval=train_cfg.loss_scale_window,
                    hysteresis=train_cfg.hysteresis,
                )
        else:
            self.grad_scaler = ConstantGradScaler(1.0)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def init(self, params, plan=None) -> OptimizerState:
        """The state of ``params``; with a ZeRO-1 ``plan``, of this dp
        rank's slice of each leaf that has one."""
        sd = self.state_dtype
        if plan is not None and plan.zero1:
            src = tree_unflatten(params, [
                plan.dp_slice(path, p)
                for path, p in tree_leaves_with_path(params)])
        else:
            src = params
        master = (tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                           src)
                  if self.is_low_precision else None)
        exp_avg = tree_map(lambda p: torch.zeros_like(p, dtype=sd), src)
        exp_avg_sq = (tree_map(lambda p: torch.zeros_like(p, dtype=sd),
                               src)
                      if self.cfg.optimizer == "adam" else None)
        return OptimizerState(step=0, master_params=master, exp_avg=exp_avg,
                              exp_avg_sq=exp_avg_sq,
                              grad_scaler=self.grad_scaler.init())

    # ------------------------------------------------------------------
    @torch.no_grad()
    def step(self, params, grads, state: OptimizerState, lr: float,
             weight_decay: Optional[float] = None, *,
             layer_stats: bool = False, plan=None):
        """One optimizer step.  ``grads`` are the *scaled* grads (the train
        step multiplies the loss by the current scale); they are read, not
        written.  Updates ``params``, the masters and the moments in place
        and returns ``(params, new_state, stats)`` with stats =
        {'grad_norm', 'found_inf', 'loss_scale'}; with ``layer_stats``
        also 'layer_stats': the per-group [G] tensors of
        ``health.compute_layer_stats`` (grad norms over the unscaled
        pre-clip grads, param norms over the masters before the step,
        update norms over the applied master delta, zero on a skipped
        step).  ``plan``: the train step's ``TensorParallelPlan`` at tp x
        dp > 1 (the norm, the inf/nan check and the layer stats over tp x
        dp); under its ZeRO-1 ``grads`` hold this rank's slice of each
        leaf that has one, and the state is that slice's."""
        cfg = self.cfg
        zero = plan is not None and plan.zero1
        wd = cfg.weight_decay if weight_decay is None else weight_decay
        scale = state.grad_scaler.scale
        inv_scale = 1.0 / scale
        named = tree_leaves_with_path(params)
        g_leaves = tree_leaves(grads)
        if len(g_leaves) != len(named):
            raise ValueError("grads and params differ in structure")
        # global inf/nan consensus and the norm of the unscaled grads,
        # read together in one host sync
        finite = torch.stack([torch.isfinite(g).all()
                              for g in g_leaves]).all().float()
        if plan is not None:
            finite = plan.all_finite(finite)
        grad_norm = global_grad_norm(grads, plan, zero) * inv_scale
        norm_host, finite_host = torch.stack([grad_norm, finite]).tolist()
        found_inf = finite_host < 1.0
        new_step = state.step + (0 if found_inf else 1)
        # fp32 params under ZeRO-1 update their dp slice in place
        masters = (tree_leaves(state.master_params)
                   if self.is_low_precision else
                   [plan.dp_slice(path, p) if zero else p
                    for path, p in named])
        gs = (health.GroupStats(health.layer_group_names(params, plan),
                                g_leaves[0].device, plan, zero)
              if layer_stats else None)
        if gs is not None and found_inf:
            # the skipped step's record: what the NaN localizer reads
            for (path, _), g, p32 in zip(named, g_leaves, masters):
                self._grad_stats(gs, path, g.float() * inv_scale, p32)
        if not found_inf:
            coeff = 1.0
            if cfg.clip_grad > 0.0:
                coeff = min(1.0, cfg.clip_grad / (norm_host + 1.0e-6))
            m_leaves = tree_leaves(state.exp_avg)
            v_leaves = (tree_leaves(state.exp_avg_sq)
                        if state.exp_avg_sq is not None
                        else [None] * len(named))
            for (path, p), g, p32, m, v in zip(named, g_leaves, masters,
                                               m_leaves, v_leaves):
                w = 0.0 if _no_weight_decay(path) else wd
                gf = g.float() * inv_scale
                if gs is not None:
                    # read before the clip scales gf in place
                    self._grad_stats(gs, path, gf, p32)
                if coeff != 1.0:
                    gf.mul_(coeff)
                if gs is None:
                    self._update(p32, gf, m, v, lr, w, new_step)
                else:
                    stacked, _ = gs.slots(path)
                    for r in (range(p32.shape[0]) if stacked else (None,)):
                        def row(t):
                            return t if r is None or t is None else t[r]
                        before = row(p32).clone()
                        self._update(row(p32), row(gf), row(m), row(v), lr,
                                     w, new_step)
                        gs.add_sumsq("update_norm", path,
                                     row(p32) - before, row=r)
                        del before
                del gf
                if zero and plan.zero_dim(path) is not None:
                    # the dp ranks' updated slices into the live leaf
                    p.copy_(plan.dp_gather(path, p32.to(p.dtype)))
                elif self.is_low_precision:
                    p.copy_(p32)
        new_state = OptimizerState(
            step=new_step, master_params=state.master_params,
            exp_avg=state.exp_avg, exp_avg_sq=state.exp_avg_sq,
            grad_scaler=self.grad_scaler.update(state.grad_scaler,
                                                found_inf))
        stats = {"grad_norm": grad_norm, "found_inf": found_inf,
                 "loss_scale": scale}
        if gs is not None:
            stats["layer_stats"] = gs.result()
        return params, new_state, stats

    @staticmethod
    def _grad_stats(gs, path, gf, p32):
        gs.add_sumsq("grad_norm", path, gf)
        gs.add_sumsq("nonfinite", path, gf)
        gs.add_sumsq("param_norm", path, p32)

    def _update(self, p32, g, m, v, lr, w, t):
        if self.cfg.optimizer == "adam":
            self._adam(p32, g, m, v, lr, w, t)
        else:
            self._sgd(p32, g, m, lr, w)

    def _adam(self, p32, g, m, v, lr, w, t):
        b1, b2, eps = self.cfg.adam_beta1, self.cfg.adam_beta2, \
            self.cfg.adam_eps
        # bias corrections in fp32, as the JAX package computes them: at
        # small t, 1 - b2**t cancels, and fp64 would differ from it by
        # ~1e-5 relative (b2 = 0.999 is not exact in fp32)
        t32 = np.float32(t)
        bc1 = float(np.float32(1.0) - np.float32(b1) ** t32)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** t32)
        m32 = m if m.dtype == torch.float32 else m.float()
        v32 = v if v.dtype == torch.float32 else v.float()
        m32.mul_(b1).add_(g, alpha=1.0 - b1)
        v32.mul_(b2).add_(g.square(), alpha=1.0 - b2)
        # update = (m / bc1) / (sqrt(v / bc2) + eps); AdamW decay
        upd = m32 / bc1
        upd.div_(v32.div(bc2).sqrt_().add_(eps))
        if w:
            upd.add_(p32, alpha=w)
        p32.add_(upd, alpha=-lr)
        if m32 is not m:
            m.copy_(m32)
            v.copy_(v32)

    def _sgd(self, p32, g, buf, lr, w):
        if w:
            g.add_(p32, alpha=w)
        b32 = buf if buf.dtype == torch.float32 else buf.float()
        b32.mul_(self.cfg.sgd_momentum).add_(g)
        p32.add_(b32, alpha=-lr)
        if b32 is not buf:
            buf.copy_(b32)


def get_megatron_optimizer(train_cfg: TrainConfig, params_dtype=None):
    if params_dtype is None:
        params_dtype = (torch.bfloat16 if train_cfg.bf16
                        else torch.float16 if train_cfg.fp16
                        else torch.float32)
    return MegatronOptimizer(train_cfg, params_dtype=params_dtype)
