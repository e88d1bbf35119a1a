"""LR / weight-decay scheduler (a copy of
``megatron_llm_tpu/optimizer/scheduler.py``, which imports nothing of JAX).

Reference: ``megatron/optimizer_param_scheduler.py:1-228`` — warmup +
{constant, linear, cosine, inverse-square-root} decay, weight-decay
increment styles, and a checkpoint override policy
(``--override_opt_param_scheduler`` / ``--use_checkpoint_opt_param_scheduler``).

Pure function of the step number, run on the host; the value is passed
into the step as a scalar.
"""

from __future__ import annotations

import math
from typing import Optional


class OptimizerParamScheduler:
    def __init__(
        self,
        max_lr: float,
        min_lr: float = 0.0,
        lr_warmup_steps: int = 0,
        lr_decay_steps: int = 1,
        lr_decay_style: str = "linear",
        start_wd: float = 0.01,
        end_wd: float = 0.01,
        wd_incr_steps: int = 1,
        wd_incr_style: str = "constant",
        use_checkpoint_opt_param_scheduler: bool = True,
        override_opt_param_scheduler: bool = False,
    ):
        assert max_lr >= min_lr >= 0.0
        assert lr_decay_steps > 0 and lr_warmup_steps < lr_decay_steps
        self.max_lr = max_lr
        self.min_lr = min_lr
        self.lr_warmup_steps = lr_warmup_steps
        self.lr_decay_steps = lr_decay_steps
        self.lr_decay_style = lr_decay_style
        self.start_wd = start_wd
        self.end_wd = end_wd
        self.wd_incr_steps = wd_incr_steps
        self.wd_incr_style = wd_incr_style
        self.use_checkpoint_opt_param_scheduler = use_checkpoint_opt_param_scheduler
        self.override_opt_param_scheduler = override_opt_param_scheduler
        if override_opt_param_scheduler:
            assert not use_checkpoint_opt_param_scheduler
        self.num_steps = 0

    # -- lr (reference: optimizer_param_scheduler.py:70-129) ---------------
    def get_lr(self, num_steps: Optional[int] = None) -> float:
        t = self.num_steps if num_steps is None else num_steps
        if self.lr_warmup_steps > 0 and t <= self.lr_warmup_steps:
            return self.max_lr * t / self.lr_warmup_steps
        if self.lr_decay_style == "constant":
            return self.max_lr
        if t > self.lr_decay_steps:
            return self.min_lr
        if self.lr_decay_style == "inverse-square-root":
            warmup = max(self.lr_warmup_steps, 1)
            lr = self.max_lr * math.sqrt(warmup) / math.sqrt(max(t, warmup))
            return max(self.min_lr, lr)
        num = t - self.lr_warmup_steps
        den = self.lr_decay_steps - self.lr_warmup_steps
        ratio = num / den
        assert 0.0 <= ratio <= 1.0
        delta = self.max_lr - self.min_lr
        if self.lr_decay_style == "linear":
            coeff = 1.0 - ratio
        elif self.lr_decay_style == "cosine":
            coeff = 0.5 * (math.cos(math.pi * ratio) + 1.0)
        else:
            raise ValueError(f"unknown decay style {self.lr_decay_style!r}")
        return self.min_lr + coeff * delta

    # -- wd (reference: optimizer_param_scheduler.py:44-68) ----------------
    def get_wd(self, num_steps: Optional[int] = None) -> float:
        t = self.num_steps if num_steps is None else num_steps
        if t > self.wd_incr_steps:
            return self.end_wd
        if self.wd_incr_style == "constant":
            assert self.start_wd == self.end_wd
            return self.end_wd
        ratio = t / self.wd_incr_steps
        assert 0.0 <= ratio <= 1.0
        delta = self.end_wd - self.start_wd
        if self.wd_incr_style == "linear":
            coeff = ratio
        elif self.wd_incr_style == "cosine":
            coeff = 0.5 * (math.cos(math.pi * (1 - ratio)) + 1.0)
        else:
            raise ValueError(f"unknown wd incr style {self.wd_incr_style!r}")
        return self.start_wd + coeff * delta

    def step(self, increment: int = 1):
        self.num_steps += increment
        return self.get_lr(), self.get_wd()

    # -- checkpoint round-trip (reference: :163-228) -----------------------
    def state_dict(self):
        return {
            "max_lr": self.max_lr,
            "min_lr": self.min_lr,
            "lr_warmup_steps": self.lr_warmup_steps,
            "lr_decay_steps": self.lr_decay_steps,
            "lr_decay_style": self.lr_decay_style,
            "start_wd": self.start_wd,
            "end_wd": self.end_wd,
            "num_steps": self.num_steps,
        }

    def _check_and_set(self, cls_value, sd_value, name):
        if self.override_opt_param_scheduler:
            return cls_value
        if not self.use_checkpoint_opt_param_scheduler:
            assert cls_value == sd_value, (
                f"scheduler value for {name} from checkpoint ({sd_value}) "
                f"differs from class ({cls_value})"
            )
        return sd_value

    def load_state_dict(self, sd):
        self.max_lr = self._check_and_set(self.max_lr, sd["max_lr"], "max_lr")
        self.min_lr = self._check_and_set(self.min_lr, sd["min_lr"], "min_lr")
        self.lr_warmup_steps = self._check_and_set(
            self.lr_warmup_steps, sd["lr_warmup_steps"], "lr_warmup_steps"
        )
        self.lr_decay_steps = self._check_and_set(
            self.lr_decay_steps, sd["lr_decay_steps"], "lr_decay_steps"
        )
        self.lr_decay_style = self._check_and_set(
            self.lr_decay_style, sd["lr_decay_style"], "lr_decay_style"
        )
        self.start_wd = self._check_and_set(self.start_wd, sd["start_wd"], "start_wd")
        self.end_wd = self._check_and_set(self.end_wd, sd["end_wd"], "end_wd")
        self.num_steps = sd["num_steps"]
