"""Loss scaling for fp16 training (the counterpart of
``megatron_llm_tpu/optimizer/grad_scaler.py``): ``ConstantGradScaler``
and ``DynamicGradScaler`` (growth / backoff with hysteresis), as pure
updates of a small host-side state.  The port's optimizer reads the
found-inf flag on the host, so the scale is a Python float."""

from __future__ import annotations

from typing import NamedTuple


class GradScalerState(NamedTuple):
    scale: float
    growth_tracker: int         # consecutive non-inf steps
    hysteresis_tracker: int     # remaining tolerated inf steps


class ConstantGradScaler:
    def __init__(self, scale: float):
        self._scale = float(scale)

    def init(self) -> GradScalerState:
        return GradScalerState(scale=self._scale, growth_tracker=0,
                               hysteresis_tracker=0)

    def update(self, state: GradScalerState,
               found_inf: bool) -> GradScalerState:
        return state


class DynamicGradScaler:
    """Double every ``growth_interval`` clean steps; on inf/nan, consume
    hysteresis then halve (``min_scale`` floor)."""

    def __init__(
        self,
        initial_scale: float = 2.0 ** 32,
        min_scale: float = 1.0,
        growth_factor: float = 2.0,
        backoff_factor: float = 0.5,
        growth_interval: int = 1000,
        hysteresis: int = 2,
    ):
        self.initial_scale = float(initial_scale)
        self.min_scale = float(min_scale)
        self.growth_factor = float(growth_factor)
        self.backoff_factor = float(backoff_factor)
        self.growth_interval = int(growth_interval)
        self.hysteresis = int(hysteresis)

    def init(self) -> GradScalerState:
        return GradScalerState(scale=self.initial_scale, growth_tracker=0,
                               hysteresis_tracker=self.hysteresis)

    def update(self, state: GradScalerState,
               found_inf: bool) -> GradScalerState:
        found_inf = bool(found_inf)
        hys = (state.hysteresis_tracker - 1 if found_inf
               else self.hysteresis)
        scale = state.scale
        if found_inf and hys <= 0:
            scale = max(scale * self.backoff_factor, self.min_scale)
        growth = 0 if found_inf else state.growth_tracker + 1
        if not found_inf and growth >= self.growth_interval:
            scale *= self.growth_factor
            growth = 0
        return GradScalerState(scale=scale, growth_tracker=growth,
                               hysteresis_tracker=hys)
