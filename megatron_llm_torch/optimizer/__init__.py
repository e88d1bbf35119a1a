"""Optimizer stack (the counterpart of ``megatron_llm_tpu/optimizer/``):
``MegatronOptimizer`` with fp32 masters, clipping and the inf/nan skip,
the loss scalers and the LR / weight-decay scheduler."""

from megatron_llm_torch.optimizer.grad_scaler import (  # noqa: F401
    ConstantGradScaler,
    DynamicGradScaler,
    GradScalerState,
)
from megatron_llm_torch.optimizer.optimizer import (  # noqa: F401
    MegatronOptimizer,
    OptimizerState,
    get_megatron_optimizer,
)
from megatron_llm_torch.optimizer.scheduler import (  # noqa: F401
    OptimizerParamScheduler,
)
