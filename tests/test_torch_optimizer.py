"""The port's optimizer stack against the JAX package's: the same grads
fed for several steps to both optimizers give the same params and state
(cases after tests/test_optimizer.py: AdamW with the no-decay rule, SGD,
bf16 params with fp32 masters, bf16 moments, clipping and
``global_grad_norm``, the inf-grad skip, both grad scalers), and the
scheduler's lr/wd over steps with its ``state_dict`` round trip.
fp32 leaves within 1e-6; bf16 leaves within one bf16 rounding step."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import TrainConfig as JaxTrainConfig
from megatron_llm_tpu.optimizer import DynamicGradScaler as JaxDynamic
from megatron_llm_tpu.optimizer import MegatronOptimizer as JaxOptimizer
from megatron_llm_tpu.optimizer.optimizer import (
    global_grad_norm as jax_global_grad_norm)
from megatron_llm_tpu.optimizer.scheduler import (
    OptimizerParamScheduler as JaxScheduler)
from megatron_llm_torch.config import TrainConfig
from megatron_llm_torch.optimizer import (
    ConstantGradScaler,
    DynamicGradScaler,
    MegatronOptimizer,
    OptimizerParamScheduler,
)
from megatron_llm_torch.optimizer.optimizer import global_grad_norm
from megatron_llm_torch.tree import tree_map
from megatron_llm_torch.weights import params_to_numpy

torch.set_num_threads(1)
TORCH_DT = {"fp32": torch.float32, "bf16": torch.bfloat16,
            "fp16": torch.float16}
JAX_DT = {"fp32": jnp.float32, "bf16": jnp.bfloat16, "fp16": jnp.float16}


def _params_np():
    rng = np.random.default_rng(0)
    return {
        "embedding": {"word": {"embedding": rng.standard_normal((6, 4))}},
        "layer": {"kernel": rng.standard_normal((4, 4)),
                  "bias": rng.standard_normal(4) * 0.1},
        "input_norm": {"scale": 1.0 + rng.standard_normal(4) * 0.1},
    }


def _grads_np(step, like, scale=1.0, inf_at=None):
    rng = np.random.default_rng(100 + step)
    out = tree_map(lambda a: (rng.standard_normal(a.shape) * scale
                              ).astype(np.float32), like)
    if inf_at == step:
        out["layer"]["kernel"][0, 0] = np.inf
    return out


def _np(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return params_to_numpy({"x": tree})["x"].astype(np.float32)
    return np.asarray(tree, np.float32)


def _close(got, want, bf16, what):
    if want is None:
        assert got is None, what
        return
    if isinstance(want, dict):
        for k in want:
            _close(got[k], want[k], bf16, f"{what}.{k}")
        return
    if bf16:
        # one bf16 rounding step of the larger magnitude
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=what)


CASES = {
    "adamw_no_decay_rule": dict(cfg=dict(optimizer="adam", lr=0.1,
                                         weight_decay=0.3, clip_grad=0.0)),
    "sgd": dict(cfg=dict(optimizer="sgd", weight_decay=0.2, clip_grad=0.0)),
    "bf16_params_fp32_masters": dict(cfg=dict(bf16=True), params="bf16"),
    "bf16_moments": dict(cfg=dict(optimizer_state_dtype="bf16")),
    "bf16_moments_sgd": dict(cfg=dict(optimizer="sgd",
                                      optimizer_state_dtype="bf16")),
    "clipping": dict(cfg=dict(clip_grad=0.5), grad_scale=3.0),
    "inf_skip_dynamic_scaler": dict(
        cfg=dict(fp16=True, initial_loss_scale=2.0 ** 4, hysteresis=1,
                 loss_scale_window=2), params="fp16", inf_at=1),
    "constant_scaler": dict(cfg=dict(fp16=True, loss_scale=8.0),
                            params="fp16", grad_scale=8.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_steps_match_jax(case):
    spec = CASES[case]
    kw = dict(dict(lr=0.05, weight_decay=0.1), **spec["cfg"])
    pdt = spec.get("params", "fp32")
    jopt = JaxOptimizer(JaxTrainConfig(**kw), params_dtype=JAX_DT[pdt])
    topt = MegatronOptimizer(TrainConfig(**kw), params_dtype=TORCH_DT[pdt])
    base = _params_np()
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, JAX_DT[pdt]), base)
    tp = tree_map(lambda a: torch.from_numpy(
        np.asarray(a, np.float32)).to(TORCH_DT[pdt]), base)
    js, ts = jopt.init(jp), topt.init(tp)
    bf16 = pdt != "fp32" or kw.get("optimizer_state_dtype") == "bf16"
    for step in range(4):
        g = _grads_np(step, base, spec.get("grad_scale", 1.0),
                      spec.get("inf_at"))
        lr, wd = kw["lr"] * (1 + step), kw["weight_decay"]
        jp, js, jst = jopt.step(jp, jax.tree_util.tree_map(jnp.asarray, g),
                                js, lr, wd)
        tp, ts, tst = topt.step(tp, tree_map(torch.from_numpy, g), ts, lr,
                                wd)
        assert int(js.step) == ts.step, step
        assert bool(jst["found_inf"]) == tst["found_inf"], step
        assert float(jst["loss_scale"]) == tst["loss_scale"], step
        assert float(js.grad_scaler.scale) == ts.grad_scaler.scale, step
        if not tst["found_inf"]:
            np.testing.assert_allclose(float(tst["grad_norm"]),
                                       float(jst["grad_norm"]), rtol=1e-6)
        _close(_np(tp), _np(jp), pdt != "fp32", f"{case} params {step}")
        _close(_np(ts.master_params), _np(js.master_params), False,
               f"{case} masters {step}")
        _close(_np(ts.exp_avg), _np(js.exp_avg), bf16, f"{case} m {step}")
        _close(_np(ts.exp_avg_sq), _np(js.exp_avg_sq), bf16,
               f"{case} v {step}")


def test_inf_step_changes_nothing_but_the_scaler():
    cfg = TrainConfig(fp16=True, initial_loss_scale=4.0, hysteresis=1)
    opt = MegatronOptimizer(cfg, params_dtype=torch.float16)
    params = tree_map(lambda a: torch.from_numpy(a).half(), _params_np())
    before = _np(params)
    state = opt.init(params)
    g = _grads_np(0, _params_np(), inf_at=0)
    params, state2, stats = opt.step(params, tree_map(torch.from_numpy, g),
                                     state, 0.1)
    assert stats["found_inf"] and state2.step == 0
    assert state2.grad_scaler.scale == 2.0
    _close(_np(params), before, False, "params")


def test_global_grad_norm_matches_jax():
    g = _grads_np(3, _params_np(), scale=2.0)
    want = float(jax_global_grad_norm(jax.tree_util.tree_map(jnp.asarray,
                                                             g)))
    got = float(global_grad_norm(tree_map(torch.from_numpy, g)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_grad_scalers_match_jax():
    jsc = JaxDynamic(initial_scale=2.0 ** 10, min_scale=4.0,
                     growth_interval=3, hysteresis=2)
    tsc = DynamicGradScaler(initial_scale=2.0 ** 10, min_scale=4.0,
                            growth_interval=3, hysteresis=2)
    js, ts = jsc.init(), tsc.init()
    pattern = [0, 0, 0, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0]
    for i, inf in enumerate(pattern):
        js = jsc.update(js, jnp.bool_(inf))
        ts = tsc.update(ts, bool(inf))
        assert (float(js.scale), int(js.growth_tracker),
                int(js.hysteresis_tracker)) == tuple(ts), i
    const = ConstantGradScaler(16.0)
    assert const.update(const.init(), True).scale == 16.0


@pytest.mark.parametrize("kw", [
    dict(max_lr=1.0, min_lr=0.1, lr_warmup_steps=3, lr_decay_steps=10,
         lr_decay_style="cosine", start_wd=0.0, end_wd=0.1,
         wd_incr_steps=10, wd_incr_style="linear"),
    dict(max_lr=2.0, lr_warmup_steps=2, lr_decay_steps=8,
         lr_decay_style="inverse-square-root"),
    dict(max_lr=1.0, min_lr=0.5, lr_decay_steps=6, lr_decay_style="linear",
         start_wd=0.1, end_wd=0.01, wd_incr_steps=6,
         wd_incr_style="cosine"),
])
def test_scheduler_matches_jax_and_round_trips(kw):
    js, ts = JaxScheduler(**kw), OptimizerParamScheduler(**kw)
    for _ in range(12):
        assert ts.step(1) == pytest.approx(js.step(1), rel=1e-12)
    sd = ts.state_dict()
    assert sd == js.state_dict()
    fresh = OptimizerParamScheduler(**kw)
    fresh.load_state_dict(sd)
    assert fresh.state_dict() == sd
    assert fresh.get_lr() == ts.get_lr() and fresh.get_wd() == ts.get_wd()


def test_train_config_matches_jax_fields():
    jf = {f.name: f.default for f in dataclasses.fields(JaxTrainConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    assert tf == jf
