"""The port's fault-tolerance runtime (megatron_llm_torch/resilience.py)
against the JAX package's: the injector and sentinel cases of the JAX
tests run against both packages; a snapshot taken before two in-place
optimizer steps is given back bit for bit by a rewind (the snapshot owns
its host buffers); ``pretrain`` with ``nan@3`` gives the JAX loop's
per-iteration losses, rewinds and skipped iterations (fp32, atol 1e-5);
a SIGTERM save resumes bit for bit against an uninterrupted run and with
the JAX run's losses; the watchdog fires once and its rescue checkpoint
loads, in the loop and (with its hard exit) through ``finetune`` in a
subprocess.  Watchdogs of 2 s against 5 s hangs."""

import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu import checkpointing as jax_ck
from megatron_llm_tpu import global_vars as jax_global_vars
from megatron_llm_tpu import resilience as jax_res
from megatron_llm_tpu.config import ParallelConfig as JaxParallelConfig
from megatron_llm_tpu.config import TrainConfig as JaxTrainConfig
from megatron_llm_tpu.models.llama import LlamaModel as JaxLlama
from megatron_llm_tpu.models.llama import llama_config as jax_llama_config
from megatron_llm_tpu.parallel import sharding as sh
from megatron_llm_tpu.training import pretrain as jax_pretrain
from megatron_llm_torch import checkpointing, global_vars
from megatron_llm_torch import resilience as res
from megatron_llm_torch.config import ParallelConfig, TrainConfig
from megatron_llm_torch.dist_signal_handler import DistributedSignalHandler
from megatron_llm_torch.models.llama import LlamaModel, llama_config
from megatron_llm_torch.models.language_model import (
    init_language_model_params,
)
from megatron_llm_torch.optimizer import MegatronOptimizer
from megatron_llm_torch.training import pretrain
from megatron_llm_torch.tree import tree_leaves, tree_leaves_with_path
from megatron_llm_torch.weights import params_from_jax

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
KW = dict(seq_length=16, max_position_embeddings=16, padded_vocab_size=64,
          num_layers=2, hidden_size=32, num_attention_heads=4,
          ffn_hidden_size=64)


@pytest.fixture(autouse=True)
def _clean_state():
    for mod, ck in ((jax_res, jax_ck), (res, checkpointing)):
        ck.configure_save(total_limit=0, retries=2, retry_backoff=0.01)
    jax_global_vars.reset_counters()
    global_vars.reset_counters()
    yield
    for mod, ck in ((jax_res, jax_ck), (res, checkpointing)):
        mod.set_save_fault_hook(None)
        ck.configure_save(total_limit=0, retries=2, retry_backoff=0.25)
    jax_global_vars.reset_counters()
    global_vars.reset_counters()


# -- the JAX tests' unit cases, against both packages ------------------------

def _arr(mod, a):
    return jnp.asarray(a) if mod is jax_res else torch.tensor(a)


BOTH = pytest.mark.parametrize("mod", [jax_res, res], ids=["jax", "port"])


@BOTH
def test_fault_injector_spec_parsing(mod):
    inj = mod.FaultInjector.from_spec("nan@3,save_io*2,hang@5:2.0,sigterm@7")
    assert inj.nan_iters == {3}
    assert inj.save_io_failures == 2
    assert inj.hang_at == 5 and inj.hang_secs == 2.0
    assert inj.sigterm_at == 7
    assert mod.FaultInjector.from_spec("") is None
    assert mod.FaultInjector.from_spec(None) is None
    assert mod.FaultInjector.from_spec("hang@4").hang_secs == 1.0
    with pytest.raises(ValueError):
        mod.FaultInjector.from_spec("explode@9")


@BOTH
def test_fault_injector_poison_once_and_save_io_budget(mod):
    inj = mod.FaultInjector.from_spec("nan@2,save_io*1")
    batch = {"loss_mask": _arr(mod, np.ones((2, 2), np.float32))}
    assert inj.poison_batch(1, batch) is batch
    poisoned = inj.poison_batch(2, batch)
    assert np.all(np.isnan(np.asarray(poisoned["loss_mask"])))
    assert np.all(np.asarray(batch["loss_mask"]) == 1.0)
    assert inj.poison_batch(2, batch) is batch
    with pytest.raises(IOError):
        inj.maybe_fail_save()
    inj.maybe_fail_save()


@BOTH
def test_sentinel_flags_nonfinite_and_spike(mod):
    rm = mod.ResilienceManager(mod.ResilienceConfig(spike_factor=3.0,
                                                    patience=1))
    assert not rm.record_metrics(1, 1.0)
    assert not rm.record_metrics(2, 1.1)
    assert rm.record_metrics(3, float("nan"))
    assert rm.record_metrics(4, 1.0, grad_norm=float("inf"))
    assert rm.record_metrics(5, 50.0)
    assert not rm.should_rewind()


@BOTH
def test_sentinel_patience_and_streak_reset(mod):
    rm = mod.ResilienceManager(mod.ResilienceConfig(spike_factor=0.0,
                                                    patience=2))
    rm.take_snapshot(0, {"w": _arr(mod, np.zeros((2,), np.float32))}, None)
    rm.record_metrics(1, 1.0)
    assert rm.record_metrics(2, float("nan"))
    assert not rm.should_rewind()
    rm.record_metrics(3, 1.0)
    assert rm.record_metrics(4, float("nan"))
    assert not rm.should_rewind()
    assert rm.record_metrics(5, float("nan"))
    assert rm.should_rewind()


@BOTH
def test_snapshot_rejects_nonfinite_params(mod):
    rm = mod.ResilienceManager(mod.ResilienceConfig())
    good = {"w": _arr(mod, np.ones((2, 2), np.float32))}
    bad = {"w": _arr(mod, np.full((2, 2), np.nan, np.float32))}
    assert rm.take_snapshot(1, good, None)
    assert rm.snapshot_iteration == 1
    assert not rm.take_snapshot(2, bad, None)
    assert rm.snapshot_iteration == 1


@BOTH
def test_rewind_restores_snapshot_and_scales_lr(mod):
    rm = mod.ResilienceManager(mod.ResilienceConfig(
        patience=1, rewind_lr_factor=0.5, spike_factor=0))
    rm.take_snapshot(3, {"w": _arr(mod, np.ones((2, 2), np.float32))}, None)
    live = {"w": _arr(mod, np.full((2, 2), 7.0, np.float32))}
    rm.record_metrics(4, float("nan"))
    assert rm.should_rewind()
    p, o, it = rm.rewind(live, None)
    assert it == 3 and o is None
    np.testing.assert_array_equal(np.asarray(p["w"]), np.ones((2, 2)))
    assert rm.lr_scale == 0.5
    assert mod.recovery_counters()["rewinds"] == 1


@BOTH
def test_rewind_hard_stops_at_max_rewinds(mod):
    rm = mod.ResilienceManager(mod.ResilienceConfig(
        patience=1, max_rewinds=1, spike_factor=0))
    p0 = {"w": _arr(mod, np.zeros((2,), np.float32))}
    rm.take_snapshot(0, p0, None)
    rm.rewind(p0, None)
    with pytest.raises(RuntimeError, match="max_rewinds"):
        rm.rewind(p0, None)


@BOTH
def test_watchdog_fires_and_dumps(mod):
    fired, lines = [], []
    wd = mod.HangWatchdog(timeout_secs=0.15, on_fire=lambda: fired.append(1),
                          hard_exit=False, poll_interval=0.03,
                          printer=lines.append)
    wd.start()
    try:
        deadline = time.monotonic() + 3.0
        while not wd.fired and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        wd.stop()
    assert wd.fired and fired == [1]
    assert wd.last_dump and "python stacks" in wd.last_dump
    assert any("device memory" in line for line in lines)
    assert mod.recovery_counters()["watchdog_fires"] == 1


@BOTH
def test_watchdog_progress_and_pause_prevent_fire(mod):
    wd = mod.HangWatchdog(timeout_secs=0.25, hard_exit=False,
                          poll_interval=0.03, printer=lambda s: None)
    wd.start()
    try:
        for _ in range(8):
            time.sleep(0.05)
            wd.progress()
        assert not wd.fired
        wd.pause()
        time.sleep(0.4)
        assert not wd.fired
    finally:
        wd.stop()


@pytest.mark.parametrize("consensus", [False, True])
def test_signals_received_single_process(consensus):
    with DistributedSignalHandler() as h:
        assert h.signals_received(consensus=consensus) is False
        os.kill(os.getpid(), signal.SIGTERM)
        assert h.signals_received(consensus=consensus) is True


# -- the snapshot owns its bits ----------------------------------------------

def test_rewind_gives_back_the_snapshot_after_in_place_steps():
    """Two in-place optimizer steps after the snapshot change every live
    tensor; the rewind restores the snapshot's bits into the same
    tensors (a snapshot that aliased the live tensors — ``t.cpu()`` on
    a CPU tensor — would give back the stepped values)."""
    cfg = llama_config("tiny", **KW)
    params = tree_map_bf16(LlamaModel(cfg, device="cpu").init(0))
    opt = MegatronOptimizer(TrainConfig(micro_batch_size=1,
                                        global_batch_size=1, lr=1e-2),
                            params_dtype=torch.bfloat16)
    state = opt.init(params)
    params, state, _ = opt.step(params, _grads(params, 0), state, 1e-2)
    rm = res.ResilienceManager(res.ResilienceConfig(spike_factor=0))
    assert rm.take_snapshot(1, params, state)
    want = _state_bits(params, state)
    ids = [id(t) for t in _live(params, state)]
    for i in (1, 2):
        params, state, _ = opt.step(params, _grads(params, i), state, 1e-2)
    assert state.step == 3
    assert _state_bits(params, state) != want
    p2, s2, it = rm.rewind(params, state)
    assert it == 1 and p2 is params and s2.step == 1
    assert [id(t) for t in _live(p2, s2)] == ids     # the same tensors
    assert _state_bits(p2, s2) == want


def tree_map_bf16(tree):
    from megatron_llm_torch.tree import tree_map
    return tree_map(lambda t: t.to(torch.bfloat16), tree)


def _grads(params, seed):
    g = torch.Generator().manual_seed(seed)
    from megatron_llm_torch.tree import tree_map
    return tree_map(lambda p: torch.randn(p.shape, generator=g), params)


def _live(params, state):
    return [t for tree in (params, state.master_params, state.exp_avg,
                           state.exp_avg_sq) for t in tree_leaves(tree)]


def _state_bits(params, state):
    return [t.view(torch.int16 if t.element_size() == 2 else torch.int32)
            .flatten().tolist() for t in _live(params, state)] + \
        [state.step, tuple(state.grad_scaler)]


# -- the loop against the JAX loop -------------------------------------------

def _data(shape=(1, 8, 16)):
    """Per-call numpy stream: every call replays the same batches."""
    rng = np.random.RandomState(0)
    while True:
        toks = rng.randint(0, 64, size=shape).astype(np.int32)
        yield {"tokens": toks, "labels": np.roll(toks, -1, axis=-1),
               "loss_mask": np.ones(shape, np.float32)}


def _jax_it():
    return ({k: jnp.asarray(v) for k, v in b.items()} for b in _data())


def _torch_it():
    return ({k: torch.from_numpy(v) for k, v in b.items()} for b in _data())


def _tc(cls, iters):
    return cls(micro_batch_size=8, global_batch_size=8, train_iters=iters,
               lr=1e-3, optimizer="adam", seed=3)


def _both(utils):
    jmodel = JaxLlama(jax_llama_config("tiny", **KW))
    utils.initialize_model_parallel(tp=1)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = llama_config("tiny", **KW)
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    jparams = sh.shard_params(jparams, jmodel.param_specs(jparams))
    return jmodel, jparams, LlamaModel(tcfg, device="cpu"), tparams


def _recorder():
    seen = []

    def on_metrics(it, m):
        seen.append((it, float(m["lm loss"]), int(m["skipped_iter"])))
    return seen, on_metrics


def test_nan_rewind_trajectory_matches_jax(utils):
    jmodel, jparams, tmodel, tparams = _both(utils)
    runs = {}
    for name, mod, model, params, loop, tc, pc, it in (
            ("jax", jax_res, jmodel, jparams, jax_pretrain, JaxTrainConfig,
             JaxParallelConfig, _jax_it),
            ("port", res, tmodel, tparams, pretrain, TrainConfig,
             ParallelConfig, _torch_it)):
        rm = mod.ResilienceManager(
            mod.ResilienceConfig(snapshot_interval=2, patience=1,
                                 spike_factor=0),
            injector=mod.FaultInjector.from_spec("nan@3"))
        seen, on_metrics = _recorder()
        try:
            loop(model, params, _tc(tc, 6), pc(), it(), log_interval=1,
                 resilience=rm, on_metrics=on_metrics)
        finally:
            rm.close()
        runs[name] = (seen, mod.recovery_counters())
    (jseen, jrec), (tseen, trec) = runs["jax"], runs["port"]
    assert trec == jrec and trec["rewinds"] == 1
    assert [s[::2] for s in tseen] == [s[::2] for s in jseen]
    np.testing.assert_allclose([s[1] for s in tseen],
                               [s[1] for s in jseen], atol=ATOL, rtol=0)


def test_signal_save_resumes_bitwise_and_with_jax_losses(utils, tmp_path):
    jmodel, jparams, tmodel, tparams = _both(utils)
    seen_j, on_j = _recorder()
    jax_pretrain(jmodel, jparams, _tc(JaxTrainConfig, 5),
                 JaxParallelConfig(), _jax_it(), log_interval=1,
                 on_metrics=on_j)

    p_straight, _, _ = pretrain(tmodel, tparams, _tc(TrainConfig, 5),
                                ParallelConfig(), _torch_it(),
                                log_interval=0)
    _, _, tmodel, tparams = _both(utils)       # the same params again
    rm = res.ResilienceManager(
        res.ResilienceConfig(), rewind_enabled=False,
        injector=res.FaultInjector.from_spec("sigterm@3"))
    with DistributedSignalHandler() as handler:
        with pytest.raises(SystemExit) as exc:
            try:
                pretrain(tmodel, tparams, _tc(TrainConfig, 5),
                         ParallelConfig(), _torch_it(), log_interval=1,
                         save_dir=str(tmp_path), exit_signal_handler=handler,
                         resilience=rm, async_save=True)
            finally:
                rm.close()
    assert exc.value.code == 0
    assert res.recovery_counters()["signal_saves"] == 1
    tmpl = init_language_model_params(None, tmodel.cfg, device="meta")
    pl, _, meta = checkpointing.load_checkpoint(
        str(tmp_path), params_template=tmpl, device="cpu")
    opt = MegatronOptimizer(_tc(TrainConfig, 5))
    scheduler_meta = meta["opt_param_scheduler"]
    _, ol, _ = checkpointing.load_checkpoint(
        str(tmp_path), load_params=False,
        opt_state_template=opt.init(tmpl), device="cpu")
    assert meta["iteration"] == 3 and meta["consumed_samples"] == 24
    assert scheduler_meta["num_steps"] == 3
    gen = _torch_it()
    for _ in range(3):
        next(gen)
    seen_t, on_t = _recorder()
    p_resumed, _, n = pretrain(tmodel, pl, _tc(TrainConfig, 5),
                               ParallelConfig(), gen, log_interval=1,
                               start_iteration=3, opt_state=ol,
                               optimizer=opt, on_metrics=on_t,
                               consumed_samples=meta["consumed_samples"])
    assert n == 5
    for (path, a), (_, b) in zip(tree_leaves_with_path(p_resumed),
                                 tree_leaves_with_path(p_straight)):
        assert torch.equal(a, b), path
    np.testing.assert_allclose([s[1] for s in seen_t],
                               [s[1] for s in seen_j[3:]], atol=ATOL, rtol=0)


def test_watchdog_rescue_save_in_pretrain(tmp_path):
    cfg = llama_config("tiny", **KW)
    model = LlamaModel(cfg, device="cpu")
    params = model.init(0)
    lines = []
    wd = res.HangWatchdog(timeout_secs=2.0, hard_exit=False,
                          printer=lines.append)
    rm = res.ResilienceManager(
        res.ResilienceConfig(snapshot_interval=1),
        injector=res.FaultInjector.from_spec("hang@3:5.0"), watchdog=wd)
    try:
        pretrain(model, params, _tc(TrainConfig, 4), ParallelConfig(),
                 _torch_it(), log_interval=1, save_dir=str(tmp_path),
                 resilience=rm)
    finally:
        rm.close()
    assert res.recovery_counters()["watchdog_fires"] == 1
    assert any("before_iteration" in line for line in lines)  # the sleeper
    tmpl = init_language_model_params(None, cfg, device="meta")
    pl, _, meta = checkpointing.load_checkpoint(
        str(tmp_path), iteration=2, params_template=tmpl, device="cpu")
    assert pl is not None and meta["iteration"] == 2


def test_watchdog_hard_exit_through_finetune(tmp_path):
    """``--watchdog_timeout_secs 2`` against a 5 s hang: one fire, the
    stack dump names the sleeping frame, the rescue checkpoint
    validates and loads, and the process exits with the JAX code."""
    argv = [sys.executable, "-m", "megatron_llm_torch.finetune",
            "--model_name=llama2", "--num_layers=2", "--hidden_size=32",
            "--num_attention_heads=4", "--seq_length=16",
            "--max_position_embeddings=16", "--micro_batch_size=2",
            "--global_batch_size=2", "--train_iters=6", "--lr=1e-3",
            "--vocab_size=64", "--log_interval=1", "--device", "cpu",
            "--save", str(tmp_path / "ck"), "--rewind_on_spike",
            "--snapshot_interval", "2", "--watchdog_timeout_secs", "2",
            "--fault_inject", "hang@5:5"]
    proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    out = proc.stdout + proc.stderr
    assert proc.returncode == res.PREEMPT_EXIT_CODE == 17, out[-3000:]
    assert out.count("[watchdog] no iteration completed") == 1
    assert "in before_iteration" in out and "time.sleep" in out
    d = tmp_path / "ck" / "iter_0000004"
    assert checkpointing.validate_checkpoint_dir(d) == (True, "ok")
    params, _, meta = checkpointing.load_checkpoint(
        str(tmp_path / "ck"), iteration=4, device="cpu")
    assert params is not None and meta["iteration"] == 4
