"""The port's checkpoints (megatron_llm_torch/checkpointing.py) against the
JAX package's: save -> load gives every leaf back bit for bit (bf16 and
fp32 params, the optimizer state of Adam and SGD with masters and a
dynamic loss scaler) with the scheduler's state; the port's manifest of a
tiny model and of its optimizer state equals the JAX package's
``_tree_manifest`` key for key; a checkpoint the JAX package writes
(orbax, here in the test only) and loads, carried by ``params_from_jax``
through a port save/load, gives the JAX logits (fp32, atol 1e-5), and the
port's params carried back by ``params_to_numpy`` through a JAX save/load
give the port's logits; and the hardening cases of
tests/test_checkpoint_hardening.py, each a case of one test."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu import checkpointing as jax_ck
from megatron_llm_tpu.config import TrainConfig as JaxTrainConfig
from megatron_llm_tpu.models.llama import LlamaModel as JaxLlama
from megatron_llm_tpu.models.llama import llama_config as jax_llama_config
from megatron_llm_tpu.optimizer import MegatronOptimizer as JaxOptimizer
from megatron_llm_torch import checkpointing as ck
from megatron_llm_torch.config import TrainConfig
from megatron_llm_torch.models.language_model import (
    init_language_model_params,
)
from megatron_llm_torch.models.llama import LlamaModel, llama_config
from megatron_llm_torch.optimizer import (
    MegatronOptimizer,
    OptimizerParamScheduler,
)
from megatron_llm_torch.tree import tree_leaves_with_path, tree_map
from megatron_llm_torch.weights import params_from_jax, params_to_numpy

torch.set_num_threads(1)
KW = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
          ffn_hidden_size=96, padded_vocab_size=64, seq_length=16,
          max_position_embeddings=16)


@pytest.fixture(autouse=True)
def _save_config():
    ck.configure_save(total_limit=0, retries=2, retry_backoff=0.01)
    ck.counters["save_retries"] = 0
    yield
    ck.configure_save(total_limit=0, retries=2, retry_backoff=0.25)


def _model(dtype="fp32", seed=3):
    cfg = llama_config("tiny", params_dtype=dtype, **KW)
    model = LlamaModel(cfg, device="cpu")
    return model, model.init(seed)


def _scheduler():
    return OptimizerParamScheduler(max_lr=1e-3, min_lr=1e-5,
                                   lr_warmup_steps=2, lr_decay_steps=20,
                                   lr_decay_style="cosine")


def _stepped_state(params, tc, steps=2):
    dtype = next(iter(tree_leaves_with_path(params)))[1].dtype
    opt = MegatronOptimizer(tc, params_dtype=dtype)
    state = opt.init(params)
    gen = torch.Generator().manual_seed(0)
    for _ in range(steps):
        grads = tree_map(lambda p: torch.randn(p.shape, generator=gen),
                         params)
        params, state, _ = opt.step(params, grads, state, 1e-3, 0.01)
    return opt, params, state


def _same(a, b):
    la, lb = tree_leaves_with_path(a), tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert torch.equal(x.view(-1).view(torch.uint8) if x.numel() else x,
                           y.view(-1).view(torch.uint8) if y.numel() else y
                           ), path


ROUND_TRIPS = {
    "bf16_adam": ("bf16", dict(bf16=True)),
    "fp32_adam": ("fp32", dict()),
    "fp32_sgd": ("fp32", dict(optimizer="sgd")),
    "bf16_adam_bf16_moments": ("bf16", dict(bf16=True,
                                            optimizer_state_dtype="bf16")),
    "dynamic_loss_scale": ("bf16", dict(fp16=True, hysteresis=3)),
}


@pytest.mark.parametrize("case", sorted(ROUND_TRIPS))
def test_save_load_is_bitwise(tmp_path, case):
    dtype, tc_kw = ROUND_TRIPS[case]
    model, params = _model(dtype)
    opt, params, state = _stepped_state(params, TrainConfig(**tc_kw))
    sched = _scheduler()
    sched.step(3)
    ck.save_checkpoint(str(tmp_path), 5, params, state, sched,
                       args=ck.config_to_args(model.cfg),
                       consumed_samples=40)
    template = init_language_model_params(None, model.cfg, device="meta")
    sched2 = _scheduler()
    p2, s2, meta = ck.load_checkpoint(
        str(tmp_path), params_template=template,
        opt_state_template=opt.init(template), scheduler=sched2,
        device="cpu")
    _same(params, p2)
    assert s2.step == state.step == 2
    assert s2.grad_scaler == state.grad_scaler
    for name in ("master_params", "exp_avg", "exp_avg_sq"):
        a, b = getattr(state, name), getattr(s2, name)
        assert (a is None) == (b is None)
        if a is not None:
            _same(a, b)
    assert sched2.state_dict() == sched.state_dict()
    assert (meta["iteration"], meta["consumed_samples"]) == (5, 40)
    assert meta["args"]["hidden_size"] == 64
    # finetune: params only, iteration and samples reset
    p3, s3, meta3 = ck.load_checkpoint(str(tmp_path), finetune=True,
                                       opt_state_template=opt.init(template),
                                       device="cpu")
    _same(params, p3)
    assert s3 is None and meta3["iteration"] == meta3["consumed_samples"] == 0


def _jax_pair(dtype):
    kw = dict(KW, use_flash_attn=False)
    jmodel = JaxLlama(jax_llama_config("tiny", **kw))
    jparams = jmodel.init(jax.random.PRNGKey(7))
    tdtype = None
    if dtype == "bf16":
        jparams = jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16),
                                         jparams)
        tdtype = torch.bfloat16
    tcfg = llama_config("tiny", params_dtype=dtype, use_flash_attn=False,
                        **KW)
    tparams = params_from_jax(jax.device_get(jparams), tcfg, dtype=tdtype,
                              device="cpu")
    return jmodel, jparams, LlamaModel(tcfg, device="cpu"), tparams


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_manifest_equals_the_jax_manifest(dtype):
    _, jparams, _, tparams = _jax_pair(dtype)
    assert ck._tree_manifest(tparams) == jax_ck._tree_manifest(jparams)
    bf16 = dtype == "bf16"
    jstate = JaxOptimizer(JaxTrainConfig(bf16=bf16),
                          params_dtype=jnp.bfloat16 if bf16
                          else jnp.float32).init(jparams)
    tstate = MegatronOptimizer(TrainConfig(bf16=bf16),
                               params_dtype=torch.bfloat16 if bf16
                               else torch.float32).init(tparams)
    want = jax_ck._tree_manifest(jax_ck._opt_state_to_tree(jstate))
    got = ck._tree_manifest(ck._opt_state_to_tree(tstate))
    assert got == want
    assert any(k.startswith("['exp_avg']") for k in got)
    assert (got["['step']"], got["['grad_scaler']['scale']"]) == (
        {"shape": [], "dtype": "int32"}, {"shape": [], "dtype": "float32"})


def _tokens():
    return np.random.RandomState(11).randint(0, 64, (2, 16)).astype(np.int32)


def test_jax_checkpoint_through_the_port(tmp_path):
    jmodel, jparams, tmodel, _ = _jax_pair("fp32")
    jax_ck.save_checkpoint(str(tmp_path / "jax"), 3, jparams)
    loaded, _, meta = jax_ck.load_checkpoint(str(tmp_path / "jax"))
    assert meta["iteration"] == 3
    tparams = params_from_jax(jax.device_get(loaded), tmodel.cfg,
                              device="cpu")
    ck.save_checkpoint(str(tmp_path / "torch"), 3, tparams)
    template = init_language_model_params(None, tmodel.cfg, device="meta")
    back, _, _ = ck.load_checkpoint(str(tmp_path / "torch"),
                                    params_template=template, device="cpu")
    # the port's manifest is the one the JAX package wrote
    manifests = [json.loads((tmp_path / d / "iter_0000003" / "meta.json")
                            .read_text())["manifest"]["model"]
                 for d in ("torch", "jax")]
    assert manifests[0] == manifests[1]
    toks = _tokens()
    want = np.asarray(jmodel(jparams, jnp.asarray(toks)))
    with torch.no_grad():
        got = tmodel(back, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_port_checkpoint_through_the_jax_package(tmp_path):
    jmodel, _, tmodel, _ = _jax_pair("fp32")
    _, tparams = _model("fp32", seed=9)
    tparams = params_from_jax(params_to_numpy(tparams), tmodel.cfg,
                              device="cpu")
    ck.save_checkpoint(str(tmp_path / "torch"), 2, tparams)
    back, _, _ = ck.load_checkpoint(str(tmp_path / "torch"), device="cpu")
    jax_ck.save_checkpoint(str(tmp_path / "jax"), 2,
                           jax.tree_util.tree_map(jnp.asarray,
                                                  params_to_numpy(back)))
    jparams, _, _ = jax_ck.load_checkpoint(str(tmp_path / "jax"))
    toks = _tokens()
    want = np.asarray(jmodel(jparams, jnp.asarray(toks)))
    with torch.no_grad():
        got = tmodel(tparams, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# hardening: the cases of tests/test_checkpoint_hardening.py
# ---------------------------------------------------------------------------

def _params(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(4, 4, generator=gen),
            "b": torch.randn(4, generator=gen)}


def _tracker(d):
    return ck.get_checkpoint_tracker_filename(str(d))


def _save(d, it, seed=None):
    ck.save_checkpoint(str(d), it, _params(it if seed is None else seed))


def _atomic_save(d):
    _save(d, 7)
    assert (d / "iter_0000007").is_dir() and not list(d.glob("*.tmp"))
    ok, reason = ck.validate_checkpoint_dir(d / "iter_0000007")
    assert ok, reason
    # a stale tmp dir of a killed save is never considered, and the next
    # save of that iteration replaces it
    (d / "iter_0000009.tmp").mkdir()
    pl, _, meta = ck.load_checkpoint(str(d), device="cpu")
    assert meta["iteration"] == 7 and torch.equal(pl["w"], _params(7)["w"])
    _save(d, 9)
    assert not (d / "iter_0000009.tmp").exists()
    assert ck.read_tracker(str(d)) == (9, False)


def _tamper_detection(d):
    _save(d, 1)
    meta_path = d / "iter_0000001" / "meta.json"
    meta = json.loads(meta_path.read_text())
    meta["manifest"]["model"]["['w']"]["shape"] = [9, 9]
    meta_path.write_text(json.dumps(meta))
    ok, reason = ck.validate_checkpoint_dir(d / "iter_0000001")
    assert not ok and "checksum" in reason


def _shape_mismatch(d):
    _save(d, 1)
    meta_path = d / "iter_0000001" / "meta.json"
    meta = json.loads(meta_path.read_text())
    meta["manifest"]["model"]["['w']"]["shape"] = [9, 9]
    meta["manifest_sha256"] = ck._manifest_sha256(meta["manifest"])
    meta_path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="mismatches its manifest"):
        ck.load_checkpoint(str(d), device="cpu")
    # and a payload that does not fit the model's tree or its shapes
    _save(d, 2)
    with pytest.raises(ValueError, match="does not match the model"):
        ck.load_checkpoint(str(d), device="cpu", iteration=2,
                           params_template={"w": torch.empty(4, 4)})
    with pytest.raises(ValueError, match=r"has shape \[4, 4\]"):
        ck.load_checkpoint(str(d), device="cpu", iteration=2,
                           params_template={"w": torch.empty(5, 4),
                                            "b": torch.empty(4)})


def _corrupt_tracker(d):
    it, release = ck.read_tracker(str(d))       # no tracker
    assert it is None and not release
    for text, want in (("", (None, False)), ("garbage\n", (None, False)),
                       (" 12 \n", (12, False)), ("release", (None, True))):
        with open(_tracker(d), "w") as f:
            f.write(text)
        assert ck.read_tracker(str(d)) == want
    _save(d, 1)
    _save(d, 2)
    with open(_tracker(d), "w") as f:
        f.write("not-a-number")
    pl, _, meta = ck.load_checkpoint(str(d), device="cpu")
    assert meta["iteration"] == 2 and torch.equal(pl["w"], _params(2)["w"])
    # the tracked checkpoint rots: the previous one is loaded
    with open(_tracker(d), "w") as f:
        f.write("2")
    (d / "iter_0000002" / "meta.json").write_text("{ truncated")
    pl, _, meta = ck.load_checkpoint(str(d), device="cpu")
    assert meta["iteration"] == 1 and torch.equal(pl["w"], _params(1)["w"])


def _no_valid_checkpoint(d):
    with open(_tracker(d), "w") as f:
        f.write("5")                    # dangling tracker, no payload
    assert ck.load_checkpoint(str(d), device="cpu") == (None, None, None)


def _explicit_iteration_not_substituted(d):
    _save(d, 1)
    _save(d, 2)
    (d / "iter_0000002" / "meta.json").unlink()
    _, _, meta = ck.load_checkpoint(str(d), device="cpu")
    assert meta["iteration"] == 1
    with pytest.raises(FileNotFoundError):
        ck.load_checkpoint(str(d), iteration=2, device="cpu")


def _total_limit(d):
    ck.configure_save(total_limit=2)
    for i in range(1, 5):
        _save(d, i)
    assert sorted(p.name for p in d.glob("iter_*")) == [
        "iter_0000003", "iter_0000004"]
    assert ck.load_checkpoint(str(d), device="cpu")[2]["iteration"] == 4
    ck.configure_save(total_limit=0)
    for i in range(5, 8):
        _save(d, i)
    assert len(list(d.glob("iter_*"))) == 5


def _retries(d):
    real = ck._write_tree
    calls = {"n": 0}

    def flaky(path, tree):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise IOError("transient")
        return real(path, tree)

    ck.configure_save(retries=3, retry_backoff=0.01)
    ck._write_tree = flaky
    try:
        _save(d, 4)
    finally:
        ck._write_tree = real
    assert ck.counters["save_retries"] == 2
    assert ck.validate_checkpoint_dir(d / "iter_0000004")[0]


def _retry_exhaustion(d):
    real = ck._write_tree

    def always_fail(path, tree):
        raise IOError("storage is gone")

    ck.configure_save(retries=1, retry_backoff=0.01)
    ck._write_tree = always_fail
    try:
        with pytest.raises(IOError):
            _save(d, 4)
    finally:
        ck._write_tree = real
    assert ck.counters["save_retries"] == 1
    assert not (d / "iter_0000004").exists()
    assert not os.path.exists(_tracker(d))


def _async_save_raises(d):
    with pytest.raises(NotImplementedError):
        ck.save_checkpoint(str(d), 1, _params(), async_save=True)
    assert not list(d.iterdir())


HARDENING = {f.__name__.lstrip("_"): f for f in (
    _atomic_save, _tamper_detection, _shape_mismatch, _corrupt_tracker,
    _no_valid_checkpoint, _explicit_iteration_not_substituted, _total_limit,
    _retries, _retry_exhaustion, _async_save_raises)}


@pytest.mark.parametrize("case", sorted(HARDENING))
def test_hardening(tmp_path, case):
    HARDENING[case](tmp_path)
