"""The port's pipeline (``megatron_llm_torch/parallel/pipeline.py``)
against the JAX package's unpipelined loss and ``jax.grad``.

Worlds of gloo ranks on the CPU (``_torch_tp_world.py``, task ``pp``):
one of 2 ranks (pp 2) and one of 4 (pp 4, pp 2 x tp 2 with sequence
parallelism, pp 2 x dp 2).  Each rank holds its stage's rows of the JAX
package's params (stage-major under vpp) and runs an engine on the same
global batch; the parent test computes the JAX side as
``test_pipeline.py`` holds the JAX engines: the model's per-token loss
micro batch by micro batch, the masked sum over the token count, and
``jax.grad`` of it, on one device.  No test here runs a JAX pipeline
engine under a mesh.  Held: the loss within 1e-4 and every fp32 grad
within 2e-5 (the stages' rows put back in natural order), for

* 1F1B at pp 2, at pp 4 and at pp 2 x tp 2 + SP;
* the stream schedule at pp 2 x vpp 2 (also at tp 2 + SP) and at pp 2 x
  vpp 4 (8 layers);
* Falcon's tied embedding under both engines (the head's grad joins the
  word table's over the stages);
* the MoE at pp 2 under both engines, against the JAX objective with
  the routing aux's mean over the micro batches;
* a loss mask that differs by row (the objective is the global batch's
  token mean, not a mean of micro-batch means).

Also: 1F1B and the stream schedule with dropout on and one key give the
same loss and grads (the recompute replays the forward's masks); one
train step at pp 2 x dp 2 under ZeRO-1 gives the JAX package's
one-device ``build_train_step`` update; the 1F1B engine's live bytes at
tick boundaries (its stash and received activations) and its peak of
tensors saved for backward at M 8 stay within 15% of M 2; the
point-to-point sends are counted by route; ``mappings.permute`` rotates
as ``lax.ppermute`` does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_tp_world import run_world
from megatron_llm_tpu.config import ParallelConfig as JaxParallelConfig
from megatron_llm_tpu.config import TrainConfig as JaxTrainConfig
from megatron_llm_tpu.models.falcon import FalconModel, falcon_config
from megatron_llm_tpu.models.llama import LlamaModel, llama_config
from megatron_llm_tpu.optimizer import MegatronOptimizer as JaxOptimizer
from megatron_llm_tpu.parallel.pipeline import (
    unpermute_layer_stack as jax_unpermute,
)
from megatron_llm_tpu.training import build_train_step as jax_train_step

torch.set_num_threads(1)
SEQ = 32
VOCAB = 128
LOSS_ATOL = 1e-4
GRAD_ATOL = 2e-5
PARAM_ATOL = 1e-5


def _batch(M, mb, seed=0, masked=False, seq=SEQ):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, VOCAB, (M, mb, seq)).astype(np.int32)
    mask = np.ones(toks.shape, np.float32)
    if masked:
        keep = rng.uniform(0.1, 0.9, (M, mb, 1))
        mask = (rng.uniform(size=toks.shape) < keep).astype(np.float32)
        mask[:, 0, :4] = 1.0
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=-1),
            "loss_mask": mask}


# family -> (JAX model class, its config, the port's family name)
FAMILIES = {"llama": (LlamaModel, llama_config, "llama"),
            "falcon": (FalconModel, falcon_config, "falcon"),
            "moe": (LlamaModel, llama_config, "llama")}
MOE = dict(num_experts=4, moe_top_k=2, moe_capacity_factor=8.0)


def _over(family, layers, **kw):
    over = dict(num_layers=layers, padded_vocab_size=VOCAB, **kw)
    if family == "moe":
        over.update(MOE)
    return over


def _jax_model(family, over):
    model_cls, cfg_fn, _ = FAMILIES[family]
    return model_cls(cfg_fn("tiny", seq_length=SEQ,
                            max_position_embeddings=SEQ,
                            use_flash_attn=False, **over))


def _objective(model, params, batch):
    """The pipelined objective on one device: the masked CE sum over the
    global batch's token count (plus, for a mixture of experts, the
    routing aux's mean over the micro batches with its coefficients);
    returns (objective, (loss, aux or None))."""
    cfg = model.cfg
    tot, den = 0.0, 0.0
    aux_sum = jnp.zeros((2,), jnp.float32)
    M = batch["tokens"].shape[0]
    for i in range(M):
        out = model(params, jnp.asarray(batch["tokens"][i]),
                    labels=jnp.asarray(batch["labels"][i]), train=False)
        if cfg.num_experts > 1:
            out, aux = out
            aux_sum = aux_sum + aux
        mask = jnp.asarray(batch["loss_mask"][i])
        tot = tot + jnp.sum(out * mask)
        den = den + jnp.sum(mask)
    loss = tot / den
    if cfg.num_experts <= 1:
        return loss, (loss, None)
    aux_mean = aux_sum / M
    return (loss + cfg.moe_aux_loss_coeff * aux_mean[0]
            + cfg.moe_z_loss_coeff * aux_mean[1]), (loss, aux_mean)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], prefix + (k,)))
        return out
    return {prefix: np.asarray(tree, np.float32)}


def _grad_case(family, layers, engine, pp, tp=1, vpp=None, M=4, mb=2,
               masked=False, over=None, **kw):
    over = _over(family, layers, **(over or {}))
    return dict(kind="grad", family=FAMILIES[family][2], over=over,
                engine=engine, pp=pp, tp=tp, vpp=vpp, sp=tp > 1,
                jax_family=family, batch=_batch(M, mb, masked=masked),
                train=dict(micro_batch_size=mb, global_batch_size=M * mb),
                **kw)


CASES_W2 = {
    "1f1b": _grad_case("llama", 4, "1f1b", 2),
    "stream_vpp2": _grad_case("llama", 4, "stream", 2, vpp=2),
    "stream_vpp4": _grad_case("llama", 8, "stream", 2, vpp=4),
    "falcon_1f1b": _grad_case("falcon", 4, "1f1b", 2, M=2, mb=4),
    "falcon_stream": _grad_case("falcon", 4, "stream", 2, M=2, mb=4),
    "moe_1f1b": _grad_case("moe", 2, "1f1b", 2, M=2, mb=4),
    "moe_stream": _grad_case("moe", 2, "stream", 2, M=2, mb=4),
    "mask_1f1b": _grad_case("llama", 4, "1f1b", 2, masked=True),
    "mask_stream_vpp2": _grad_case("llama", 4, "stream", 2, vpp=2,
                                   masked=True),
}
DROPOUT = dict(hidden_dropout=0.1, attention_dropout=0.1)
CASES_W2_PORT = {
    "dropout_1f1b": _grad_case("llama", 4, "1f1b", 2, over=DROPOUT,
                               key=1234, train_mode=True),
    "dropout_stream": _grad_case("llama", 4, "stream", 2, over=DROPOUT,
                                 key=1234, train_mode=True),
    "memory": dict(kind="memory", family="llama",
                   over=_over("llama", 4), pp=2, tp=1,
                   batch=_batch(8, 2, seq=SEQ), micro=[2, 8],
                   train=dict(micro_batch_size=2, global_batch_size=16)),
}
CASES_W4 = {
    "1f1b_pp4": _grad_case("llama", 4, "1f1b", 4),
    "1f1b_pp2_tp2_sp": _grad_case("llama", 4, "1f1b", 2, tp=2),
    "stream_vpp2_tp2_sp": _grad_case("llama", 4, "stream", 2, tp=2, vpp=2),
}
STEP = dict(micro_batch_size=1, global_batch_size=4, train_iters=2,
            lr=1e-4, optimizer="adam", weight_decay=0.01, clip_grad=1.0)
STEP_BATCHES = [_batch(2, 2, seed=s) for s in (5, 6)]


def _model_key(case):
    return (case.get("jax_family", case["family"]),
            tuple(sorted(case["over"].items())))


@pytest.fixture(scope="module")
def jax_params():
    """{case: (the JAX model, its params as numpy)}: every case draws
    its model's init from PRNGKey(0), so the cases of one model share
    one draw."""
    out, drawn = {}, {}
    cases = {**CASES_W2, **CASES_W2_PORT, **CASES_W4,
             "step": dict(family="llama", over=_over("llama", 4))}
    for name, case in cases.items():
        key = _model_key(case)
        if key not in drawn:
            model = _jax_model(key[0], case["over"])
            drawn[key] = (model, jax.device_get(
                model.init(jax.random.PRNGKey(0))))
        out[name] = drawn[key]
    return out


_REFERENCE = {}


def _reference(case, model, params):
    """The JAX side of a grad case, once for the cases that share its
    model and batch: ((loss, aux), grads as a flat numpy dict)."""
    batch = case["batch"]
    key = (_model_key(case),) + tuple(
        (k, v.tobytes()) for k, v in sorted(batch.items()))
    if key not in _REFERENCE:
        (_, (loss, aux)), grads = jax.jit(jax.value_and_grad(
            lambda p: _objective(model, p, batch), has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, params))
        _REFERENCE[key] = ((float(loss),
                            None if aux is None else np.asarray(aux)),
                           _flat(jax.device_get(grads)))
    return _REFERENCE[key]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, jax_params):
    tmp = tmp_path_factory.mktemp("pp")

    def with_params(cases):
        return {n: dict(c, params=jax_params[n][1]) for n, c in
                cases.items()}

    w2 = run_world(tmp / "w2", "pp", 2, dict(
        tp=1, cases=with_params({**CASES_W2, **CASES_W2_PORT})))
    step = dict(kind="step", family="llama", over=_over("llama", 4), pp=2,
                tp=1, zero1=True, train=STEP, batches=STEP_BATCHES,
                lrs=[STEP["lr"]] * len(STEP_BATCHES),
                params=jax_params["step"][1])
    rotate = dict(kind="rotate", family="llama", over=_over("llama", 4),
                  pp=4, tp=1, train={})
    w4 = run_world(tmp / "w4", "pp", 4, dict(
        tp=1, cases={**with_params(CASES_W4), "step_pp2_dp2_zero1": step,
                     "rotate": rotate}))
    return {**{n: w2 for n in {**CASES_W2, **CASES_W2_PORT}},
            **{n: w4 for n in CASES_W4}, "step_pp2_dp2_zero1": w4,
            "rotate": w4}


def _assembled(results, name, case):
    """The port's full grads in natural layer order from the stages'
    (dp rank 0, tp rank 0) results, and the loss (and aux)."""
    ranks = sorted((r[name] for r in results if r[name]["dp_rank"] == 0
                    and r[name]["tp_rank"] == 0),
                   key=lambda r: r["pp_rank"])
    assert [r["pp_rank"] for r in ranks] == list(range(case["pp"]))
    # every rank reports the one loss
    for r in results:
        assert r[name]["loss"] == pytest.approx(ranks[0]["loss"], abs=1e-6)
    g = {k: v for k, v in _flat(ranks[0]["grads"]).items()
         if "layers" not in k}
    # the replicated leaves' grads are summed over pp: equal on every
    # stage
    for r in ranks[1:]:
        for k, v in _flat(r["grads"]).items():
            if "layers" not in k:
                np.testing.assert_array_equal(v, g[k], err_msg=str(k))
    stacked = {}
    for r in ranks:
        for k, v in _flat(r["grads"]).items():
            if "layers" in k:
                stacked.setdefault(k, []).append(v)
    L = case["over"]["num_layers"]
    for k, parts in stacked.items():
        g[k] = np.asarray(jax_unpermute({"x": jnp.asarray(
            np.concatenate(parts))}, L, case["pp"], case["vpp"] or 1)["x"])
    return ranks[0]["loss"], ranks[0]["aux"], g


@pytest.mark.parametrize("name", sorted({**CASES_W2, **CASES_W4}))
def test_engine_matches_the_unpipelined_jax_loss_and_grads(
        worlds, jax_params, name):
    case = {**CASES_W2, **CASES_W4}[name]
    (loss, aux), want = _reference(case, *jax_params[name])
    got_loss, got_aux, got = _assembled(worlds[name], name, case)
    assert abs(got_loss - loss) < LOSS_ATOL
    if aux is not None:
        np.testing.assert_allclose(got_aux, aux, atol=LOSS_ATOL)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=GRAD_ATOL,
                                   err_msg=f"{name} {k}")


def test_one_f_one_b_and_stream_agree_with_dropout_on(worlds):
    """One key, dropout on: the 1F1B recompute replays the forward's
    masks, so both engines give one loss and one set of grads; and the
    masks did drop (the loss differs from the loss without dropout)."""
    a = {r["dropout_1f1b"]["pp_rank"]: r["dropout_1f1b"]
         for r in worlds["dropout_1f1b"]}
    b = {r["dropout_stream"]["pp_rank"]: r["dropout_stream"]
         for r in worlds["dropout_stream"]}
    for k in (0, 1):
        assert a[k]["loss"] == pytest.approx(b[k]["loss"], abs=1e-6)
        fa, fb = _flat(a[k]["grads"]), _flat(b[k]["grads"])
        for key in fa:
            np.testing.assert_allclose(fa[key], fb[key], atol=1e-6,
                                       err_msg=str(key))
    plain = worlds["1f1b"][0]["1f1b"]["loss"]
    assert abs(a[0]["loss"] - plain) > 1e-3


@pytest.mark.parametrize("name,want", [
    # 1F1B at pp 2 and M 4: stage 0 sends 4 activations, stage 1 4
    # cotangents
    ("1f1b", {0: 4, 1: 4}),
    # the stream schedule at pp 2 x vpp 2, M 4 (8 items a stage): stage 0
    # sends 8 activations and the cotangents of its 4 chunk-1 items,
    # stage 1 the 4 chunk-0 outputs round the wrap and 8 cotangents
    ("stream_vpp2", {0: 12, 1: 12}),
])
def test_point_to_point_sends_are_counted_by_route(worlds, name, want):
    got = {r[name]["pp_rank"]: r[name]["permutes"] for r in worlds[name]}
    assert got == {k: {"gloo/cpu/permute": n} for k, n in want.items()}


def test_permute_rotates_over_the_pp_group(worlds):
    """``mappings.permute`` is ``lax.ppermute`` with the JAX engine's
    rotations: at pp 4 stage k receives stage k - 1's tensor one stage
    on and stage k + 1's one stage back."""
    for r in worlds["rotate"]:
        got = r["rotate"]
        k = got["pp_rank"]
        np.testing.assert_array_equal(got["fwd"], np.full((2, 3), (k - 1) % 4))
        np.testing.assert_array_equal(got["bwd"], np.full((2, 3), (k + 1) % 4))


def test_one_f_one_b_memory_is_flat_in_the_micro_batches(worlds):
    """The counterpart of test_manual_1f1b_memory_flat_in_microbatches:
    what stays live between ticks (the stash of at most 2S inputs and the
    received activations) and the peak of tensors saved for backward
    (one chunk's recompute at a time) at M 8 within 15% of M 2."""
    for r in worlds["memory"]:
        mem = r["memory"]["memory"]
        small, large = mem[2], mem[8]
        assert small["saved_peak"] > 0
        assert large["tick_bytes"] <= small["tick_bytes"] * 1.15, mem
        assert large["saved_peak"] <= small["saved_peak"] * 1.15, mem


def _jax_step(model, params, batches):
    opt = JaxOptimizer(JaxTrainConfig(**STEP))
    step = jax_train_step(model, opt, JaxParallelConfig(),
                          batches[0]["tokens"].shape[0])
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state = opt.init(p)
    logs = []
    for it, b in enumerate(batches):
        p, state, m = step(p, state, {k: jnp.asarray(v)
                                      for k, v in b.items()},
                           jax.random.PRNGKey(it), STEP["lr"],
                           STEP["weight_decay"])
        logs.append(dict(loss=float(m["lm loss"]),
                         grad_norm=float(m["grad_norm"])))
    return logs, _flat(jax.device_get(p))


def test_train_step_at_pp2_dp2_zero1_matches_the_jax_step(worlds,
                                                           jax_params):
    """Two steps of build_pipeline_train_step at pp 2 x dp 2 under ZeRO-1
    (each dp rank on its rows of every global micro batch) against the
    JAX package's one-device build_train_step on the global batches:
    losses within 1e-5 and grad norms within 1e-4, relative, and rank 0's
    gathered params after them within 1e-5."""
    model, params = jax_params["step"]
    logs, want = _jax_step(model, params, STEP_BATCHES)
    res = worlds["step_pp2_dp2_zero1"]
    for r in res:
        got = r["step_pp2_dp2_zero1"]["logs"]
        for g, w in zip(got, logs):
            assert g["lm loss"] == pytest.approx(w["loss"], rel=1e-5)
            assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-4)
            assert g["skipped_iter"] == 0
    trees = res[0]["step_pp2_dp2_zero1"]["trees"]
    assert trees is not None
    p_flat = {tuple(k.strip("[]'").split("']['")): v for k, (v, _) in
              trees[0].items()}
    assert set(p_flat) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(p_flat[k], v, atol=PARAM_ATOL,
                                   err_msg=str(k))
