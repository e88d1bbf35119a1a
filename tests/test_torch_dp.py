"""The port's data parallelism and ZeRO-1 against the JAX package's
one-device train step at the same global batch.

Worlds of gloo ranks on the CPU (``_torch_tp_world.py``): tp 2 x dp 2
(4 ranks) and tp 1 x dp 2 (2 ranks).  Each rank takes its rows of every
global micro batch (``data_samplers.dp_rows``) and runs
``build_train_step``; the JAX step runs the whole global micro batch of
mb x dp rows on one device (not dp micro batches of mb rows, whose
per-micro means differ).  In fp32 every rank's loss is within 1e-5 and
its grad norm within 1e-4 of JAX's, relative, at each of 3 steps, and
rank 0's gathered params after them within 1e-5, also where the ranks'
loss masks differ (each rank's masked sum over the dp-summed count),
for Llama (RMSNorm) and GPT-2 (LayerNorm, learned positions, biases).
ZeRO-1 (``--use_distributed_optimizer``) holds 1/dp of the state of
each leaf it splits and, with the clip off (one clip coefficient), its
params equal plain dp's bit for bit.  The layer stats at tp 2 x dp 2
under ZeRO-1 match JAX's per group.  In fp16 a NaN on one rank's rows
skips the step on every rank.  ``finetune.main`` under the same worlds
matches JAX on the entry point's synthetic batches and saves the one
layout.  The sampler's dp rows are the JAX placement's shards, and the
ZeRO-1 state specs the JAX optimizer's.  BERT, T5, ICT and the MoE are
refused at dp > 1."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_tp_world import run_world
from megatron_llm_tpu.config import ParallelConfig as JaxParallelConfig
from megatron_llm_tpu.config import TrainConfig as JaxTrainConfig
from megatron_llm_tpu.models import (
    GPTModel,
    LlamaModel,
    gpt2_config,
    llama_config,
)
from megatron_llm_tpu.optimizer import MegatronOptimizer as JaxOptimizer
from megatron_llm_tpu.training import build_train_step as jax_train_step
from megatron_llm_torch import finetune, topology
from megatron_llm_torch.config import (
    train_config_from_args,
    transformer_config_from_args,
)
from megatron_llm_torch.models.llama import LlamaModel as PortLlama
from megatron_llm_torch.weights import params_to_numpy

torch.set_num_threads(1)
SEQ = 32
ITERS = 3
LR = 1e-4
LOSS_RTOL = 1e-5
NORM_RTOL = 1e-4
PARAM_ATOL = 1e-5
FAMILIES = {"llama": (LlamaModel, llama_config,
                      dict(num_attention_heads_kv=2, padded_vocab_size=256)),
            "gpt2": (GPTModel, gpt2_config,
                     dict(padded_vocab_size=256, hidden_dropout=0.0,
                          attention_dropout=0.0))}
TRAIN = dict(micro_batch_size=1, global_batch_size=4, train_iters=ITERS,
             lr=LR, optimizer="adam", weight_decay=0.01, clip_grad=1.0)


def _jax_params(family):
    model_cls, cfg_fn, over = FAMILIES[family]
    cfg = cfg_fn("tiny", seq_length=SEQ, max_position_embeddings=SEQ,
                 use_flash_attn=False, **over)
    model = model_cls(cfg)
    return model, jax.device_get(model.init(jax.random.PRNGKey(0)))


def _batches(seed, vocab, rows, masks_differ):
    """ITERS global batches of 2 micro batches of ``rows`` rows; with
    ``masks_differ`` each row keeps its own share of its tokens."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(ITERS):
        toks = rng.randint(0, vocab, (2, rows, SEQ)).astype(np.int32)
        mask = np.ones(toks.shape, np.float32)
        if masks_differ:
            keep = rng.uniform(0.1, 0.9, (2, rows, 1))
            mask = (rng.uniform(size=toks.shape) < keep).astype(np.float32)
            mask[:, 0, :4] = 1.0
        out.append({"tokens": toks, "labels": np.roll(toks, -1, axis=-1),
                    "loss_mask": mask})
    return out


def _jax_run(model, params, batches, train, layer_stats=False):
    """Per step (loss, grad norm, layer stats) and the final params of
    the JAX step on the global batches."""
    opt = JaxOptimizer(JaxTrainConfig(**train))
    step = jax_train_step(model, opt, JaxParallelConfig(),
                          batches[0]["tokens"].shape[0],
                          log_layer_stats=layer_stats)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state = opt.init(p)
    logs = []
    for it, b in enumerate(batches):
        p, state, m = step(p, state, {k: jnp.asarray(v)
                                      for k, v in b.items()},
                           jax.random.PRNGKey(it), LR, train["weight_decay"])
        logs.append(dict(loss=float(m["lm loss"]),
                         grad_norm=float(m["grad_norm"]),
                         layer_stats={k: np.asarray(v).tolist() for k, v in
                                      m.get("layer_stats", {}).items()}))
    flat = {"".join(f"[{getattr(k, 'key', k)!r}]" for k in path):
            np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(
                jax.device_get(p))[0]}
    return logs, flat


# name -> (world, tp, family, zero1, clip, masks differ, layer stats)
CASES = {
    "tp2dp2_llama": (4, 2, "llama", False, 1.0, True, False),
    "tp2dp2_llama_zero1": (4, 2, "llama", True, 1.0, True, True),
    "tp2dp2_gpt2_zero1": (4, 2, "gpt2", True, 1.0, False, False),
    "tp1dp2_llama_zero1": (2, 1, "llama", True, 1.0, True, False),
    "tp1dp2_gpt2": (2, 1, "gpt2", False, 1.0, True, False),
}
# the bitwise pairs: clip off, so both take one clip coefficient (1)
BITWISE = {"tp2dp2": (4, 2), "tp1dp2": (2, 1)}
FP16_NAN_RANK = 1


def _payload_case(family, params, batches, tp, zero1, clip, layer_stats,
                  **extra):
    return dict(family=family, params=params, batches=batches, tp=tp,
                sp=tp > 1, zero1=zero1, lrs=[LR] * ITERS,
                over=FAMILIES[family][2],
                train=dict(TRAIN, clip_grad=clip), layer_stats=layer_stats,
                **extra)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world's ranks and the JAX runs they are held to."""
    jax_models = {f: _jax_params(f) for f in FAMILIES}
    batches = {f: {md: _batches(7, 256, 4, md) for md in (False, True)}
               for f in FAMILIES}
    cases = {w: {} for w in (2, 4)}
    for name, (world, tp, fam, zero1, clip, md, ls) in CASES.items():
        cases[world][name] = _payload_case(
            fam, jax_models[fam][1], batches[fam][md], tp, zero1, clip, ls)
    for name, (world, tp) in BITWISE.items():
        for zero1 in (False, True):
            cases[world][f"bitwise_{name}_{int(zero1)}"] = _payload_case(
                "llama", jax_models["llama"][1], batches["llama"][True], tp,
                zero1, 0.0, False)
    cases[4]["fp16_skip"] = _payload_case(
        "llama", jax_models["llama"][1], batches["llama"][False], 2, True,
        1.0, False, nan_rank=FP16_NAN_RANK, nan_iter=0)
    cases[4]["fp16_skip"]["over"] = dict(
        FAMILIES["llama"][2], params_dtype="fp16", compute_dtype="fp16")
    cases[4]["fp16_skip"]["train"].update(fp16=True, loss_scale=256.0)
    ranks = {w: run_world(tmp_path_factory.mktemp(f"dp_world{w}"),
                          "dp_step", w, dict(cases=cases[w], tp=2))
             for w in (4, 2)}
    want = {}
    for fam in FAMILIES:
        for md in (False, True):
            if any(c[2] == fam and c[5] == md for c in CASES.values()):
                want[(fam, md)] = _jax_run(
                    jax_models[fam][0], jax_models[fam][1],
                    batches[fam][md], TRAIN,
                    layer_stats=(fam, md) == ("llama", True))
    return ranks, want


@pytest.mark.parametrize("iteration", range(ITERS))
@pytest.mark.parametrize("case", list(CASES))
def test_dp_step_matches_the_jax_step_at_the_global_batch(worlds, case,
                                                          iteration):
    ranks, want = worlds
    world, _, fam, _, _, md, _ = CASES[case]
    ref = want[(fam, md)][0][iteration]
    for r, res in enumerate(ranks[world]):
        got = res[case]["logs"][iteration]
        np.testing.assert_allclose(got["lm loss"], ref["loss"],
                                   rtol=LOSS_RTOL, atol=0,
                                   err_msg=f"loss, rank {r}")
        np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"],
                                   rtol=NORM_RTOL, atol=0,
                                   err_msg=f"grad norm, rank {r}")


@pytest.mark.parametrize("case", list(CASES))
def test_dp_params_after_three_steps_match_the_jax_step(worlds, case):
    ranks, want = worlds
    world, _, fam, _, _, md, _ = CASES[case]
    got, _ = ranks[world][0][case]["trees"]
    ref = want[(fam, md)][1]
    assert set(got) == set(ref)
    for key, (value, _) in got.items():
        np.testing.assert_allclose(value, ref[key], rtol=0, atol=PARAM_ATOL,
                                   err_msg=key)


@pytest.mark.parametrize("name", list(BITWISE))
def test_zero1_equals_plain_dp_bit_for_bit(worlds, name):
    ranks, _ = worlds
    world = BITWISE[name][0]
    plain = ranks[world][0][f"bitwise_{name}_0"]
    zero = ranks[world][0][f"bitwise_{name}_1"]
    for key, (value, dtype) in plain["trees"][0].items():
        z, zd = zero["trees"][0][key]
        assert dtype == zd and np.array_equal(value, z), key
    # the moments and masters too, gathered into the one layout
    for key, (value, _) in plain["trees"][1].items():
        assert np.array_equal(value, zero["trees"][1][key][0]), key
    # ZeRO-1 holds about 1/dp of the state (the leaves it splits)
    for res in ranks[world]:
        p, z = res[f"bitwise_{name}_0"], res[f"bitwise_{name}_1"]
        assert z["state_bytes"] < 0.6 * p["state_bytes"]


@pytest.mark.parametrize("iteration", range(ITERS))
def test_layer_stats_at_tp2_dp2_zero1_match_the_jax_step(worlds,
                                                         iteration):
    ranks, want = worlds
    ref = want[("llama", True)][0][iteration]["layer_stats"]
    for r, res in enumerate(ranks[4]):
        got = res["tp2dp2_llama_zero1"]["logs"][iteration]["layer_stats"]
        assert sorted(got) == sorted(ref)
        for key in ("grad_norm", "param_norm", "update_norm"):
            np.testing.assert_allclose(got[key], ref[key], rtol=NORM_RTOL,
                                       atol=1e-7,
                                       err_msg=f"{key}, rank {r}")
        assert got["nonfinite_grads"] == ref["nonfinite_grads"]


def test_fp16_skip_is_agreed_by_every_rank(worlds):
    """A NaN in rank 1's per-token loss alone (its mask counts stay
    finite) skips the first step on every rank; the next two apply."""
    ranks, _ = worlds
    for r, res in enumerate(ranks[4]):
        logs = res["fp16_skip"]["logs"]
        assert [m["skipped_iter"] for m in logs] == [1, 0, 0], r
        assert [m["loss_scale"] for m in logs] == [256.0] * ITERS
        assert np.isfinite(logs[1]["lm loss"])
        assert np.isfinite(logs[2]["lm loss"])
    trees = ranks[4][0]["fp16_skip"]["trees"]
    assert all(np.isfinite(v).all() for v, _ in trees[0].values())


# ---------------------------------------------------------------------------
# finetune.main under torchrun-like worlds
# ---------------------------------------------------------------------------

FT_ARGV = ["--model_name=llama2", "--num_layers=2", "--hidden_size=64",
           "--num_attention_heads=4", "--num_attention_heads_kv=2",
           "--ffn_hidden_size=96", "--seq_length=32",
           "--max_position_embeddings=32", "--micro_batch_size=1",
           "--global_batch_size=4", f"--train_iters={ITERS}", "--lr=1e-3",
           "--vocab_size=256", "--log_interval=1", "--device=cpu",
           "--seed=5", "--distributed_backend=gloo"]
FT_WORLDS = {"tp2dp2": (4, ["--tensor_model_parallel_size=2",
                            "--sequence_parallel",
                            "--use_distributed_optimizer"]),
             "tp1dp2": (2, ["--use_distributed_optimizer"])}


def _ft_jax(lrs, dp):
    """(losses, grad norms, final params) of the JAX step from the port's
    one-device init on the entry point's global batches."""
    args = finetune.parse_args(FT_ARGV,
                               extra_args_provider=finetune.extra_args)
    finetune._apply_model_defaults(args, FT_ARGV)
    cfg = transformer_config_from_args(args)
    params = params_to_numpy(PortLlama(cfg, device="cpu").init(args.seed))
    size = {k: getattr(cfg, k) for k in (
        "num_layers", "hidden_size", "num_attention_heads",
        "num_attention_heads_kv", "ffn_hidden_size", "padded_vocab_size",
        "seq_length", "max_position_embeddings")}
    jmodel = LlamaModel(llama_config("tiny", use_flash_attn=False, **size))
    tc = dataclasses.asdict(train_config_from_args(args))
    jopt = JaxOptimizer(JaxTrainConfig(**tc))
    rows = args.micro_batch_size * dp
    num_micro = args.global_batch_size // rows
    step = jax_train_step(jmodel, jopt, JaxParallelConfig(), num_micro)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state = jopt.init(p)
    rng = np.random.RandomState(args.seed)
    out = []
    for it in range(ITERS):
        toks = rng.randint(0, args.padded_vocab_size,
                           (num_micro, rows, args.seq_length)
                           ).astype(np.int32)
        batch = {"tokens": jnp.asarray(toks),
                 "labels": jnp.asarray(np.roll(toks, -1, axis=-1)),
                 "loss_mask": jnp.ones(toks.shape, jnp.float32)}
        p, state, m = step(p, state, batch, jax.random.PRNGKey(it),
                           lrs[it], args.weight_decay)
        out.append((float(m["lm loss"]), float(m["grad_norm"])))
    flat = {"".join(f"[{getattr(k, 'key', k)!r}]" for k in path):
            np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(
                jax.device_get(p))[0]}
    return out, flat


@pytest.fixture(scope="module")
def ft_runs(tmp_path_factory):
    out = {}
    for name, (world, flags) in FT_WORLDS.items():
        tmp = tmp_path_factory.mktemp(f"dp_finetune_{name}")
        save = str(tmp / "ck")
        ranks = run_world(tmp, "finetune", world, dict(
            argv=FT_ARGV + flags + [f"--save={save}"],
            tp=2 if "tp2" in name else 1))
        lrs = [ranks[0]["logged"][i + 1]["lr"] for i in range(ITERS)]
        out[name] = (ranks, _ft_jax(lrs, world // (2 if "tp2" in name
                                                   else 1)), save)
    return out


@pytest.mark.parametrize("iteration", range(1, ITERS + 1))
@pytest.mark.parametrize("name", list(FT_WORLDS))
def test_finetune_at_dp_matches_the_jax_step(ft_runs, name, iteration):
    ranks, (want, _), _ = ft_runs[name]
    loss, norm = want[iteration - 1]
    for r, res in enumerate(ranks):
        got = res["logged"][iteration]
        np.testing.assert_allclose(got["loss"], loss, rtol=LOSS_RTOL,
                                   atol=0, err_msg=f"loss, rank {r}")
        np.testing.assert_allclose(got["grad_norm"], norm, rtol=NORM_RTOL,
                                   atol=0, err_msg=f"grad norm, rank {r}")


@pytest.mark.parametrize("name", list(FT_WORLDS))
def test_finetune_at_dp_saves_the_jax_steps_params(ft_runs, name):
    from megatron_llm_torch import checkpointing

    ranks, (_, want), save = ft_runs[name]
    assert checkpointing.read_tracker(save) == (ITERS, False)
    flat = torch.load(os.path.join(
        checkpointing.get_checkpoint_name(save, ITERS), "model",
        checkpointing.PAYLOAD), weights_only=True)
    assert set(flat) == set(want)
    for key, value in flat.items():
        np.testing.assert_allclose(value.float().numpy(), want[key], rtol=0,
                                   atol=PARAM_ATOL, err_msg=key)
    # one summary a rank; ZeRO-1 cut each rank's state below a whole copy
    sums = [finetune_summary(res["stdout"]) for res in ranks]
    assert [s["rank"] for s in sums] == list(range(len(ranks)))
    dp = sums[0]["dp"]
    assert dp == 2 and all(s["opt_state_bytes"] < 0.6 * 3 * s["param_bytes"]
                           for s in sums)


def test_finetune_at_tp2_dp2_resumes_with_async_saves_and_layer_stats(
        ft_runs, tmp_path):
    """``--load`` of the tp 2 x dp 2 save in a new tp 2 x dp 2 world: the
    run continues at iteration 4 with ``--async_save`` and the layer
    stats on, and its final async save is committed."""
    from megatron_llm_torch import checkpointing

    _, _, save = ft_runs["tp2dp2"]
    ranks = run_world(tmp_path, "finetune", 4, dict(
        argv=FT_ARGV + FT_WORLDS["tp2dp2"][1] + [
            f"--load={save}", f"--save={save}", "--train_iters=4",
            "--async_save", "--log_layer_stats_interval=1",
            f"--structured_log_dir={tmp_path / 'logs'}"], tp=2))
    for res in ranks:
        assert res["iteration"] == 4 and sorted(res["logged"]) == [4]
        assert np.isfinite(res["logged"][4]["loss"])
    assert checkpointing.read_tracker(save) == (4, False)
    recs = [json.loads(ln) for ln in
            (tmp_path / "logs" / "telemetry.jsonl").read_text().splitlines()]
    stats = [r["layer_stats"] for r in recs if "layer_stats" in r]
    assert len(stats) == 1 and stats[0]["groups"][:2] == ["embedding",
                                                           "layer_000"]


def finetune_summary(stdout):
    lines = [ln for ln in stdout.splitlines() if "rank summary: " in ln]
    assert len(lines) == 1
    return json.loads(lines[0].split("rank summary: ", 1)[1])


GPT_ARGV = ["--num_layers=2", "--hidden_size=64", "--num_attention_heads=4",
            "--seq_length=32", "--max_position_embeddings=32",
            "--global_batch_size=4", "--train_iters=2", "--lr=1e-3",
            "--vocab_size=256", "--log_interval=1", "--device=cpu",
            "--seed=7"]


@pytest.fixture(scope="module")
def gpt_runs(tmp_path_factory):
    """``pretrain_gpt`` (the GPT preset: hidden and attention dropout
    0.1) at tp 2 x dp 2 with ZeRO-1, and in this process on one device
    at the same global batch."""
    from _torch_tp_world import task_finetune

    four = run_world(tmp_path_factory.mktemp("dp_gpt"), "finetune", 4, dict(
        argv=GPT_ARGV + ["--micro_batch_size=1",
                         "--tensor_model_parallel_size=2",
                         "--sequence_parallel", "--use_distributed_optimizer",
                         "--distributed_backend=gloo"],
        tp=2, entry="pretrain_gpt"))
    one = task_finetune(0, 1, dict(argv=GPT_ARGV + ["--micro_batch_size=2"],
                                   entry="pretrain_gpt"))
    return four, one


@pytest.mark.parametrize("iteration", [1, 2])
def test_pretrain_gpt_at_tp2_dp2_draws_the_one_device_masks(gpt_runs,
                                                           iteration):
    """Each dropout mask is drawn at the global micro batch's shape and
    each rank keeps its rows (and its tp slice), so the dropout run at tp
    2 x dp 2 follows the one-device run."""
    four, one = gpt_runs
    want = one["logged"][iteration]
    for r, res in enumerate(four):
        got = res["logged"][iteration]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL,
                                   atol=0, err_msg=f"loss, rank {r}")
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=NORM_RTOL, atol=0,
                                   err_msg=f"grad norm, rank {r}")


# ---------------------------------------------------------------------------
# the sampler's rows, the ZeRO-1 specs, the refusals (one process)
# ---------------------------------------------------------------------------

class _Docs:
    def __init__(self, n, seq):
        self.rows = np.arange(n * (seq + 1)).reshape(n, seq + 1)

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return {"text": self.rows[i]}


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("kind,consumed", [("single", 0), ("single", 24),
                                           ("cyclic", 0), ("cyclic", 24)])
def test_dp_rows_are_the_jax_placements_shards(dp, kind, consumed):
    """Each dp rank's rows equal the shard the JAX package's
    ``place_host_batch`` puts on that rank's devices when the logical
    batch axis maps to dp (``test_data.py``'s sampler at dp 2 and 4)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from megatron_llm_tpu.data.data_samplers import (
        build_pretraining_data_loader as jax_loader,
    )
    from megatron_llm_tpu.data.data_samplers import place_host_batch
    from megatron_llm_torch.data.data_samplers import (
        build_pretraining_data_loader,
        dp_rows,
    )

    ds = _Docs(96, 8)
    port = next(iter(build_pretraining_data_loader(
        ds, consumed, 2, dp, 2, kind, seed=3, prefetch=0)))
    ref = next(iter(jax_loader(ds, consumed, 2, dp, 2, kind, seed=3,
                               prefetch=0)))
    mesh = Mesh(np.array(jax.devices()[:dp]), ("dp",))
    for key in ("tokens", "labels", "loss_mask"):
        np.testing.assert_array_equal(port[key], ref[key])
        placed = place_host_batch(ref[key],
                                  NamedSharding(mesh, P(None, "dp", None)))
        shards = {s.device: np.asarray(s.data)
                  for s in placed.addressable_shards}
        for r, dev in enumerate(mesh.devices.reshape(-1)):
            np.testing.assert_array_equal(dp_rows(port, r, dp)[key],
                                          shards[dev])


def _spec_tree(specs):
    return {k: _spec_tree(v) if isinstance(v, dict) else tuple(v)
            for k, v in specs.items()}


@pytest.mark.parametrize("family,dp", [("llama", 2), ("llama", 8),
                                       ("gpt2", 4)])
def test_zero1_state_specs_match_the_jax_optimizers(family, dp):
    from megatron_llm_torch.parallel import sharding

    model, params = _jax_params(family)
    opt = JaxOptimizer(JaxTrainConfig(bf16=True),
                       params_dtype=jnp.bfloat16)
    specs = model.param_specs(params)
    want = opt.state_specs(specs, params, zero1=True, dp_size=dp)
    port_specs = sharding.language_model_param_specs(params)
    assert _spec_tree(port_specs) == _spec_tree(specs)
    got = sharding.zero1_state_specs(port_specs, params, dp)
    for tree in (want.master_params, want.exp_avg, want.exp_avg_sq):
        assert _spec_tree(got) == _spec_tree(tree)


def test_zero1_state_specs_respect_custom_rules():
    """``test_advice_fixes_r3.py``'s case: a leaf already on dp under the
    rules takes no second dp axis."""
    from megatron_llm_torch.parallel import sharding

    params = {"w": torch.zeros(16, 8)}
    specs = {"w": ("ffn", None)}
    assert sharding.zero1_state_specs(specs, params, 8) == \
        {"w": ("ffn", "dp_shard")}
    custom = {"ffn": topology.DP_AXIS, None: None}
    assert sharding.zero1_state_specs(specs, params, 8, rules=custom) == \
        {"w": ("ffn", None)}
    # no dim divides: the state stays replicated
    assert sharding.zero1_state_specs({"b": (None,)},
                                      {"b": torch.zeros(5)}, 2) == \
        {"b": (None,)}


@pytest.fixture
def dp2():
    topology.initialize_model_parallel(1, world_size=2, rank=0)
    yield
    topology.destroy_model_parallel()


def test_mixture_of_experts_is_refused_at_dp(dp2):
    from megatron_llm_torch.config import ParallelConfig, TrainConfig
    from megatron_llm_torch.models.mixtral import MixtralModel, mixtral_config
    from megatron_llm_torch.training import pretrain

    model = MixtralModel(mixtral_config("tiny"), device="cpu")
    with pytest.raises(NotImplementedError, match=r"item 15 \(f\)"):
        pretrain(model, {}, TrainConfig(train_iters=1),
                 ParallelConfig(data_parallel_size=2), iter(()))


def test_encoder_losses_are_refused_at_dp(dp2):
    from megatron_llm_torch.config import ParallelConfig
    from megatron_llm_torch.optimizer import MegatronOptimizer
    from megatron_llm_torch.config import TrainConfig
    from megatron_llm_torch.training import build_train_step

    from _torch_tp_world import _family_model

    with pytest.raises(NotImplementedError, match=r"item 15 \(g\)"):
        build_train_step(_family_model("llama", False),
                         MegatronOptimizer(TrainConfig()),
                         ParallelConfig(data_parallel_size=2), 1,
                         loss_func=lambda t, m: t.mean())


@pytest.mark.parametrize("entry", ["pretrain_bert", "pretrain_t5",
                                   "pretrain_ict"])
def test_bert_t5_and_ict_are_refused_at_dp(monkeypatch, entry):
    import importlib

    monkeypatch.setenv("WORLD_SIZE", "2")
    mod = importlib.import_module(f"megatron_llm_torch.{entry}")
    with pytest.raises(NotImplementedError, match=r"item 15 \(g\)"):
        mod.main(["--num_layers=2", "--hidden_size=64",
                  "--num_attention_heads=4", "--seq_length=16",
                  "--max_position_embeddings=16", "--micro_batch_size=4",
                  "--global_batch_size=8", "--vocab_size=128",
                  "--train_iters=1", "--device=cpu"])
    assert not torch.distributed.is_initialized()


def test_lora_is_refused_at_dp(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="data-parallel size 2"):
        finetune.main(FT_ARGV + ["--lora_rank=4"])
    assert not torch.distributed.is_initialized()


def test_use_distributed_optimizer_trains_in_a_world_of_one():
    """At dp 1 ZeRO-1 has nothing to split: the flag trains as plain."""
    assert finetune.main(FT_ARGV + ["--use_distributed_optimizer",
                                    "--train_iters=1"]) == 1
