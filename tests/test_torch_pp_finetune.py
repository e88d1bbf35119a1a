"""``finetune.main`` at pipeline-parallel sizes above 1, against the same
entry point on one process.

Worlds of gloo ranks on the CPU (``_torch_tp_world.py``, task
``finetune``) run the port's entry point as a user launches it under
torchrun: pp 2 under 1F1B and under the interleaved schedule
(``--num_layers_per_virtual_pipeline_stage 1``), and pp 2 with tp 2 +
SP and with dp 2 under ZeRO-1 in worlds of 4.  On the entry point's
synthetic batches (one global batch at every layout) each logged loss
is within 1e-5 and each grad norm within 1e-4, relative, of the
one-process run's (fp32), and every rank logs the same loss; with the
layer stats on, each group's grad, param and update norm within 1e-4
of the one-process run's (``layer_NNN`` indexes the stacked rows, which
the interleaved schedule holds stage-major).  The point-to-point steps
show in each rank's summary by route."""

import json
import os

import pytest
import torch

from _torch_tp_world import run_world
from megatron_llm_torch import finetune, training
from megatron_llm_torch.parallel.pipeline import vpp_stage_major_permutation

torch.set_num_threads(1)
TINY = ["--model_name=llama2", "--num_layers=4", "--hidden_size=64",
        "--num_attention_heads=4", "--seq_length=32",
        "--max_position_embeddings=32", "--global_batch_size=8",
        "--train_iters=3", "--lr=1e-3", "--vocab_size=256",
        "--log_interval=1", "--device=cpu"]
LOSS_RTOL = 1e-5
NORM_RTOL = 1e-4

# name -> (world, the layout's flags, micro batch a rank)
LAYOUTS = {
    "1f1b": (2, ["--pipeline_model_parallel_size=2"], 2),
    "interleaved": (2, ["--pipeline_model_parallel_size=2",
                        "--num_layers_per_virtual_pipeline_stage=1"], 2),
    "tp2_sp": (4, ["--pipeline_model_parallel_size=2",
                   "--tensor_model_parallel_size=2", "--sequence_parallel"],
               2),
    "dp2_zero1": (4, ["--pipeline_model_parallel_size=2",
                      "--use_distributed_optimizer"], 1),
}


STATS = ["--log_layer_stats_interval=1"]


def _layer_stats(log_dir):
    with open(os.path.join(log_dir, "telemetry.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return {r["iteration"]: r["layer_stats"] for r in recs
            if "layer_stats" in r}


def _one_process(log_dir):
    seen = {}
    log0 = training.training_log

    def log_line(iteration, train_iters, metrics, *a, **kw):
        seen[iteration] = dict(loss=float(metrics["lm loss"]),
                               grad_norm=float(metrics["grad_norm"]))
        return log0(iteration, train_iters, metrics, *a, **kw)

    training.training_log = log_line
    try:
        finetune.main(TINY + ["--micro_batch_size=2", *STATS,
                              f"--structured_log_dir={log_dir}"])
    finally:
        training.training_log = log0
    return seen, _layer_stats(log_dir)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return _one_process(str(tmp_path_factory.mktemp("pp_reference")))


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_finetune_at_pp_matches_one_process(tmp_path, reference, name):
    world, flags, mb = LAYOUTS[name]
    logs = str(tmp_path / "logs")
    ranks = run_world(tmp_path, "finetune", world, dict(
        tp=1, argv=TINY + [f"--micro_batch_size={mb}"] + flags + STATS
        + [f"--structured_log_dir={logs}"]))
    want_losses, want_stats = reference
    for r in ranks:
        assert r["iteration"] == 3
        assert sorted(r["logged"]) == [1, 2, 3]
        for it, want in want_losses.items():
            got = r["logged"][it]
            assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL)
            assert got["grad_norm"] == pytest.approx(want["grad_norm"],
                                                     rel=NORM_RTOL)
    summaries = [json.loads(line.split("rank summary: ", 1)[1])
                 for r in ranks for line in r["stdout"].splitlines()
                 if "rank summary: " in line]
    assert len(summaries) == world and all(s["pp"] == 2 for s in summaries)
    assert all(s["collectives"].get("gloo/cpu/permute", 0) > 0
               for s in summaries)
    # stacked row j of the run holds natural layer perm[j]
    perm = vpp_stage_major_permutation(4, 2, 2 if name == "interleaved"
                                       else 1)
    got_stats = _layer_stats(logs)
    assert sorted(got_stats) == [1, 2, 3]
    for it, want in want_stats.items():
        got = got_stats[it]
        assert got["groups"] == want["groups"]
        first = want["groups"].index("layer_000")
        order = (list(range(first)) + [first + int(i) for i in perm]
                 + list(range(first + 4, len(want["groups"]))))
        for key in ("grad_norm", "param_norm", "update_norm"):
            assert got[key] == pytest.approx(
                [want[key][i] for i in order], rel=NORM_RTOL), key
