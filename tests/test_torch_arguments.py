"""The port's CLI against the JAX package's: the four model flags of the
JAX parser that the port's model implements (Llama-3.1 rope scaling, the
post-LN alias, the Xavier init and the fp32 softmax toggle) parse in
both, and lower into ``TransformerConfig``s that are equal on every
field the two configs share."""

import dataclasses

import pytest

from megatron_llm_tpu import arguments as jax_arguments
from megatron_llm_torch import arguments
from megatron_llm_torch.config import transformer_config_from_args

# arguments both parsers need to lower a config
BASE = ["--num_layers=2", "--hidden_size=64", "--num_attention_heads=4",
        "--seq_length=32", "--max_position_embeddings=32",
        "--micro_batch_size=1", "--global_batch_size=1",
        "--padded_vocab_size=128",
        "--position_embedding_type=rotary", "--use_rms_norm"]

FLAG_ARGVS = [
    ["--rope_llama3_scaling", "8", "1", "4", "8192"],
    ["--apply_residual_connection_post_layernorm"],
    ["--init_method_xavier_uniform"],
    ["--no_attention_softmax_in_fp32"],
    ["--lima_dropout", "--hidden_dropout", "0.2"],
    ["--recompute_granularity", "selective", "--recompute_num_layers", "2"],
    ["--recompute_activations"],
    ["--fused_lm_cross_entropy", "--fused_ce_chunk_size", "4096"],
    ["--no_fused_lm_cross_entropy"],
]


def _jax_config(argv):
    args = jax_arguments.build_base_parser().parse_args(argv)
    args = jax_arguments.validate_args(args, world_size=1)
    return jax_arguments.transformer_config_from_args(args)


def _torch_config(argv):
    args = arguments.build_parser().parse_args(argv)
    return transformer_config_from_args(arguments.validate_args(args))


def _shared_fields(a, b):
    names = ({f.name for f in dataclasses.fields(a)}
             & {f.name for f in dataclasses.fields(b)})
    return sorted(names)


def _value(v):
    # the position type is an enum of each package; compare by name
    return getattr(v, "name", v)


@pytest.mark.parametrize("flags", FLAG_ARGVS,
                         ids=lambda f: f[0].lstrip("-"))
def test_model_flags_lower_as_in_the_jax_package(flags):
    argv = BASE + flags
    want, got = _jax_config(argv), _torch_config(argv)
    fields = _shared_fields(want, got)
    assert len(fields) > 30
    diff = {n: (_value(getattr(want, n)), _value(getattr(got, n)))
            for n in fields
            if _value(getattr(want, n)) != _value(getattr(got, n))}
    assert diff == {}


def test_each_flag_reaches_its_field():
    rope = _torch_config(BASE + FLAG_ARGVS[0])
    assert rope.rope_llama3_scaling == (8.0, 1.0, 4.0, 8192.0)
    assert _torch_config(BASE).rope_llama3_scaling is None
    assert _torch_config(BASE + FLAG_ARGVS[1]).use_post_ln is True
    assert _torch_config(BASE + FLAG_ARGVS[2]).init_method_xavier_uniform
    assert _torch_config(BASE).attention_softmax_in_fp32 is True
    assert _torch_config(BASE + FLAG_ARGVS[3]).attention_softmax_in_fp32 \
        is False
    assert _torch_config(
        BASE + ["--attention_softmax_in_fp32"]).attention_softmax_in_fp32
    lima = _torch_config(BASE + FLAG_ARGVS[4])
    assert lima.lima_dropout and lima.hidden_dropout == 0.2
    sel = _torch_config(BASE + FLAG_ARGVS[5])
    assert (sel.recompute_granularity, sel.recompute_num_layers) == (
        "selective", 2)
    assert _torch_config(BASE + FLAG_ARGVS[6]).recompute_granularity \
        == "selective"
    fused = _torch_config(BASE + FLAG_ARGVS[7])
    assert fused.fused_lm_cross_entropy and fused.fused_ce_chunk_size == 4096
    # the policy leaves a 128-entry vocabulary unfused
    assert _torch_config(BASE).fused_lm_cross_entropy is False


# the checkpoint, evaluation, data, tokenizer, dropout, recompute, fused
# cross-entropy and loop flags the port's trainer reads: flag -> a value
# other than its default (None: a store flag)
NEW_FLAGS = {
    "--lima_dropout": None, "--recompute_num_layers": "4",
    "--recompute_activations": None, "--recompute_method": "block",
    "--fused_lm_cross_entropy": None, "--no_fused_lm_cross_entropy": None,
    "--fused_ce_chunk_size": "1024", "--bias_dropout_fusion": None,
    "--eval_only": None, "--log_params_norm": None,
    "--log_num_zeros_in_grad": None, "--exit_duration_in_mins": "30",
    "--save_interval": "5", "--async_save": None, "--load_iters": "3",
    "--finetune": None, "--use_checkpoint_args": None,
    "--no_save_optim": None, "--no_load_optim": None,
    "--save_total_limit": "3", "--eval_iters": "7", "--eval_interval": "9",
    "--split": "98,2,0", "--data_impl": "infer", "--num_workers": "4",
    "--tokenizer_type": "GPT2BPETokenizer", "--vocab_file": "vocab.json",
    "--merge_file": "merges.txt", "--tokenizer_path": "tok",
    "--tokenizer_model": "tok.model", "--vocab_extra_ids_list": "a,b",
    "--vocab_extra_ids": "2", "--no_new_tokens": None,
    "--variable_seq_lengths": None, "--scalar_loss_mask": "0.5",
    "--data_type": "instruction", "--dataloader_type": "cyclic",
    "--make_vocab_size_divisible_by": "64",
}


def _parsed(argv):
    want = jax_arguments.build_base_parser().parse_args(argv)
    got = arguments.build_parser().parse_args(argv)
    return want, got


@pytest.mark.parametrize("flag", sorted(NEW_FLAGS))
def test_new_flags_parse_as_in_the_jax_package(flag):
    value = NEW_FLAGS[flag]
    argv = [flag] if value is None else [flag, value]
    for args in ([], argv):
        want, got = _parsed(args)
        dests = {a.dest for a in arguments.build_parser()._actions
                 if flag in a.option_strings}
        assert len(dests) == 1
        dest = dests.pop()
        assert getattr(got, dest) == getattr(want, dest), (args, dest)
    assert getattr(got, dest) != getattr(_parsed([])[1], dest)


# ---------------------------------------------------------------------------
# the whole JAX parser, and the example launch scripts' argvs (F2)
# ---------------------------------------------------------------------------

import json  # noqa: E402
import os  # noqa: E402
import stat  # noqa: E402
import subprocess  # noqa: E402

import finetune as jax_finetune  # noqa: E402

from megatron_llm_torch import finetune  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dests(parser):
    return {a.dest for a in parser._actions} - {"help"}


def test_every_jax_dest_is_in_the_port_parser_or_excused():
    want = _dests(jax_finetune.extra_args(
        jax_arguments.build_base_parser()))
    got = _dests(arguments.build_parser(finetune.extra_args))
    assert sorted(want - got) == sorted(arguments.JAX_FLAGS_NOT_HERE)
    assert all(arguments.JAX_FLAGS_NOT_HERE.values())
    # every dest the port adds beyond the JAX parser's is the device's
    # spelling only, which both parsers define
    assert got - want == set()


def example_argv(script, *script_args, tmp_path):
    """The argv an ``examples/*.sh`` script passes to python: the script
    runs with a ``python`` on PATH that records its arguments."""
    fake = tmp_path / "bin"
    fake.mkdir(exist_ok=True)
    (fake / "python").write_text(
        "#!/bin/sh\nexec \"$FAKE_PY\" -c 'import json, sys; "
        "print(json.dumps(sys.argv[1:]))' \"$@\"\n")
    (fake / "python").chmod(0o755 | stat.S_IEXEC)
    import sys as _sys
    res = subprocess.run(
        ["bash", os.path.join(REPO, "examples", script), *script_args],
        cwd=REPO, capture_output=True, text=True, timeout=60,
        env=dict(os.environ, PATH=f"{fake}:{os.environ['PATH']}",
                 FAKE_PY=_sys.executable))
    assert res.returncode == 0, res.stderr
    argv = json.loads(res.stdout.strip().splitlines()[-1])
    return argv[0], argv[1:]


# finetune.sh's families at tp 1
FINETUNE_FAMILIES = ("llama", "llama2", "llama3", "codellama", "mistral",
                     "mixtral", "falcon", "gpt")
# parsed values that differ by design: the device's choices
DIFFER_BY_DESIGN = {"device"}


def _both(argv):
    want = jax_finetune.extra_args(
        jax_arguments.build_base_parser()).parse_args(argv)
    jax_finetune._apply_model_defaults(want, argv)
    want = jax_arguments.validate_args(want, world_size=1)
    got = arguments.parse_args(argv, extra_args_provider=finetune.extra_args)
    finetune._apply_model_defaults(got, argv)
    return want, got


def _shared_differences(want, got):
    shared = (set(vars(want)) & set(vars(got))) - DIFFER_BY_DESIGN
    assert len(shared) > 250
    return {k: (getattr(want, k), getattr(got, k)) for k in sorted(shared)
            if getattr(want, k) != getattr(got, k)}


@pytest.mark.parametrize("family", FINETUNE_FAMILIES)
def test_finetune_example_parses_as_in_the_jax_package(family, tmp_path):
    entry, argv = example_argv("finetune.sh", family, "--tp=1",
                               "--data=corpus", "--checkpoint=ck",
                               tmp_path=tmp_path)
    assert entry == "finetune.py"
    assert "--sequence_parallel" in argv and "--tensor_model_parallel_size=1" \
        in argv
    want, got = _both(argv)
    assert _shared_differences(want, got) == {}
    assert got.sequence_parallel is False and got.bias_gelu_fusion in (
        True, False)


def test_pretrain_gpt_example_parses_as_in_the_jax_package(tmp_path):
    entry, argv = example_argv("pretrain_gpt.sh", "corpus", tmp_path=tmp_path)
    assert entry == "pretrain_gpt.py"
    want, got = _both(argv + ["--model_name=gpt"])
    assert _shared_differences(want, got) == {}


def test_sequence_parallel_is_off_at_tp_1_and_refused_above():
    """Off at tp 1; kept at tp 2 in a world of 2 ranks, which a world of
    one process cannot hold; a world of more ranks than tp is data
    parallelism, dp the rest of the world."""
    args = arguments.parse_args(["--sequence_parallel"])
    assert args.sequence_parallel is False
    from megatron_llm_torch.config import parallel_config_from_args
    argv = ["--sequence_parallel", "--tensor_model_parallel_size", "2"]
    with pytest.raises(ValueError):
        arguments.parse_args(argv)
    args = arguments.validate_args(arguments.build_parser().parse_args(argv),
                                   world_size=2)
    assert args.sequence_parallel is True and args.data_parallel_size == 1
    pc = parallel_config_from_args(args)
    assert (pc.tensor_model_parallel_size, pc.sequence_parallel) == (2, True)
    args = arguments.validate_args(arguments.build_parser().parse_args(argv),
                                   world_size=4)
    assert (args.data_parallel_size, args.sequence_parallel) == (2, True)


TINY_TRAIN = ["--model_name=llama2", "--num_layers=1", "--hidden_size=64",
              "--num_attention_heads=4", "--seq_length=8",
              "--vocab_size=128", "--train_iters=1", "--device", "cpu"]


@pytest.mark.parametrize("flags", [
    ["--context_parallel_size", "2"], ["--num_slices", "2"],
    ["--profiler_port", "9012"]],
    ids=lambda f: f[0].lstrip("-"))
def test_unported_features_parse_then_raise(flags):
    with pytest.raises(NotImplementedError):
        finetune.main(TINY_TRAIN + flags)


@pytest.mark.parametrize("flags", [
    ["--num_experts", "4"],
    ["--num_experts", "4", "--moe_top_k", "1", "--moe_z_loss_coeff", "0.1"],
    ["--lora_rank", "8"]],
    ids=["num_experts", "moe_top_k", "lora_rank"])
def test_moe_and_lora_flags_train(flags, capsys):
    """The MoE and LoRA flags used to parse and raise: they train now,
    with the JAX parser's values."""
    assert finetune.main(TINY_TRAIN + ["--log_interval=1"] + flags) == 1
    out = capsys.readouterr().out
    if "--num_experts" in flags:
        assert "moe aux loss" in out
        assert ("moe z loss" in out) == ("--moe_z_loss_coeff" in flags)
    else:
        assert "LoRA rank 8" in out
    want = jax_finetune.extra_args(
        jax_arguments.build_base_parser()).parse_args(TINY_TRAIN[:-2]
                                                      + flags)
    got = arguments.parse_args(TINY_TRAIN + flags,
                               extra_args_provider=finetune.extra_args)
    for dest in ("num_experts", "moe_top_k", "moe_capacity_factor",
                 "moe_min_capacity", "moe_aux_loss_coeff",
                 "moe_z_loss_coeff", "lora_rank", "lora_alpha",
                 "lora_targets"):
        assert getattr(got, dest) == getattr(want, dest), dest


def test_unimplemented_flags_warn(capsys):
    arguments.parse_args(["--train_samples", "10", "--eod_mask_loss"])
    out = capsys.readouterr().out
    assert "--train_samples is accepted" in out
    assert "--eod_mask_loss is accepted" in out
    arguments.parse_args(["--no_bias_gelu_fusion", "--fp8_hybrid"])
    assert "WARNING" not in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the training loop's runtime flags (resilience, telemetry, tracing, the
# signal handler, async saves, timers, metrics writers): each parses as in
# the JAX parser and finetune.main honours it
# ---------------------------------------------------------------------------

import numpy as np  # noqa: E402

from megatron_llm_torch import checkpointing  # noqa: E402
from megatron_llm_torch import global_vars  # noqa: E402
from megatron_llm_torch import resilience as port_resilience  # noqa: E402
from megatron_llm_torch import telemetry as port_telemetry  # noqa: E402
from megatron_llm_torch import training as port_training  # noqa: E402

RUNTIME = ["--model_name=llama2", "--num_layers=1", "--hidden_size=32",
           "--num_attention_heads=4", "--seq_length=8",
           "--max_position_embeddings=8", "--micro_batch_size=1",
           "--global_batch_size=1", "--vocab_size=64", "--train_iters=4",
           "--log_interval=1", "--lr=1e-3", "--device", "cpu"]


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _scalars(path):
    keys = set()
    for rec in _jsonl(path):
        keys |= set(rec) - {"step", "event", "config", "time"}
    return keys


def _steps(path):
    return [r["step"] for r in _jsonl(path) if "step" in r]


def _resilience(ctx):
    return ctx["built"]["resilience"]


def _corpus_flags(tmp_path):
    from megatron_llm_torch.data.indexed_dataset import make_builder

    prefix = str(tmp_path / "corpus_text_document")
    rng = np.random.RandomState(1234)
    b = make_builder(prefix + ".bin", vocab_size=64)
    for _ in range(80):
        b.add_item(rng.randint(0, 64, rng.randint(5, 40)))
        b.end_document()
    b.finalize(prefix + ".idx")
    return ["--data_path", prefix, "--split", "90,10,0",
            "--eval_interval", "2", "--eval_iters", "1"]


# dest -> (flags, check(ctx)); ctx: tmp (the run's cwd), out (stdout),
# built (the telemetry bundle and resilience manager finetune built),
# exit (SystemExit code or None), health (a /health answer mid-run)
ITEM7 = {
    "wandb_logger": (["--wandb_logger"], lambda c: _steps(
        c["tmp"] / "wandb_offline.jsonl") == [1, 2, 3, 4]),
    "wandb_resume": (["--wandb_logger", "--wandb_resume"],
                     lambda c: isinstance(c["error"], ImportError)),
    "wandb_project": (["--wandb_logger", "--wandb_project", "p"],
                      lambda c: c["wandb"]["project"] == "p"),
    "wandb_entity": (["--wandb_logger", "--wandb_entity", "e"],
                     lambda c: c["wandb"]["entity"] == "e"),
    "wandb_name": (["--wandb_logger", "--wandb_name", "n"],
                   lambda c: c["wandb"]["name"] == "n"),
    "wandb_id": (["--wandb_logger", "--wandb_id", "i"],
                 lambda c: c["wandb"]["id"] == "i"),
    "wandb_api_key": (["--wandb_logger", "--wandb_api_key", "k"],
                      lambda c: c["env"].get("WANDB_API_KEY") == "k"),
    "tensorboard_dir": (["--tensorboard_dir", "tb"], lambda c: _steps(
        c["tmp"] / "tb" / "metrics.jsonl") == [1, 2, 3, 4]),
    "tensorboard_log_interval": (
        ["--tensorboard_dir", "tb", "--tensorboard_log_interval", "2"],
        lambda c: _steps(c["tmp"] / "tb" / "metrics.jsonl") == [2, 4]),
    "log_timers_to_tensorboard": (
        ["--tensorboard_dir", "tb", "--log_timers_to_tensorboard"],
        lambda c: "train-step-time" in _scalars(
            c["tmp"] / "tb" / "metrics.jsonl")),
    "log_batch_size_to_tensorboard": (
        ["--tensorboard_dir", "tb", "--log_batch_size_to_tensorboard"],
        lambda c: "batch-size" in _scalars(
            c["tmp"] / "tb" / "metrics.jsonl")),
    "log_memory_to_tensorboard": (
        ["--tensorboard_dir", "tb", "--log_memory_to_tensorboard"],
        lambda c: "mem-bytes-in-use" in _scalars(
            c["tmp"] / "tb" / "metrics.jsonl")),
    "log_world_size_to_tensorboard": (
        ["--tensorboard_dir", "tb", "--log_world_size_to_tensorboard"],
        lambda c: "world-size" in _scalars(
            c["tmp"] / "tb" / "metrics.jsonl")),
    "log_validation_ppl_to_tensorboard": (
        ["--tensorboard_dir", "tb", "--log_validation_ppl_to_tensorboard",
         "CORPUS"],
        lambda c: {"validation loss", "validation ppl"} <= _scalars(
            c["tmp"] / "tb" / "metrics.jsonl")),
    "status_port": (["--status_port", "0"],
                    lambda c: c["health"]["status"] == "ok"
                    and c["health"]["iteration"] >= 1),
    "profile": (["--profile", "--profile_step_start", "2",
                 "--profile_step_end", "3"],
                lambda c: (c["tmp"] / "profile_trace"
                           / "trace_iter2-3.json").exists()),
    "profile_step_start": (["--profile", "--profile_step_start", "1",
                            "--profile_step_end", "3"],
                           lambda c: (c["tmp"] / "profile_trace"
                                      / "trace_iter1-3.json").exists()),
    "profile_step_end": (["--profile", "--profile_step_start", "2",
                          "--profile_step_end", "4"],
                         lambda c: (c["tmp"] / "profile_trace"
                                    / "trace_iter2-4.json").exists()),
    "profile_dir": (["--profile", "--profile_step_start", "2",
                     "--profile_step_end", "2", "--profile_dir", "pd"],
                    lambda c: (c["tmp"] / "pd"
                               / "trace_iter2-2.json").exists()),
    "flight_recorder_size": (
        ["--structured_log_dir", "logs", "--flight_recorder_size", "3"],
        lambda c: len(c["built"]["telemetry"].stream.flight_recorder) == 3),
    "straggler_threshold": (
        ["--trace_dir", "tr", "--straggler_threshold", "2.5"],
        lambda c: c["built"]["telemetry"].tracing.straggler.threshold
        == 2.5),
    "trace_buffer_size": (["--trace_dir", "tr", "--trace_buffer_size", "5"],
                          lambda c: c["built"]["telemetry"].tracing.tracer
                          .capacity == 5 and c["built"]["telemetry"]
                          .tracing.tracer.dropped > 0),
    "exit_signal_handler": (
        ["--exit_signal_handler", "--fault_inject", "sigterm@2", "--save",
         "ck"],
        lambda c: c["exit"] == 0
        and checkpointing.read_tracker(str(c["tmp"] / "ck")) == (2, False)),
    "timing_log_level": (["--timing_log_level", "0"],
                         lambda c: "batch-generator" not in c["out"]
                         and "iteration" in c["out"]),
    "timing_log_option": (["--timing_log_option", "max"],
                          lambda c: "\nmax time (ms) | batch-generator"
                          in c["out"]),
    "log_layer_stats_interval": (
        ["--structured_log_dir", "logs", "--log_layer_stats_interval", "2"],
        lambda c: ["layer_stats" in r for r in _jsonl(
            c["tmp"] / "logs" / "telemetry.jsonl")]
        == [False, True, False, True]),
    "structured_log_dir": (["--structured_log_dir", "logs"],
                           lambda c: [r["schema"] for r in _jsonl(
                               c["tmp"] / "logs" / "telemetry.jsonl")]
                           == [13] * 4),
    "trace_dir": (["--trace_dir", "tr"], lambda c: "step" in {
        e["name"] for e in json.load(open(c["tmp"] / "tr" / "trace.json"))
        ["traceEvents"]}),
    "rewind_on_spike": (["--rewind_on_spike", "--fault_inject", "nan@3",
                         "--snapshot_interval", "1"],
                        lambda c: "rewinds: 1" in c["out"]),
    "spike_factor": (["--rewind_on_spike", "--spike_factor", "5"],
                     lambda c: _resilience(c).config.spike_factor == 5.0),
    "spike_ema_beta": (["--rewind_on_spike", "--spike_ema_beta", "0.5"],
                       lambda c: _resilience(c).config.spike_ema_beta
                       == 0.5),
    "rewind_patience": (["--rewind_on_spike", "--rewind_patience", "3"],
                        lambda c: _resilience(c).config.patience == 3),
    "snapshot_interval": (["--rewind_on_spike", "--snapshot_interval", "2"],
                          lambda c: _resilience(c).snapshot_iteration == 2),
    "resilience_check_interval": (
        ["--rewind_on_spike", "--resilience_check_interval", "1",
         "--log_interval", "4", "--fault_inject", "nan@2",
         "--snapshot_interval", "1"],
        lambda c: "bad step at iteration 2" in c["out"]),
    "rewind_lr_factor": (
        ["--rewind_on_spike", "--rewind_lr_factor", "0.5", "--fault_inject",
         "nan@3", "--snapshot_interval", "1"],
        lambda c: _resilience(c).lr_scale == 0.5),
    "max_rewinds": (
        ["--rewind_on_spike", "--max_rewinds", "0", "--fault_inject",
         "nan@3", "--snapshot_interval", "1"],
        lambda c: "max_rewinds=0" in str(c["error"])),
    "watchdog_timeout_secs": (["--watchdog_timeout_secs", "30"],
                              lambda c: _resilience(c).watchdog.timeout_secs
                              == 30.0 and _resilience(c).watchdog.hard_exit),
    "watchdog_no_hard_exit": (["--watchdog_timeout_secs", "30",
                               "--watchdog_no_hard_exit"],
                              lambda c: not _resilience(c).watchdog
                              .hard_exit),
    "fault_inject": (["--fault_inject", "nan@2"],
                     lambda c: "poisoning iteration 2" in c["out"]
                     and "skipped iterations: 1" in c["out"]),
}


def test_item7_table_is_every_formerly_refused_flag():
    """The forty dests that waited for this slice: thirty-nine are
    honoured, and --profiler_port alone stays refused."""
    assert len(ITEM7) == 39
    assert set(ITEM7).isdisjoint(arguments.UNPORTED_TRAINING)
    assert "profiler_port" in arguments.UNPORTED_TRAINING
    assert "profiler_port" in arguments.UNPORTED_SERVING


@pytest.mark.parametrize("dest", sorted(ITEM7))
def test_item7_flags_parse_as_in_the_jax_package(dest):
    flags = [f for f in ITEM7[dest][0] if f != "CORPUS"]
    want, got = _parsed(flags)
    # the device is each package's own (tpu / cuda)
    names = {d for d in vars(want) if d in vars(got)} - {"device"}
    assert {n: getattr(got, n) for n in names} == \
        {n: getattr(want, n) for n in names}


@pytest.mark.parametrize("dest", sorted(ITEM7))
def test_item7_flags_are_honoured(dest, tmp_path, monkeypatch, capsys):
    flags, check = ITEM7[dest]
    if "CORPUS" in flags:
        flags = [f for f in flags if f != "CORPUS"] + _corpus_flags(tmp_path)
    monkeypatch.chdir(tmp_path)
    environ = dict(os.environ)
    monkeypatch.setattr(os, "environ", environ)
    ctx = {"tmp": tmp_path, "built": {}, "exit": None, "error": None,
           "env": environ, "health": None, "wandb": None}
    if "--wandb_logger" in flags and "--wandb_resume" not in flags:
        import sys
        import types

        class Run:
            summary = {}

            def finish(self):
                pass

        monkeypatch.setitem(sys.modules, "wandb", types.SimpleNamespace(
            init=lambda **kw: ctx.update(wandb=kw) or Run(),
            log=lambda payload, step: None))
        if dest == "wandb_logger":
            monkeypatch.setitem(sys.modules, "wandb", None)
    else:
        import sys
        monkeypatch.setitem(sys.modules, "wandb", None)
    build_tel, build_res = finetune.build_telemetry, \
        finetune.build_resilience

    def tel_spy(args, model):
        ctx["built"]["telemetry"] = t = build_tel(args, model)
        return t

    def res_spy(args):
        ctx["built"]["resilience"] = r = build_res(args)
        return r

    log0 = port_training.training_log

    def log_spy(iteration, *a, **kw):
        status = getattr(ctx["built"].get("telemetry"), "status", None)
        if status is not None and iteration == 2:
            import urllib.request
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{status.port}/health",
                    timeout=30) as r:
                ctx["health"] = json.loads(r.read())
        return log0(iteration, *a, **kw)

    monkeypatch.setattr(finetune, "build_telemetry", tel_spy)
    monkeypatch.setattr(finetune, "build_resilience", res_spy)
    monkeypatch.setattr(port_training, "training_log", log_spy)
    global_vars.reset_counters()
    try:
        finetune.main(RUNTIME + flags)
    except SystemExit as exc:
        ctx["exit"] = exc.code
    except (ImportError, RuntimeError) as exc:
        ctx["error"] = exc
    finally:
        port_resilience.set_save_fault_hook(None)
        port_telemetry.install_stream(None)
        global_vars.reset_counters()
    ctx["out"] = capsys.readouterr().out
    assert check(ctx), ctx["out"][-2000:]


def test_profiler_port_raises_with_its_reason():
    with pytest.raises(NotImplementedError,
                       match="live-capture server.*no PyTorch counterpart"):
        finetune.main(RUNTIME + ["--profiler_port", "9012"])


@pytest.mark.parametrize("parser", ["training", "server"])
def test_help_calls_no_honoured_flag_unported(parser):
    """F9: no help text says "not ported" (or that a flag raises) for a
    flag the port honours (--async_save's help read "not ported:
    raises"); the refused flags are the tables' alone."""
    import re

    from megatron_llm_torch import run_text_generation_server

    p = (arguments.build_parser() if parser == "training"
         else run_text_generation_server.build_parser())
    table = (arguments.UNPORTED_TRAINING if parser == "training"
             else arguments.UNPORTED_SERVING)
    for action in p._actions:
        text = (action.help or "").lower()
        if re.search(r"not ported|raises|refused", text):
            assert action.dest in table, (action.dest, action.help)
    async_help = next(a.help for a in p._actions if a.dest == "async_save")
    assert "torch.save" in async_help


def test_t5_and_bert_flags_are_honoured():
    """--decoder_seq_length (the T5 decoder) parses and is not refused;
    the rest of the refusals stay."""
    assert "decoder_seq_length" not in arguments.UNPORTED_TRAINING
    assert "decoder_seq_length" not in arguments.UNPORTED_SERVING
    args = arguments.parse_args(["--num_layers", "2", "--hidden_size", "64",
                                 "--num_attention_heads", "4",
                                 "--seq_length", "32",
                                 "--decoder_seq_length", "16"])
    arguments.refuse_unported(args, arguments.UNPORTED_TRAINING)
    assert args.decoder_seq_length == 16
    for dest in ("rampup_batch_size", "context_parallel_algo",
                 "multislice_flat_reduce", "profiler_port"):
        assert dest in arguments.UNPORTED_TRAINING
