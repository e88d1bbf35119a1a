"""The port's trainer entry point on the CPU:
``megatron_llm_torch.finetune.main([... "--device", "cpu"])`` with the
tiny flags of the verify notes runs 3 iterations; its log lines carry
the JAX ``training_log`` fields (the line format is the JAX package's,
character for character), with no MFU on the CPU; flags of unported
features raise."""

import re

import pytest
import torch

from megatron_llm_tpu.training import training_log as jax_training_log
from megatron_llm_torch import finetune
from megatron_llm_torch.config import (
    parallel_config_from_args,
    train_config_from_args,
    transformer_config_from_args,
)
from megatron_llm_torch.training import training_log

torch.set_num_threads(1)
TINY = ["--model_name=llama2", "--num_layers=2", "--hidden_size=64",
        "--num_attention_heads=4", "--seq_length=32",
        "--max_position_embeddings=32", "--micro_batch_size=2",
        "--global_batch_size=4", "--train_iters=3", "--lr=1e-4",
        "--vocab_size=128", "--log_interval=1", "--device", "cpu"]


def _fields(line):
    return [part.split(":")[0].strip() for part in line.split("|")
            if ":" in part]


def test_main_trains_three_iterations_on_the_cpu(capsys):
    assert finetune.main(TINY) == 3
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith(" iteration")]
    assert len(lines) == 3
    jax_lines = []
    jax_training_log(1, 3, {"lm loss": 4.8, "grad_norm": 1.0,
                            "loss_scale": 1.0, "skipped_iter": 0},
                     0.01, 128, 1e-4, printer=jax_lines.append,
                     throughput={"tokens_per_sec_per_device": 1.0,
                                 "tflops_per_device": 0.0, "mfu": None},
                     interval_time=0.01)
    losses = []
    for i, line in enumerate(lines, 1):
        assert _fields(line) == _fields(jax_lines[0])
        assert "MFU" not in line
        assert re.search(rf"iteration\s+{i}/\s+3", line)
        losses.append(float(re.search(r"lm loss: (\S+)", line).group(1)))
    assert all(4.0 < x < 6.0 for x in losses)     # ln 128 = 4.85


def test_log_line_is_the_jax_format():
    kw = dict(metrics={"lm loss": 2.5, "grad_norm": 0.75,
                       "loss_scale": 1.0, "skipped_iter": 0,
                       "moe aux loss": 0.1},
              elapsed_per_iter=0.125, tokens_per_iter=8192, lr=3e-5,
              throughput={"tokens_per_sec_per_device": 65536.0,
                          "tflops_per_device": 812.5, "mfu": 0.4},
              interval_time=0.25)
    want, got = [], []
    jax_training_log(7, 10, printer=want.append, **kw)
    training_log(7, 10, printer=got.append, **kw)
    assert got == want


def test_flags_lower_to_configs():
    from megatron_llm_torch.arguments import parse_args

    argv = TINY + ["--bf16", "--no_flash_attn", "--optimizer", "sgd",
                   "--optimizer_state_dtype", "bf16", "--clip_grad", "0.5"]
    args = parse_args(argv, extra_args_provider=finetune.extra_args)
    finetune._apply_model_defaults(args, argv)
    cfg = transformer_config_from_args(args)
    tc = train_config_from_args(args)
    assert cfg.padded_vocab_size == 128 and cfg.ffn_hidden_size == 256
    assert not cfg.use_flash_attn and cfg.params_dtype == "bf16"
    assert cfg.normalization == "rmsnorm" and not cfg.add_bias_linear
    assert cfg.hidden_dropout == 0.0 and not cfg.tie_embed_logits
    assert (tc.optimizer, tc.optimizer_state_dtype, tc.clip_grad,
            tc.global_batch_size, tc.lr_decay_iters) == (
        "sgd", "bf16", 0.5, 4, 3)
    assert parallel_config_from_args(args).world_size == 1


@pytest.mark.parametrize("extra", [
    ["--data_path", "corpus"], ["--load", "ckpt"], ["--save", "ckpt"],
    ["--tensor_model_parallel_size", "2"], ["--fp16"],
    ["--recompute_granularity", "selective"], ["--hidden_dropout", "0.1"],
])
def test_flags_for_unported_features_raise(extra):
    with pytest.raises(NotImplementedError):
        finetune.main(TINY + extra)


def test_other_families_raise():
    argv = [a if a != "--model_name=llama2" else "--model_name=mixtral"
            for a in TINY]
    with pytest.raises(NotImplementedError):
        finetune.main(argv)
