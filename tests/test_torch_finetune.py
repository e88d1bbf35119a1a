"""The port's trainer entry point on the CPU:
``megatron_llm_torch.finetune.main([... "--device", "cpu"])`` with the
tiny flags of the verify notes runs 3 iterations; its log lines carry
the JAX ``training_log`` fields (the line format is the JAX package's,
character for character), with no MFU on the CPU; flags of unported
features raise.  On an mmap corpus in tmp_path: 4 iterations straight
and 2 + save + resume 2 give the same losses, eval losses, final params
and optimizer state, bit for bit; the logged eval loss is the JAX
model's loss on the carried params and the same valid batch (fp32, 1e-5);
``--use_checkpoint_args``, ``--no_save_optim`` and instruction data
work."""

import json
import os
import re

import numpy as np
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
    ["--profiler_port", "9012"],
    ["--pipeline_model_parallel_size", "2"],
    ["--tensor_model_parallel_size", "2"], ["--fp16"],
])
def test_flags_for_unported_features_raise(extra):
    with pytest.raises(NotImplementedError):
        finetune.main(TINY + extra)


def test_other_families_raise(capsys):
    """A family outside the JAX entry point's table is refused by the
    parser; mixtral, the last of the table that used to raise, trains
    and logs its balance loss."""
    argv = [a if a != "--model_name=llama2" else "--model_name=bert"
            for a in TINY]
    with pytest.raises(SystemExit):
        finetune.main(argv)
    argv = [a if a != "--model_name=llama2" else "--model_name=mixtral"
            for a in TINY] + ["--num_experts=4"]
    assert finetune.main(argv) == 3
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith(" iteration")]
    assert len(lines) == 3 and all("moe aux loss" in ln for ln in lines)


# ---------------------------------------------------------------------------
# data, checkpoints, resume and eval on an mmap corpus
# ---------------------------------------------------------------------------

def _corpus(tmp_path, vocab=128, docs=120):
    from megatron_llm_torch.data.indexed_dataset import make_builder

    prefix = str(tmp_path / "corpus_text_document")
    rng = np.random.RandomState(1234)
    b = make_builder(prefix + ".bin", vocab_size=vocab)
    for _ in range(docs):
        b.add_item(rng.randint(0, vocab, rng.randint(5, 80)))
        b.end_document()
    b.finalize(prefix + ".idx")
    return prefix


def _data_flags(prefix, iters):
    return [a for a in TINY if not a.startswith("--train_iters")] + [
        f"--train_iters={iters}", "--data_path", prefix, "--split",
        "90,10,0", "--eval_interval", "2", "--eval_iters", "1"]


def _run(argv, monkeypatch):
    """finetune.main(argv) -> (iteration, {iteration: exact lm loss},
    {iteration: printed eval loss})."""
    import io
    from contextlib import redirect_stdout

    from megatron_llm_torch import training

    losses = {}
    real = training.training_log

    def log_line(iteration, train_iters, metrics, *a, **kw):
        losses[iteration] = metrics["lm loss"]
        return real(iteration, train_iters, metrics, *a, **kw)

    monkeypatch.setattr(training, "training_log", log_line)
    out = io.StringIO()
    with redirect_stdout(out):
        it = finetune.main(argv)
    evals = {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"validation loss at iteration (\d+): (\S+)", out.getvalue())}
    return it, losses, evals


def _payload(ckpt, it, part):
    from megatron_llm_torch import checkpointing

    return checkpointing._read_tree(
        os.path.join(ckpt, f"iter_{it:07d}", part), "cpu")


def _bitwise(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k].reshape(-1).view(torch.uint8),
                           b[k].reshape(-1).view(torch.uint8)), k


@pytest.mark.parametrize("dtype", [[], ["--bf16"]], ids=["fp32", "bf16"])
def test_resume_reproduces_the_uninterrupted_run(tmp_path, monkeypatch,
                                                 dtype):
    prefix = _corpus(tmp_path)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    flags = _data_flags(prefix, 4) + dtype
    it, loss_a, eval_a = _run(flags + ["--save", a, "--save_interval", "2"],
                              monkeypatch)
    assert it == 4 and sorted(loss_a) == [1, 2, 3, 4]
    assert sorted(os.listdir(a)) == ["iter_0000002", "iter_0000004",
                                     "latest_checkpointed_iteration.txt"]
    it, loss_b, eval_b = _run(flags + ["--load", a, "--load_iters", "2",
                                       "--save", b], monkeypatch)
    assert it == 4 and sorted(loss_b) == [3, 4]
    assert (loss_b[3], loss_b[4]) == (loss_a[3], loss_a[4])
    assert sorted(eval_a) == [2, 4] and eval_b == {4: eval_a[4]}
    for part in ("model", "optim"):
        _bitwise(_payload(a, 4, part), _payload(b, 4, part))
    meta = json.load(open(os.path.join(b, "iter_0000004", "meta.json")))
    assert meta["consumed_samples"] == 16
    assert meta["opt_param_scheduler"]["num_steps"] == 4


def _meta_samples(ckpt, it):
    with open(os.path.join(ckpt, f"iter_{it:07d}", "meta.json")) as f:
        return json.load(f)["consumed_samples"]


def test_pretrain_saves_the_samples_of_its_own_run(tmp_path):
    """pretrain counts the samples from its consumed_samples argument on:
    two calls in one process each record their own run's count, through
    its own save path and through a save_fn."""
    from megatron_llm_torch import training
    from megatron_llm_torch.arguments import parse_args

    args = parse_args(TINY, extra_args_provider=finetune.extra_args)
    finetune._apply_model_defaults(args, TINY)
    model = finetune.model_provider(args)
    tc, pc = train_config_from_args(args), parallel_config_from_args(args)
    rng = np.random.RandomState(0)

    def batches():
        while True:     # [num_micro=2, mb=2, seq=32]
            toks = torch.from_numpy(rng.randint(0, 128, (2, 2, 32)))
            yield {"tokens": toks, "labels": toks.roll(-1, -1),
                   "loss_mask": torch.ones(2, 2, 32)}

    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    for ckpt in (a, b):
        training.pretrain(model, model.init(0), tc, pc, batches(),
                          log_interval=0, save_interval=2, save_dir=ckpt)
        assert _meta_samples(ckpt, 2) == 8
    seen = []
    training.pretrain(model, model.init(0), tc, pc, batches(),
                      log_interval=0, save_interval=1, save_dir=b,
                      start_iteration=1, consumed_samples=100,
                      save_fn=lambda *a: seen.append((a[1], a[-1])))
    assert seen == [(2, 104), (3, 108)]


def test_final_save_records_every_iterations_samples(tmp_path, monkeypatch):
    prefix = _corpus(tmp_path)
    ckpt = str(tmp_path / "ck")
    it, _, _ = _run(_data_flags(prefix, 3) + ["--save", ckpt,
                                              "--save_interval", "2"],
                    monkeypatch)
    assert it == 3
    assert (_meta_samples(ckpt, 2), _meta_samples(ckpt, 3)) == (8, 12)


def test_eval_loss_matches_jax(tmp_path, monkeypatch):
    import jax.numpy as jnp

    from megatron_llm_tpu.checkpointing import config_to_args
    from megatron_llm_tpu.data.gpt_dataset import (
        build_train_valid_test_datasets,
    )
    from megatron_llm_tpu.models.llama import LlamaModel as JaxLlama
    from megatron_llm_tpu.models.llama import llama_config
    from megatron_llm_torch.weights import params_to_numpy

    prefix = _corpus(tmp_path)
    ckpt = str(tmp_path / "ck")
    _, _, evals = _run(_data_flags(prefix, 2) + ["--save", ckpt],
                       monkeypatch)
    meta = json.load(open(os.path.join(ckpt, "iter_0000002", "meta.json")))
    size = {k: meta["args"][k] for k in (
        "num_layers", "hidden_size", "num_attention_heads",
        "ffn_hidden_size", "padded_vocab_size", "seq_length",
        "max_position_embeddings")}
    jcfg = llama_config("tiny", use_flash_attn=False, **size)
    want_args = config_to_args(jcfg)
    for k in ("normalization", "layernorm_epsilon", "glu_activation",
              "position_embedding_type", "rope_theta", "tie_embed_logits",
              "add_bias_linear", "num_attention_heads_kv", "kv_channels"):
        assert meta["args"][k] == want_args[k], k
    from megatron_llm_torch.checkpointing import _unflat

    params = params_to_numpy(_unflat(_payload(ckpt, 2, "model")))
    # the valid split as the port's loader builds it: (2 // 2 + 1) evals
    # of one global batch of 4
    valid = build_train_valid_test_datasets([prefix], "90,10,0", [8, 8, 0],
                                            32, 1234)[1]
    texts = np.stack([valid[i]["text"] for i in range(4)]).reshape(
        2, 2, 33)
    jmodel = JaxLlama(jcfg)
    losses = [float(jnp.mean(jmodel(params, jnp.asarray(t[:, :-1]),
                                    labels=jnp.asarray(t[:, 1:]))))
              for t in texts]
    assert abs(evals[2] - np.mean(losses)) <= 1e-5


def test_use_checkpoint_args_and_no_save_optim(tmp_path, monkeypatch):
    prefix = _corpus(tmp_path)
    ckpt = str(tmp_path / "ck")
    _run(_data_flags(prefix, 2) + ["--save", ckpt, "--no_save_optim"],
         monkeypatch)
    assert not os.path.exists(os.path.join(ckpt, "iter_0000002", "optim"))
    # another width on the command line: the checkpoint's wins
    argv = [a if a != "--hidden_size=64" else "--hidden_size=32"
            for a in _data_flags(prefix, 3)]
    with pytest.raises(ValueError, match="shape"):
        _run(argv + ["--load", ckpt], monkeypatch)
    it, losses, _ = _run(argv + ["--load", ckpt, "--use_checkpoint_args"],
                         monkeypatch)
    # no optimizer state was saved: the resume restores what there is
    assert it == 3 and sorted(losses) == [3]


def test_instruction_data_trains(tmp_path, monkeypatch):
    from megatron_llm_torch.data.indexed_dataset import (
        MMapIndexedDatasetBuilder,
    )

    prefix = str(tmp_path / "chat")
    rng = np.random.RandomState(0)
    lens = rng.randint(8, 40, 30)
    for suffix, make in (("-text", lambda n: rng.randint(0, 127, n)),
                         ("-role", lambda n: rng.randint(1, 4, n))):
        b = MMapIndexedDatasetBuilder(prefix + suffix + ".bin",
                                      dtype=np.int32)
        for n in lens:
            b.add_item(make(n))
            b.end_document()
        b.finalize(prefix + suffix + ".idx")
    argv = [a for a in TINY if not a.startswith(("--train_iters",
                                                 "--vocab_size"))]
    it, losses, _ = _run(argv + [
        "--train_iters=2", "--data_path", prefix, "--data_type",
        "instruction", "--tokenizer_type", "NullTokenizer",
        "--vocab_size", "127", "--scalar_loss_mask", "0.5"], monkeypatch)
    assert it == 2 and all(np.isfinite(v) for v in losses.values())


# ---------------------------------------------------------------------------
# GPT pretraining with its dropouts, --eval_only, --log_params_norm
# ---------------------------------------------------------------------------

GPT_TINY = [a for a in TINY if a != "--model_name=llama2"]


def test_gpt_preset_trains_with_the_parsers_dropouts(capsys, monkeypatch):
    from megatron_llm_torch import pretrain_gpt
    from megatron_llm_torch import random as mrandom

    draws = []
    real = mrandom.bernoulli

    def counted(key, p, shape, device):
        draws.append((key, p))
        return real(key, p, shape, device)

    monkeypatch.setattr(mrandom, "bernoulli", counted)
    assert pretrain_gpt.main(GPT_TINY) == 3
    out = capsys.readouterr().out
    assert "> gpt:" in out
    losses = [float(m) for m in re.findall(r"lm loss: (\S+)", out)]
    assert len(losses) == 3 and all(4.0 < x < 6.0 for x in losses)
    # per iteration and micro-batch: the embedding, then per layer the
    # probs (0.9 kept) and two hidden sites
    assert len(draws) == 3 * 2 * (1 + 3 * 2)
    assert {p for _, p in draws} == {0.9}
    assert len({k for k, _ in draws}) == len(draws)


def test_eval_only_evaluates_and_trains_nothing(tmp_path, monkeypatch,
                                                capsys):
    prefix = _corpus(tmp_path)
    ckpt = str(tmp_path / "ckpt")
    flags = _data_flags(prefix, 2)
    _, _, evals = _run(flags + ["--save", ckpt, "--save_interval", "2"],
                       monkeypatch)
    capsys.readouterr()
    # the params of iteration 2 (loaded as a finetune: from iteration 0)
    # on the first valid batch, as the run's evaluation at iteration 2
    # read them
    assert finetune.main(flags + ["--load", ckpt, "--finetune",
                                  "--eval_only"]) == 0
    out = capsys.readouterr().out
    assert not [ln for ln in out.splitlines()
                if ln.startswith(" iteration")]
    got = float(re.search(r"eval_only: validation loss (\S+)", out).group(1))
    assert got == evals[2]
    with pytest.raises(SystemExit, match="validation data"):
        finetune.main(TINY + ["--eval_only"])


def test_log_params_norm_is_the_norm_of_the_params(tmp_path, capsys):
    from megatron_llm_torch import checkpointing

    ckpt = str(tmp_path / "ckpt")
    argv = [a for a in TINY if not a.startswith("--train_iters")] + [
        "--train_iters=1", "--log_params_norm", "--log_num_zeros_in_grad",
        "--save", ckpt]
    finetune.main(argv)
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith(" iteration")][0]
    norm = float(re.search(r"params norm: (\S+)", line).group(1))
    zeros = float(re.search(r"num zeros: (\S+)", line).group(1))
    tree = checkpointing._read_tree(
        os.path.join(ckpt, "iter_0000001", "model"), "cpu")
    want = torch.stack([t.double().square().sum()
                        for t in tree.values()]).sum().sqrt()
    np.testing.assert_allclose(norm, float(want), rtol=1e-6)
    # the padded vocabulary's rows of the untied head get no gradient
    assert zeros >= 0.0
