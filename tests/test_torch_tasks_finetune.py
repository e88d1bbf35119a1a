"""The port's finetuning tasks (``megatron_llm_torch/tasks/finetune_utils``,
``glue`` and ``race``) against the root package's, at tiny shapes (a
BERT trunk of 2 layers, h 64, 4 heads, seq 16, vocab 64; inputs from
numpy with a seed; fp32, dropout off): ``finetune``'s 3 step losses
within 1e-4 relative from the same JAX-initialised params (carried by
``megatron_llm_torch/weights.py``), ``accuracy_func_provider``'s
predictions' softmaxes within 1e-5 with equal labels, ids and accuracy
(over a padded tail batch), ``load_pretrained_trunk``'s grafts equal,
the optimizer built after the bf16 cast, and ``tasks.main`` end to end
on the CPU on the JAX tests' synthetic GLUE (MNLI) and RACE corpora:
dev accuracy above chance, per-split lines, predictions and ``best/``."""

import json
import re

import jax
import numpy as np
import pytest
import torch

import tasks.finetune_utils as j_fu
import tasks.main as j_tasks_main
from megatron_llm_tpu import checkpointing as j_ckpt
from megatron_llm_tpu import topology
from megatron_llm_tpu.arguments import parse_args as j_parse_args
from megatron_llm_tpu.arguments import validate_args as j_validate_args
from megatron_llm_tpu.models import bert as jbert
from megatron_llm_tpu.models import classification as jcls
from megatron_llm_torch import checkpointing
from megatron_llm_torch.models import bert as tbert
from megatron_llm_torch.models import classification as tcls
from megatron_llm_torch.tasks import finetune_utils as p_fu
from megatron_llm_torch.tasks import main as tasks_main
from megatron_llm_torch.tasks.glue.mnli import MNLIDataset
from megatron_llm_torch.tree import tree_leaves_with_path
from megatron_llm_torch.weights import params_from_jax
from test_glue_finetune_e2e import _write_mnli_tsv
from test_glue_finetune_e2e import _write_vocab as _glue_vocab
from test_race_finetune_e2e import _write_race_dir
from test_race_finetune_e2e import _write_vocab as _race_vocab

torch.set_num_threads(1)
VOCAB, SEQ, MB = 64, 16, 4
TINY = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            ffn_hidden_size=128, padded_vocab_size=VOCAB, seq_length=SEQ,
            max_position_embeddings=SEQ, hidden_dropout=0.0,
            attention_dropout=0.0)
FLAGS = ["--num_layers", "2", "--hidden_size", "64",
         "--num_attention_heads", "4", "--ffn_hidden_size", "128",
         "--seq_length", str(SEQ), "--max_position_embeddings", str(SEQ),
         "--hidden_dropout", "0", "--attention_dropout", "0",
         "--vocab_size", str(VOCAB), "--make_vocab_size_divisible_by", "64",
         "--micro_batch_size", str(MB), "--lr", "1e-3",
         "--lr_warmup_fraction", "0.34", "--weight_decay", "0.01",
         "--epochs", "1", "--log_interval", "1", "--seed", "11",
         "--task", "MNLI"]


class IntTok:
    cls, sep, pad, mask, eod = 1, 2, 0, 3, 2

    def tokenize(self, text):
        return [int(t) % 50 + 5 for t in text.split()]


def _mnli(path, n, seed):
    rs = np.random.RandomState(seed)
    labels = ["contradiction", "entailment", "neutral"]
    rows = ["\t".join(f"c{i}" for i in range(11))]
    for uid in range(n):
        a = " ".join(str(t) for t in rs.randint(0, 50, rs.randint(2, 9)))
        b = " ".join(str(t) for t in rs.randint(0, 50, rs.randint(1, 6)))
        rows.append("\t".join([str(uid + 100)] + ["x"] * 7
                              + [a, b, labels[uid % 3]]))
    path.write_text("\n".join(rows) + "\n")


def _args(extra=()):
    """(JAX args on one data-parallel rank, port args on the CPU)."""
    topology.initialize_model_parallel(1, 1)
    jdp = jax.device_count()
    jargs = j_parse_args(extra_args_provider=j_tasks_main.get_tasks_args,
                         args_list=FLAGS + ["--global_batch_size",
                                            str(MB * jdp), *extra])
    j_validate_args(jargs)
    jargs.data_parallel_size = 1
    pargs, _ = tasks_main.parse(FLAGS + ["--device", "cpu", *extra])
    return jargs, pargs


def _models(monkeypatch, num_classes=3):
    jm = jcls.ClassificationModel(jbert.bert_config(**TINY), num_classes)
    tm = tcls.ClassificationModel(tbert.bert_config(**TINY), num_classes,
                                  device="cpu")
    # the port's init draws the JAX init's values
    monkeypatch.setattr(tm, "init", lambda seed: params_from_jax(
        jax.device_get(jm.init(jax.random.PRNGKey(seed))), tm.cfg,
        device="cpu"))
    return jm, tm


def _record_losses(monkeypatch, module, losses):
    real = module.build_train_step

    def build(*a, **kw):
        step = real(*a, **kw)

        def recorded(*sa):
            out = step(*sa)
            losses.append(float(out[2]["lm loss"]))
            return out
        return recorded
    monkeypatch.setattr(module, "build_train_step", build)


def test_finetune_and_predictions_match_jax(monkeypatch, tmp_path):
    _mnli(tmp_path / "train.tsv", 3 * MB, 0)       # 3 steps of MB
    _mnli(tmp_path / "dev_a.tsv", 10, 1)           # a padded tail batch
    _mnli(tmp_path / "dev_b.tsv", 5, 2)
    jargs, pargs = _args()
    jm, tm = _models(monkeypatch)
    # the JAX step on one device, as the port's
    monkeypatch.setattr(j_fu.sh, "shard_params", lambda p, specs: p)
    j_losses, p_losses = [], []
    _record_losses(monkeypatch, j_fu, j_losses)
    _record_losses(monkeypatch, p_fu, p_losses)

    def data(mod_ds):
        train = mod_ds("training", [str(tmp_path / "train.tsv")], IntTok(),
                       SEQ)
        dev = j_fu.named_valid_splits(
            [str(tmp_path / "dev_a.tsv"), str(tmp_path / "dev_b.tsv")],
            lambda name, p: mod_ds(name, [p], IntTok(), SEQ))
        return train, dev

    from tasks.glue.mnli import MNLIDataset as JaxMNLI
    j_train, j_dev = data(JaxMNLI)
    p_train, p_dev = data(MNLIDataset)
    j_params, j_best = j_fu.finetune(jargs, jm, j_train, None)
    p_params, p_best = p_fu.finetune(pargs, tm, p_train, None)
    assert j_best is None and p_best is None
    assert len(p_losses) == len(j_losses) == 3
    np.testing.assert_allclose(p_losses, j_losses, rtol=1e-4)

    accs, preds = {}, {}
    for name, fu, model, params, dev in (
            ("jax", j_fu, jm, j_params, j_dev),
            ("port", p_fu, tm, p_params, p_dev)):
        fn = fu.accuracy_func_provider(
            model, lambda params=params: params, dev, MB,
            output_predictions=True, predictions_dir=str(tmp_path / name))
        accs[name] = fn(2)
        with open(tmp_path / name / "predictions_epoch2.json") as f:
            preds[name] = json.load(f)
    assert accs["port"] == accs["jax"]
    assert list(preds["port"]) == list(preds["jax"]) == ["dev_a", "dev_b"]
    for split, want in preds["jax"].items():
        got = preds["port"][split]
        assert list(got) == list(want) == ["softmaxes", "labels", "ids"]
        assert got["labels"] == want["labels"]
        assert got["ids"] == want["ids"]
        assert len(got["softmaxes"]) == len(want["ids"])
        np.testing.assert_allclose(got["softmaxes"], want["softmaxes"],
                                   atol=1e-5, rtol=0)


def test_finetune_builds_the_optimizer_after_the_bf16_cast(monkeypatch):
    captured = {}

    class Spy(p_fu.MegatronOptimizer):
        def __init__(self, tc, params_dtype=torch.float32, **kw):
            captured["params_dtype"] = params_dtype
            super().__init__(tc, params_dtype=params_dtype, **kw)

    monkeypatch.setattr(p_fu, "MegatronOptimizer", Spy)
    _, pargs = _args(["--bf16"])
    pargs.epochs = 0
    tm = tcls.ClassificationModel(tbert.bert_config(**TINY), 2,
                                  device="cpu")
    # fp32 params from the init, cast before the optimizer sees them
    monkeypatch.setattr(tm, "init", lambda seed: tcls.ClassificationModel(
        tbert.bert_config(**TINY), 2, device="cpu").init(seed))
    params, _ = p_fu.finetune(pargs, tm, [], None)
    assert captured["params_dtype"] == torch.bfloat16
    assert {p.dtype for _, p in tree_leaves_with_path(params)} == \
        {torch.bfloat16}


@pytest.mark.parametrize("pretrained", ["bert", "no_tokentypes_no_pooler"])
def test_load_pretrained_trunk_grafts_as_jax(tmp_path, capsys, pretrained):
    over = {} if pretrained == "bert" else dict(num_tokentypes=0)
    jb = jbert.BertModel(jbert.bert_config(**TINY, **over),
                         add_binary_head=pretrained == "bert")
    src = jax.device_get(jb.init(jax.random.PRNGKey(1)))
    j_ckpt.save_checkpoint(str(tmp_path / "jax"), 5, src)
    checkpointing.save_checkpoint(
        str(tmp_path / "port"), 5,
        params_from_jax(src, tbert.bert_config(**TINY, **over),
                        device="cpu"))
    jm = jcls.ClassificationModel(jbert.bert_config(**TINY), 3)
    tgt = jm.init(jax.random.PRNGKey(2))
    tcfg = tbert.bert_config(**TINY)
    capsys.readouterr()
    want = j_fu.load_pretrained_trunk(tgt, str(tmp_path / "jax"))
    j_lines = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith(" > ")]
    got = p_fu.load_pretrained_trunk(
        params_from_jax(jax.device_get(tgt), tcfg, device="cpu"),
        str(tmp_path / "port"), device="cpu")
    p_lines = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith(" > ")]
    assert p_lines == j_lines
    grafts = {"bert": ["embedding", "transformer", "pooler"],
              "no_tokentypes_no_pooler": ["transformer"]}[pretrained]
    assert [ln.split("'")[1] for ln in p_lines
            if "loaded pretrained" in ln] == grafts
    want_t = params_from_jax(jax.device_get(want), tcfg, device="cpu")
    for (path, a), (path_b, b) in zip(tree_leaves_with_path(got),
                                      tree_leaves_with_path(want_t)):
        assert path == path_b
        assert a.dtype == b.dtype and torch.equal(a, b), path


@pytest.fixture(scope="module")
def glue_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("glue")
    _glue_vocab(tmp / "vocab.txt")
    _write_mnli_tsv(tmp / "train.tsv", 96, seed=0)
    _write_mnli_tsv(tmp / "dev_matched.tsv", 24, seed=1)
    _write_mnli_tsv(tmp / "dev_mismatched.tsv", 24, seed=2)
    save = tmp / "out"
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        best = tasks_main.main([
            "--task", "MNLI", "--train_data", str(tmp / "train.tsv"),
            "--valid_data", str(tmp / "dev_matched.tsv"),
            str(tmp / "dev_mismatched.tsv"),
            "--tokenizer_type", "BertWordPieceLowerCase",
            "--vocab_file", str(tmp / "vocab.txt"),
            "--num_layers", "2", "--hidden_size", "32",
            "--num_attention_heads", "4", "--ffn_hidden_size", "64",
            "--seq_length", "16", "--max_position_embeddings", "16",
            "--micro_batch_size", "8", "--lr", "5e-3",
            "--lr_warmup_fraction", "0.1", "--epochs", "6",
            "--log_interval", "10", "--save", str(save),
            "--save_interval", "1000", "--seed", "42", "--device", "cpu"])
    return best, buf.getvalue(), save


def test_glue_via_main_beats_chance_with_per_split_lines(glue_run):
    best, out, _ = glue_run
    accs = [float(m) for m in re.findall(
        r"validation accuracy ([0-9.]+)%", out)]
    assert len(accs) == 6 and max(accs) > 60.0, accs
    assert best == pytest.approx(max(accs) / 100, abs=1e-4)
    assert "metrics for dev_matched" in out
    assert "metrics for dev_mismatched" in out
    assert re.search(r">> \|epoch: \d+\| overall: correct / total", out)


def test_glue_via_main_writes_predictions_and_best(glue_run):
    _, _, save = glue_run
    for epoch in range(6):
        with open(save / f"predictions_epoch{epoch}.json") as f:
            preds = json.load(f)
        assert list(preds) == ["dev_matched", "dev_mismatched"]
    p = preds["dev_matched"]
    assert len(p["softmaxes"]) == 24 and len(p["labels"]) == 24
    assert len(p["softmaxes"][0]) == 3
    assert abs(sum(p["softmaxes"][0]) - 1.0) < 1e-3
    assert len(set(p["ids"])) == 24
    best = save / "best"
    it, _ = checkpointing.read_tracker(str(best))
    ok, why = checkpointing.validate_checkpoint_dir(
        checkpointing.get_checkpoint_name(str(best), it))
    assert ok, why
    assert checkpointing.read_tracker(str(save))[0] == 6 * 12


def test_race_via_main_beats_chance(tmp_path, capsys):
    _race_vocab(tmp_path / "vocab.txt")
    _write_race_dir(tmp_path / "train", 48, seed=0)
    _write_race_dir(tmp_path / "dev", 16, seed=1)
    best = tasks_main.main([
        "--task", "RACE", "--train_data", str(tmp_path / "train"),
        "--valid_data", str(tmp_path / "dev"),
        "--tokenizer_type", "BertWordPieceLowerCase",
        "--vocab_file", str(tmp_path / "vocab.txt"),
        "--num_layers", "2", "--hidden_size", "32",
        "--num_attention_heads", "4", "--ffn_hidden_size", "64",
        "--seq_length", "32", "--max_position_embeddings", "32",
        "--micro_batch_size", "8", "--lr", "5e-3", "--epochs", "6",
        "--log_interval", "10", "--save", str(tmp_path / "out"),
        "--save_interval", "1000", "--seed", "42", "--device", "cpu"])
    assert best > 0.5
    (dump,) = [p for p in (tmp_path / "out").iterdir()
               if p.name == "predictions_epoch5.json"]
    with open(dump) as f:
        preds = json.load(f)
    (split,) = preds
    assert split == "dev" and len(preds[split]["softmaxes"][0]) == 4
