"""The port's zero-shot tasks (``megatron_llm_torch/tasks/zeroshot_gpt/``)
against the root package's, from the same JAX-initialised params carried
across by ``megatron_llm_torch/weights.py``, at tiny shapes (a GPT of 2
layers, h 64, 4 heads, seq 16, vocab 64), inputs from numpy with a seed,
in fp32: ``evaluate``'s loss sum within 1e-5 relative and its count
correct equal (with a padded tail batch), ``score_choices``' scores
within 1e-5 with equal accuracy and equal truncation warnings, and
``tasks.main`` end to end on the CPU (WIKITEXT103 and LAMBADA from a
``--load`` checkpoint, PIQA on ``tests/test_mc_tasks.py``'s fixture).
The JAX model takes core attention (no Pallas kernel)."""

import json

import jax
import numpy as np
import pytest
import torch

import tasks.zeroshot_gpt.evaluate as j_eval
import tasks.zeroshot_gpt.mc_tasks as j_mc
from megatron_llm_tpu.config import TransformerConfig as JaxConfig
from megatron_llm_tpu.models.gpt import GPTModel as JaxGPT
from megatron_llm_torch import checkpointing
from megatron_llm_torch.config import TransformerConfig
from megatron_llm_torch.models.gpt import GPTModel
from megatron_llm_torch.tasks import main as tasks_main
from megatron_llm_torch.tasks.zeroshot_gpt import evaluate as p_eval
from megatron_llm_torch.tasks.zeroshot_gpt import mc_tasks as p_mc
from megatron_llm_torch.tasks.zeroshot_gpt.datasets import (
    LambadaDataset,
    LMDataset,
)
from megatron_llm_torch.weights import params_from_jax

torch.set_num_threads(1)
VOCAB, SEQ = 64, 16
TINY = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            ffn_hidden_size=128, padded_vocab_size=VOCAB, seq_length=SEQ,
            max_position_embeddings=SEQ, hidden_dropout=0.0,
            attention_dropout=0.0)
# the flags of the same model for tasks.main
TINY_FLAGS = ["--num_layers", "2", "--hidden_size", "64",
              "--num_attention_heads", "4", "--ffn_hidden_size", "128",
              "--seq_length", str(SEQ), "--max_position_embeddings",
              str(SEQ), "--hidden_dropout", "0", "--attention_dropout", "0",
              "--device", "cpu"]


@pytest.fixture(scope="module")
def models():
    jm = JaxGPT(JaxConfig(**TINY, use_flash_attn=False))
    jp = jm.init(jax.random.PRNGKey(5))
    tm = GPTModel(TransformerConfig(**TINY), device="cpu")
    return jm, jp, tm, params_from_jax(jax.device_get(jp), tm.cfg,
                                       device="cpu")


class IdTok:
    """Whitespace-separated integer ids."""
    eod = pad = 0

    def tokenize(self, text):
        return [int(t) for t in text.split()]

    def detokenize(self, ids):
        return " ".join(str(i) for i in ids)


def _cloze_file(path, tm, tp, n=11, seed=0):
    """Cloze lines whose last id is, for every other line, the model's
    argmax after the prefix (so the count correct is not 0)."""
    rs = np.random.RandomState(seed)
    lines = []
    for i in range(n):
        prefix = rs.randint(1, VOCAB, rs.randint(3, SEQ)).tolist()
        if i % 2 == 0:
            with torch.no_grad():
                logits = tm(tp, torch.tensor([prefix]))
            last = int(logits[0, -1].argmax())
        else:
            last = int(rs.randint(1, VOCAB))
        lines.append(" ".join(str(t) for t in prefix + [last]))
    path.write_text("\n".join(json.dumps({"text": t}) for t in lines) + "\n")


def _stream(n=150, seed=1):
    return np.random.RandomState(seed).randint(1, VOCAB, n).tolist()


@pytest.mark.parametrize("bs", [4, 7])
def test_evaluate_loss_sum_matches_jax(models, bs):
    jm, jp, tm, tp = models
    toks = _stream()
    ds = LMDataset(toks, SEQ, 0, len(toks), len(toks), overlapping_eval=5)
    assert len(ds) % bs          # a padded tail batch
    want = j_eval.evaluate(ds, jm, jp, "loss", bs, log_interval=100)
    got = p_eval.evaluate(ds, tm, tp, "loss", bs, log_interval=100)
    assert got == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("bs", [2, 4])
def test_evaluate_num_correct_matches_jax(models, tmp_path, bs):
    jm, jp, tm, tp = models
    _cloze_file(tmp_path / "l.jsonl", tm, tp)
    ds = LambadaDataset(str(tmp_path / "l.jsonl"), 0, IdTok(), SEQ)
    want = j_eval.evaluate(ds, jm, jp, "accuracy", bs, log_interval=100)
    got = p_eval.evaluate(ds, tm, tp, "accuracy", bs, log_interval=100)
    assert want >= 6 and got == want


WORDS = ["the", "cat", "sat", "good", "bad", "yes", "no", "big", "dog"]


class WordTok:
    """tests/test_mc_tasks.py's word tokenizer."""
    pad = 0

    def tokenize(self, text):
        return [5 + WORDS.index(w) for w in text.lower().split()
                if w in WORDS]


def _mc_samples(seed=2, n=7):
    rs = np.random.RandomState(seed)

    def words(k):
        return " ".join(rs.choice(WORDS, k))

    out = []
    for i in range(n):
        nc = 2 + i % 3
        # long contexts are left-truncated at seq 16, a long
        # continuation loses the whole context
        ctx = words(int(rs.randint(2, 14 if i != 3 else 30)))
        choices = [" " + words(int(rs.randint(1, 5 if i != 5 else 20)))
                   for _ in range(nc)]
        out.append({"context": ctx, "choices": choices,
                    "gold": int(rs.randint(nc))})
    out.append({"contexts": ["the cat", "the dog"],
                "choices": [" sat", " sat"], "gold": 1})
    return out


@pytest.mark.parametrize("length_normalize", [False, True])
def test_score_choices_matches_jax(models, capsys, length_normalize):
    jm, jp, tm, tp = models
    samples = _mc_samples()
    acc_j, s_j = j_mc.score_choices(jm, jp, WordTok(), samples, SEQ,
                                    batch_size=4,
                                    length_normalize=length_normalize)
    warn_j = capsys.readouterr().out
    acc_p, s_p = p_mc.score_choices(tm, tp, WordTok(), samples, SEQ,
                                    batch_size=4,
                                    length_normalize=length_normalize)
    warn_p = capsys.readouterr().out
    assert "left-truncated" in warn_j and warn_p == warn_j
    assert acc_p == acc_j
    assert np.array_equal(np.isinf(s_p), np.isinf(s_j))
    fin = np.isfinite(s_j)
    np.testing.assert_allclose(s_p[fin], s_j[fin], atol=1e-5, rtol=0)


def test_parsers_match(tmp_path):
    recs = {
        "PIQA": {"goal": "g", "sol1": "a", "sol2": "b", "label": 1},
        "HELLASWAG": {"ctx_a": "c", "ctx_b": "d",
                      "endings": ["x", "y", "z", "w"], "label": 2},
        "ARC-EASY": {"question": "q", "choices": {
            "text": ["a", "b", "c"], "label": ["A", "B", "C"]},
            "answerKey": "B"},
        "BOOLQ": {"passage": "p", "question": "q", "answer": "true"},
        "WINOGRANDE": {"sentence": "the _ sat", "option1": "cat",
                       "option2": "dog", "answer": "2"},
    }
    for task, rec in recs.items():
        p = tmp_path / f"{task}.jsonl"
        p.write_text(json.dumps(rec) + "\n\n" + json.dumps(rec) + "\n")
        assert p_mc.load_mc_samples(task, str(p)) == \
            j_mc.load_mc_samples(task, str(p))
    assert p_mc.LENGTH_NORMALIZED == j_mc.LENGTH_NORMALIZED
    assert set(p_mc.PARSERS) == set(j_mc.PARSERS)


def test_zeroshot_tasks_via_main_from_a_checkpoint(models, tmp_path):
    """WIKITEXT103 and LAMBADA through tasks.main with ``--load``: the
    results equal ``evaluate`` on the loaded params."""
    jm, jp, tm, tp = models
    checkpointing.save_checkpoint(str(tmp_path / "ck"), 3, tp)
    wiki = tmp_path / "wiki.valid.tokens"
    wiki.write_text(" ".join(str(t) for t in _stream(90, seed=4)))
    _cloze_file(tmp_path / "l.jsonl", tm, tp, n=5, seed=3)
    flags = TINY_FLAGS + ["--tokenizer_type", "NullTokenizer",
                          "--vocab_size", str(VOCAB - 1),
                          "--make_vocab_size_divisible_by", "64",
                          "--load", str(tmp_path / "ck"),
                          "--micro_batch_size", "3"]
    loss = tasks_main.main(["--task", "WIKITEXT103", "--valid_data",
                            str(wiki), "--overlapping_eval", "6"] + flags)
    toks = _stream(90, seed=4)
    ds = LMDataset(toks, SEQ, VOCAB - 1, len(toks), len(toks), 6)
    assert loss == pytest.approx(
        p_eval.evaluate(ds, tm, tp, "loss", 3, 100), rel=1e-6)
    correct = tasks_main.main(["--task", "LAMBADA", "--valid_data",
                               str(tmp_path / "l.jsonl")] + flags)
    assert correct >= 2


def test_piqa_via_main(tmp_path, capsys):
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS) + "\n")
    data = tmp_path / "piqa.jsonl"
    recs = [{"goal": "the cat", "sol1": "good", "sol2": "bad", "label": 0},
            {"goal": "the dog", "sol1": "bad", "sol2": "good", "label": 1}]
    data.write_text("\n".join(json.dumps(r) for r in recs) + "\n")
    acc = tasks_main.main([
        "--task", "PIQA", "--valid_data", str(data),
        "--tokenizer_type", "BertWordPieceLowerCase",
        "--vocab_file", str(vocab), "--num_layers", "2",
        "--hidden_size", "32", "--num_attention_heads", "4",
        "--ffn_hidden_size", "64", "--seq_length", "16",
        "--max_position_embeddings", "16", "--micro_batch_size", "2",
        "--device", "cpu"])
    assert "PIQA: acc =" in capsys.readouterr().out
    assert acc in (0.0, 0.5, 1.0)
