"""The port's ORQA retrieval evaluation
(``megatron_llm_torch/tasks/orqa/evaluate_orqa.py``) against the root
package's, from the same JAX-initialised biencoder (2 layers, h 64,
projection 8, seq 24; carried by ``megatron_llm_torch/weights.py``) in
fp32: ``_recall_eval``'s recall@k equal through ``evaluate_retriever``
(ICT blocks of an indexed corpus) and ``evaluate_retriever_wiki`` (a DPR
wiki TSV), over one embedding store and a padded tail batch of
questions; and ``tasks.main`` end to end on the CPU: RETRIEVER-EVAL on
``tests/test_orqa_wiki.py``'s fixture (the store built by the port's
indexer, then reused) and ICT-ZEROSHOT-NQ from a ``--load`` checkpoint."""

import json
import re

import jax
import numpy as np
import pytest
import torch

import tasks.orqa.evaluate_orqa as j_orqa
from megatron_llm_tpu.data import ict_dataset as jid
from megatron_llm_tpu.data import orqa_wiki_dataset as jow
from megatron_llm_tpu.data import realm_index as jri
from megatron_llm_torch import checkpointing
from megatron_llm_torch.data import ict_dataset as tid
from megatron_llm_torch.data import orqa_wiki_dataset as tow
from megatron_llm_torch.data import realm_index as tri
from megatron_llm_torch.indexer import EvidenceIndexBuilder, IndexBuilder
from megatron_llm_torch.tasks import main as tasks_main
from megatron_llm_torch.tasks.orqa import evaluate_orqa as p_orqa
from test_orqa_wiki import _write_evidence, _write_vocab
from test_torch_bert_t5_data import ToyTok, _biencoder_pair, _write

torch.set_num_threads(1)
SEQ, PROJ, TOPK = 24, 8, (1, 5, 20)


class WTok(ToyTok):
    """ids written as words ``w<id>``."""

    def tokenize(self, text):
        return [int(w[1:]) for w in text.split()]

    def detokenize(self, ids):
        return " ".join(f"w{i}" for i in ids)


def _ict(mod, prefix, blocks, titles):
    return mod.ICTDataset(name="full", block_dataset=blocks,
                          title_dataset=titles, data_prefix=prefix,
                          num_epochs=1, max_num_samples=None,
                          max_seq_length=SEQ, query_in_block_prob=1.0,
                          seed=1, tokenizer=WTok(), use_one_sent_docs=True)


def _questions(texts, n=13, seed=0):
    """Questions of random ids; each answer is two neighbouring words of
    one block, so some are retrieved and some are not."""
    rs = np.random.RandomState(seed)
    qa = []
    for _ in range(n):
        words = texts[int(rs.randint(len(texts)))].split()
        i = int(rs.randint(len(words) - 1))
        q = " ".join(f"w{t}" for t in rs.randint(10, 90, 6))
        qa.append((q, [" ".join(words[i:i + 2])]))
    return qa


@pytest.fixture(scope="module")
def biencoder():
    return _biencoder_pair(projection_dim=PROJ, seq=SEQ)


def test_recall_over_ict_blocks_matches_jax(biencoder, tmp_path):
    jm, jp, tm, tp = biencoder
    ds = {}
    for side, mod in (("jax", jid), ("port", tid)):
        prefix, blocks = _write(str(tmp_path / side / "corpus"), 0,
                                n_docs=30)
        _, titles = _write(str(tmp_path / side / "titles"), 1, n_docs=30,
                           titles=True)
        ds[side] = _ict(mod, prefix, blocks, titles)
    store = str(tmp_path / "embed.pkl")
    IndexBuilder(tm, tp, ds["port"], store, batch_size=8
                 ).build_and_save_index()
    texts = []
    for start, end, doc, _ in np.asarray(ds["port"].samples_mapping):
        toks, _ = ds["port"].get_block(int(start), int(end), int(doc))
        texts.append(WTok().detokenize([int(t) for t in toks if t]))
    qa = _questions(texts)
    got, n = p_orqa.evaluate_retriever(
        tm, tp, ds["port"], tri.BruteForceMIPSIndex(
            PROJ, tri.OpenRetrievalDataStore(store)), qa, WTok(),
        topk_list=TOPK, batch_size=4)
    want, jn = j_orqa.evaluate_retriever(
        jm, jp, ds["jax"], jri.BruteForceMIPSIndex(
            PROJ, jri.OpenRetrievalDataStore(store)), qa, WTok(),
        topk_list=TOPK, batch_size=4)
    assert n == jn == len(qa)
    assert got == want
    assert 0.0 < got["recall@20"] and got["recall@1"] < 1.0


WORDS = ["paris", "is", "the", "capital", "of", "france", "rome", "italy",
         "berlin", "germany", "cat", "dog", "moon", "cheese", "king"]


class _Tok:
    cls, sep, pad, mask = 2, 3, 0, 4

    def tokenize(self, text):
        return [5 + WORDS.index(w) for w in text.lower().split()
                if w in WORDS]


def test_recall_over_a_wiki_tsv_matches_jax(biencoder, tmp_path):
    jm, jp, tm, tp = biencoder
    rs = np.random.RandomState(3)
    rows = [(i + 1, " ".join(rs.choice(WORDS, 6)), str(rs.choice(WORDS)))
            for i in range(40)]
    tsv = tmp_path / "wiki.tsv"
    tsv.write_text("id\ttext\ttitle\n" + "".join(
        f"{d}\t{t}\t{ti}\n" for d, t, ti in rows))
    p_ds = tow.OpenRetrievalEvidenceDataset(str(tsv), _Tok(), SEQ)
    j_ds = jow.OpenRetrievalEvidenceDataset(str(tsv), _Tok(), SEQ)
    store = str(tmp_path / "emb.pkl")
    EvidenceIndexBuilder(tm, tp, p_ds, store, batch_size=16
                         ).build_and_save_index()
    qa = [(" ".join(rs.choice(WORDS, 4)),
           [" ".join(rows[int(rs.randint(40))][1].split()[2:4])])
          for _ in range(11)]
    got, n = p_orqa.evaluate_retriever_wiki(
        tm, tp, p_ds, tri.BruteForceMIPSIndex(
            PROJ, tri.OpenRetrievalDataStore(store)), qa, _Tok(),
        topk_list=TOPK, batch_size=4)
    want, jn = j_orqa.evaluate_retriever_wiki(
        jm, jp, j_ds, jri.BruteForceMIPSIndex(
            PROJ, jri.OpenRetrievalDataStore(store)), qa, _Tok(),
        topk_list=TOPK, batch_size=4)
    assert n == jn == 11 and got == want
    assert got["recall@20"] > 0.0


def test_retriever_eval_via_main(tmp_path, capsys):
    tsv = tmp_path / "wiki.tsv"
    _write_evidence(tsv)
    vocab = tmp_path / "vocab.txt"
    _write_vocab(vocab)
    qa = tmp_path / "qa.jsonl"
    qa.write_text(
        json.dumps({"question": "capital of france", "answers": ["paris"]})
        + "\n"
        + json.dumps({"question": "capital of italy", "answers": ["rome"]})
        + "\n")
    emb = tmp_path / "emb.pkl"
    argv = ["--task", "RETRIEVER-EVAL", "--evidence_data_path", str(tsv),
            "--embedding_path", str(emb), "--qa_data_dev", str(qa),
            "--tokenizer_type", "BertWordPieceLowerCase",
            "--vocab_file", str(vocab), "--num_layers", "1",
            "--hidden_size", "32", "--num_attention_heads", "4",
            "--ffn_hidden_size", "64", "--seq_length", "16",
            "--max_position_embeddings", "16", "--micro_batch_size", "1",
            "--biencoder_projection_dim", "8",
            "--retriever_report_topk_accuracies", "1", "6",
            "--device", "cpu"]
    first = tasks_main.main(argv)
    out = capsys.readouterr().out
    assert emb.exists() and "absent: embedding 6 evidence rows" in out
    assert re.search(r"recall@6: 100.00%", out), out[-2000:]
    # the second run reads the store it built
    assert tasks_main.main(argv) == first
    assert "absent" not in capsys.readouterr().out


def test_ict_zeroshot_nq_via_main_from_a_checkpoint(biencoder, tmp_path):
    jm, jp, tm, tp = biencoder
    prefix, blocks = _write(str(tmp_path / "corpus"), 0, n_docs=12)
    tprefix, titles = _write(str(tmp_path / "titles"), 1, n_docs=12,
                             titles=True)
    ds = _ict(tid, prefix, blocks, titles)
    store = str(tmp_path / "embed.pkl")
    IndexBuilder(tm, tp, ds, store, batch_size=8).build_and_save_index()
    checkpointing.save_checkpoint(str(tmp_path / "ck"), 2, tp)
    texts = []
    for start, end, doc, _ in np.asarray(ds.samples_mapping):
        toks, _ = ds.get_block(int(start), int(end), int(doc))
        texts.append(WTok().detokenize([int(t) for t in toks if t]))
    qa = _questions(texts, n=5, seed=4)
    (tmp_path / "qa.jsonl").write_text("".join(
        json.dumps({"question": q, "answers": a}) + "\n" for q, a in qa))
    # a WordPiece vocabulary whose id i is the word w<i>, with WTok's
    # special ids
    (tmp_path / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[CLS]", "[SEP]", "[MASK]", "[UNK]"]
        + [f"w{i}" for i in range(5, 510)]) + "\n")
    got = tasks_main.main([
        "--task", "ICT-ZEROSHOT-NQ", "--data_path", prefix,
        "--titles_data_path", tprefix, "--embedding_path", store,
        "--qa_data_dev", str(tmp_path / "qa.jsonl"),
        "--load", str(tmp_path / "ck"),
        "--tokenizer_type", "BertWordPieceLowerCase",
        "--vocab_file", str(tmp_path / "vocab.txt"),
        "--num_layers", "2", "--hidden_size", "64",
        "--num_attention_heads", "4", "--ffn_hidden_size", "128",
        "--seq_length", str(SEQ), "--max_position_embeddings", str(SEQ),
        "--hidden_dropout", "0", "--attention_dropout", "0",
        "--biencoder_projection_dim", str(PROJ), "--use_one_sent_docs",
        "--retriever_report_topk_accuracies", *map(str, TOPK),
        "--device", "cpu"])
    want, _ = p_orqa.evaluate_retriever(
        tm, tp, ds, tri.BruteForceMIPSIndex(
            PROJ, tri.OpenRetrievalDataStore(store)), qa, WTok(),
        topk_list=TOPK)
    assert got == want and set(got) == {"recall@1", "recall@5",
                                        "recall@20"}
