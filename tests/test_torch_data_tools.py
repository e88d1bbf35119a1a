"""The port's corpus tools against the JAX package's: on a JSONL and a
chat JSONL written here, with a byte-level BPE vocabulary written here
(``write_byte_bpe_vocab``), ``megatron_llm_torch.tools.preprocess_data``,
``preprocess_instruct_data`` and ``merge_datasets`` write ``.bin`` /
``.idx`` files byte-identical to those of the repo's ``tools/``."""

import json
import os
import runpy
import sys

import numpy as np
import pytest

from megatron_llm_torch.data.indexed_dataset import MMapIndexedDataset
from megatron_llm_torch.tokenizer.bpe import write_byte_bpe_vocab
from megatron_llm_torch.tools import (
    merge_datasets,
    preprocess_data,
    preprocess_instruct_data,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ("the model reads a corpus of plain text. It writes tokens! Does "
         "it? Yes: every document ends with an end-of-document id.").split()


def _jax_tool(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name] + [str(a) for a in argv])
    runpy.run_path(os.path.join(REPO, "tools", name), run_name="__main__")


def _same_files(a, b):
    for ext in (".bin", ".idx"):
        with open(a + ext, "rb") as fa, open(b + ext, "rb") as fb:
            assert fa.read() == fb.read(), ext


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("corpus")
    rng = np.random.RandomState(0)
    with open(tmp / "docs.jsonl", "w") as f:
        for i in range(40):
            text = " ".join(rng.choice(WORDS, rng.randint(1, 60)))
            f.write(json.dumps({"text": text, "id": i}) + "\n")
            if i % 9 == 0:
                f.write("\n")                   # blank lines are skipped
    with open(tmp / "chat.jsonl", "w") as f:
        for i in range(12):
            turns = [{"role": r, "content": " ".join(
                rng.choice(WORDS, rng.randint(1, 20)))}
                for r in ("system", "user", "assistant", "user",
                          "assistant")[:rng.randint(2, 6)]]
            f.write(json.dumps({"conversations": turns}) + "\n")
    vf, mf = write_byte_bpe_vocab(str(tmp), 700)
    return tmp, ["--tokenizer_type", "GPT2BPETokenizer", "--vocab_file", vf,
                 "--merge_file", mf]


@pytest.mark.parametrize("flags", [["--append_eod"], ["--split_sentences"],
                                   ["--append_eod", "--split_sentences"]],
                         ids=["eod", "sentences", "eod-sentences"])
def test_preprocess_data_writes_the_jax_bytes(corpus, flags, monkeypatch):
    tmp, tok = corpus
    name = "-".join(f.strip("-") for f in flags)
    common = ["--input", tmp / "docs.jsonl"] + tok + flags
    _jax_tool("preprocess_data.py", common + [
        "--output_prefix", tmp / f"jax-{name}"], monkeypatch)
    # the port with two workers once: the documents keep their order
    workers = "2" if name == "append_eod" else "1"
    preprocess_data.main([str(a) for a in common] + [
        "--output_prefix", str(tmp / f"port-{name}"), "--workers", workers])
    _same_files(str(tmp / f"jax-{name}"), str(tmp / f"port-{name}"))
    ds = MMapIndexedDataset(str(tmp / f"port-{name}"))
    assert len(ds.doc_idx) == 41 and ds.dtype == np.uint16


def test_preprocess_instruct_data_writes_the_jax_bytes(corpus, monkeypatch):
    tmp, tok = corpus
    common = ["--input", tmp / "chat.jsonl", "--append_eod"] + tok
    _jax_tool("preprocess_instruct_data.py",
              common + ["--output_prefix", tmp / "jax-chat"], monkeypatch)
    preprocess_instruct_data.main([str(a) for a in common] + [
        "--output_prefix", str(tmp / "port-chat")])
    for part in ("-text", "-role"):
        _same_files(str(tmp / f"jax-chat{part}"),
                    str(tmp / f"port-chat{part}"))
    roles = MMapIndexedDataset(str(tmp / "port-chat-role"))
    assert roles.dtype == np.int8 and len(roles) == 12


def test_merge_datasets_writes_the_jax_bytes(corpus, monkeypatch):
    tmp, tok = corpus
    for part in ("a", "b"):
        preprocess_data.main([
            "--input", str(tmp / "docs.jsonl"), *tok, "--append_eod",
            "--output_prefix", str(tmp / f"part-{part}")])
    inputs = [str(tmp / "part-a"), str(tmp / "part-b")]
    _jax_tool("merge_datasets.py", ["--input", *inputs, "--output_prefix",
                                    tmp / "jax-merged"], monkeypatch)
    merge_datasets.main(["--input", *inputs, "--output_prefix",
                         str(tmp / "port-merged")])
    _same_files(str(tmp / "jax-merged"), str(tmp / "port-merged"))
    assert len(MMapIndexedDataset(str(tmp / "port-merged")).doc_idx) == 81
