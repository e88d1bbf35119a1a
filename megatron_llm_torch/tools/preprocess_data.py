#!/usr/bin/env python
"""jsonl -> mmap indexed dataset (multi-process): the twin of the repo's
``tools/preprocess_data.py`` on the port's ``data/indexed_dataset.py`` and
``tokenizer/``, with the same flags and the same bytes out.

Reference: ``tools/preprocess_data.py`` — reads a jsonl with one document
per line, tokenizes (optionally splitting sentences / appending EOD), and
writes the (bin, idx) pair with worker parallelism.

    python -m megatron_llm_torch.tools.preprocess_data --input docs.jsonl \
        --tokenizer_type GPT2BPETokenizer --vocab_file vocab.json \
        --merge_file merges.txt --append_eod --output_prefix corpus
"""

import argparse
import json
import multiprocessing
import time

from megatron_llm_torch.data.indexed_dataset import (
    MMapIndexedDatasetBuilder,
    best_fitting_dtype,
    data_file_path,
    index_file_path,
)
from megatron_llm_torch.tokenizer import build_tokenizer

_TOKENIZER = None
_ARGS = None


def _init_worker(args):
    global _TOKENIZER, _ARGS
    _ARGS = args
    _TOKENIZER = build_tokenizer(args)


_SENT_RE = None


def _split_sentences(text):
    """Regex sentence splitter (the reference uses nltk punkt; a
    dependency-free splitter on terminal punctuation keeps the same
    one-sequence-per-sentence dataset shape for BERT/T5/ICT)."""
    global _SENT_RE
    if _SENT_RE is None:
        import re
        _SENT_RE = re.compile(r"(?<=[.!?])\s+(?=[^\s])")
    return [s for s in _SENT_RE.split(text) if s.strip()]


def _encode(line):
    line = line.strip()
    if not line:
        return None, 0
    doc = json.loads(line)
    text = doc[_ARGS.json_key]
    if _ARGS.split_sentences:
        # one sequence per sentence, document boundary preserved — the
        # layout BertDataset/T5Dataset/ICTDataset sample spans from
        ids = [_TOKENIZER.tokenize(s) for s in _split_sentences(text)]
        ids = [s for s in ids if s]
        if ids and _ARGS.append_eod:
            ids[-1] = list(ids[-1]) + [_TOKENIZER.eod]
        return (ids if ids else None), len(line)
    ids = _TOKENIZER.tokenize(text)
    if _ARGS.append_eod:
        ids = list(ids) + [_TOKENIZER.eod]
    return ids, len(line)


def get_args(argv=None):
    p = argparse.ArgumentParser()
    g = p.add_argument_group("input data")
    g.add_argument("--input", required=True, help="jsonl input path")
    g.add_argument("--json_key", "--json-keys", dest="json_key",
                   default="text")
    g = p.add_argument_group("tokenizer")
    g.add_argument("--tokenizer_type", "--tokenizer-type",
                   dest="tokenizer_type", required=True,
                   choices=["GPT2BPETokenizer", "SentencePieceTokenizer",
                            "FalconTokenizer", "HFAutoTokenizer",
                            "BertWordPieceLowerCase", "BertWordPieceCase",
                            "NullTokenizer"])
    g.add_argument("--vocab_file", "--vocab-file", dest="vocab_file")
    g.add_argument("--merge_file", "--merge-file", dest="merge_file")
    g.add_argument("--tokenizer_path", dest="tokenizer_path")
    g.add_argument("--vocab_size", type=int, default=None)
    g.add_argument("--append_eod", "--append-eod", dest="append_eod",
                   action="store_true")
    g.add_argument("--split_sentences", "--split-sentences",
                   dest="split_sentences", action="store_true",
                   help="one sequence per sentence (BERT/T5/ICT corpora)")
    g = p.add_argument_group("output")
    g.add_argument("--output_prefix", "--output-prefix",
                   dest="output_prefix", required=True)
    g.add_argument("--workers", type=int, default=1)
    g.add_argument("--log_interval", type=int, default=10000)
    args = p.parse_args(argv)
    args.make_vocab_size_divisible_by = 128
    args.tensor_model_parallel_size = 1
    args.rank = 0
    return args


def main(argv=None):
    args = get_args(argv)
    _init_worker(args)
    vocab_size = _TOKENIZER.vocab_size
    builder = MMapIndexedDatasetBuilder(
        data_file_path(args.output_prefix),
        dtype=best_fitting_dtype(vocab_size),
    )
    t0 = time.time()
    n_docs = n_bytes = 0
    pool = None
    with open(args.input, "r", encoding="utf-8") as f:
        if args.workers > 1:
            # spawned, not forked: the parent may hold torch's threads
            pool = multiprocessing.get_context("spawn").Pool(
                args.workers, initializer=_init_worker, initargs=(args,)
            )
            encoded = pool.imap(_encode, f, chunksize=32)
        else:
            encoded = (_encode(line) for line in f)
        for ids, nb in encoded:
            if ids is None:
                continue
            if args.split_sentences:
                for sent in ids:
                    builder.add_item(sent)
            else:
                builder.add_item(ids)
            builder.end_document()
            n_docs += 1
            n_bytes += nb
            if n_docs % args.log_interval == 0:
                el = time.time() - t0
                print(f" processed {n_docs} documents "
                      f"({n_docs / el:.1f} docs/s, "
                      f"{n_bytes / el / 1024 / 1024:.2f} MB/s)", flush=True)
    if pool is not None:
        pool.close()
        pool.join()
    builder.finalize(index_file_path(args.output_prefix))
    print(f" done: {n_docs} documents -> {args.output_prefix}.bin/.idx")


if __name__ == "__main__":
    main()
