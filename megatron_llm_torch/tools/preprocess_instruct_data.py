#!/usr/bin/env python
"""Chat jsonl -> paired (text, role) mmap datasets for instruction tuning:
the twin of the repo's ``tools/preprocess_instruct_data.py`` on the port's
``data/`` and ``tokenizer/``, with the same flags and the same bytes out.

Reference: ``tools/preprocess_instruct_data.py`` — each jsonl line is a
conversation (list of {role, content} turns); tokens are written to a
``-text`` dataset and the per-token role ids to a parallel ``-role``
dataset, consumed by ``InstructionDataset``.
"""

import argparse
import json

from megatron_llm_torch.data.indexed_dataset import (
    MMapIndexedDatasetBuilder,
    best_fitting_dtype,
    data_file_path,
    index_file_path,
)
from megatron_llm_torch.data.instruction_dataset import ROLES
from megatron_llm_torch.tokenizer import build_tokenizer


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input", required=True)
    p.add_argument("--output_prefix", "--output-prefix",
                   dest="output_prefix", required=True)
    p.add_argument("--tokenizer_type", dest="tokenizer_type", required=True)
    p.add_argument("--vocab_file", dest="vocab_file")
    p.add_argument("--merge_file", dest="merge_file")
    p.add_argument("--tokenizer_path", dest="tokenizer_path")
    p.add_argument("--vocab_size", type=int, default=None)
    p.add_argument("--conversation_key", default="conversations")
    p.add_argument("--append_eod", action="store_true")
    args = p.parse_args(argv)
    args.make_vocab_size_divisible_by = 128
    args.tensor_model_parallel_size = 1
    args.rank = 0
    return args


def main(argv=None):
    args = get_args(argv)
    tok = build_tokenizer(args)
    text_b = MMapIndexedDatasetBuilder(
        data_file_path(args.output_prefix + "-text"),
        dtype=best_fitting_dtype(tok.vocab_size),
    )
    role_b = MMapIndexedDatasetBuilder(
        data_file_path(args.output_prefix + "-role"), dtype="int8"
    )
    n = 0
    with open(args.input, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            conv = json.loads(line)[args.conversation_key]
            ids, roles = [], []
            for turn in conv:
                role_id = ROLES.get(turn["role"])
                if role_id is None:
                    raise ValueError(f"unknown role {turn['role']!r}")
                t = tok.tokenize(turn["content"])
                ids.extend(t)
                roles.extend([role_id] * len(t))
            if args.append_eod:
                ids.append(tok.eod)
                roles.append(ROLES["assistant"])
            text_b.add_item(ids)
            text_b.end_document()
            role_b.add_item(roles)
            role_b.end_document()
            n += 1
    text_b.finalize(index_file_path(args.output_prefix + "-text"))
    role_b.finalize(index_file_path(args.output_prefix + "-role"))
    print(f" done: {n} conversations -> {args.output_prefix}-text/-role")


if __name__ == "__main__":
    main()
