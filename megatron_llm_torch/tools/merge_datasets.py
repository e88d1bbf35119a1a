#!/usr/bin/env python
"""Merge multiple mmap datasets with the same dtype into one (the twin of
the repo's ``tools/merge_datasets.py`` on the port's
``data/indexed_dataset.py``; reference: tools/merge_datasets.py)."""

import argparse

from megatron_llm_torch.data.indexed_dataset import (
    MMapIndexedDataset,
    MMapIndexedDatasetBuilder,
    data_file_path,
    index_file_path,
)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input", nargs="+", required=True,
                   help="dataset prefixes to merge, in order")
    p.add_argument("--output_prefix", "--output-prefix",
                   dest="output_prefix", required=True)
    args = p.parse_args(argv)

    first = MMapIndexedDataset(args.input[0])
    builder = MMapIndexedDatasetBuilder(
        data_file_path(args.output_prefix), dtype=first.dtype
    )
    for prefix in args.input:
        builder.merge_file_(prefix)
        print(f" merged {prefix}")
    builder.finalize(index_file_path(args.output_prefix))
    print(f" done -> {args.output_prefix}.bin/.idx")


if __name__ == "__main__":
    main()
