"""RACE reading-comprehension dataset (4-way multiple choice).

Reference: ``tasks/race/data.py`` — each *.txt file holds jsonl records
{article, questions, options, answers}; every question becomes one sample
of NUM_CHOICES stacked [CLS] qa [SEP] article [SEP] sequences.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from megatron_llm_torch.tasks.data_utils import (
    build_tokens_types_paddings_from_ids,
    clean_text,
)

NUM_CHOICES = 4
MAX_QA_LENGTH = 128


class RaceDataset:
    def __init__(self, dataset_name, datapaths, tokenizer, max_seq_length,
                 max_qa_length: int = MAX_QA_LENGTH):
        self.dataset_name = dataset_name
        self.sample_multiplier = NUM_CHOICES
        self.samples = []
        for path in datapaths:
            self.samples.extend(_process_path(path, tokenizer, max_qa_length,
                                              max_seq_length))
        print(f" > RACE/{dataset_name}: {len(self.samples)} samples",
              flush=True)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        return self.samples[idx]


def _process_path(datapath, tokenizer, max_qa_length, max_seq_length):
    samples = []
    uid = 0
    for filename in sorted(glob.glob(os.path.join(datapath, "*.txt"))):
        with open(filename) as f:
            for line in f:
                record = json.loads(line)
                context_ids = tokenizer.tokenize(clean_text(record["article"]))
                for q, opts, ans in zip(record["questions"],
                                        record["options"],
                                        record["answers"]):
                    label = ord(ans) - ord("A")
                    assert 0 <= label < NUM_CHOICES == len(opts)
                    ids_c, types_c, pads_c = [], [], []
                    for choice in opts:
                        # cloze-style questions substitute the blank
                        qa = (q.replace("_", choice) if "_" in q
                              else f"{q} {choice}")
                        qa_ids = tokenizer.tokenize(clean_text(qa))
                        qa_ids = qa_ids[:max_qa_length]
                        ids, types, pads = build_tokens_types_paddings_from_ids(
                            qa_ids, list(context_ids), max_seq_length,
                            tokenizer.cls, tokenizer.sep, tokenizer.pad)
                        ids_c.append(ids)
                        types_c.append(types)
                        pads_c.append(pads)
                    samples.append({
                        "text": np.asarray(ids_c, np.int64),          # [C, s]
                        "types": np.asarray(types_c, np.int64),
                        "padding_mask": np.asarray(pads_c, np.int64),
                        "label": np.int64(label),
                        "uid": np.int64(uid),
                    })
                    uid += 1
    return samples
