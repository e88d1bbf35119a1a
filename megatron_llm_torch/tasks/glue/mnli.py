"""MNLI (3-class NLI over premise/hypothesis TSV) — reference:
tasks/glue/mnli.py."""

from __future__ import annotations

from megatron_llm_torch.tasks.data_utils import clean_text
from megatron_llm_torch.tasks.glue.data import GLUEAbstractDataset

LABELS = {"contradiction": 0, "entailment": 1, "neutral": 2}


class MNLIDataset(GLUEAbstractDataset):
    def __init__(self, name, datapaths, tokenizer, max_seq_length,
                 test_label="contradiction"):
        self.test_label = test_label
        super().__init__("MNLI", name, datapaths, tokenizer, max_seq_length)

    def process_samples_from_single_path(self, filename):
        samples = []
        is_test = False
        with open(filename) as f:
            for lineno, line in enumerate(f):
                row = line.strip().split("\t")
                if lineno == 0:
                    # the unlabeled test TSV has 10 columns
                    is_test = len(row) == 10
                    continue
                text_a = clean_text(row[8].strip())
                text_b = clean_text(row[9].strip())
                label = self.test_label if is_test else row[-1].strip()
                uid = int(row[0].strip())
                assert text_a and text_b and label in LABELS and uid >= 0
                samples.append({"text_a": text_a, "text_b": text_b,
                                "label": LABELS[label], "uid": uid})
        return samples
