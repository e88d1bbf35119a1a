"""QQP (Quora question-pair duplicate detection TSV) — reference:
tasks/glue/qqp.py."""

from __future__ import annotations

from megatron_llm_torch.tasks.data_utils import clean_text
from megatron_llm_torch.tasks.glue.data import GLUEAbstractDataset

LABELS = [0, 1]


class QQPDataset(GLUEAbstractDataset):
    def __init__(self, name, datapaths, tokenizer, max_seq_length,
                 test_label=0):
        self.test_label = test_label
        super().__init__("QQP", name, datapaths, tokenizer, max_seq_length)

    def process_samples_from_single_path(self, filename):
        samples = []
        is_test = False
        drop = 0
        with open(filename) as f:
            for lineno, line in enumerate(f):
                row = line.strip().split("\t")
                if lineno == 0:
                    # test TSV: id, question1, question2 (3 columns)
                    is_test = len(row) == 3
                    continue
                if is_test:
                    if len(row) != 3:
                        drop += 1
                        continue
                    uid = int(row[0].strip())
                    text_a = clean_text(row[1].strip())
                    text_b = clean_text(row[2].strip())
                    label = self.test_label
                else:
                    if len(row) != 6:
                        drop += 1
                        continue
                    uid = int(row[0].strip())
                    text_a = clean_text(row[3].strip())
                    text_b = clean_text(row[4].strip())
                    label = int(row[5].strip())
                if not (text_a and text_b and label in LABELS and uid >= 0):
                    drop += 1
                    continue
                samples.append({"text_a": text_a, "text_b": text_b,
                                "label": label, "uid": uid})
        if drop:
            print(f" > dropped {drop} malformed rows", flush=True)
        return samples
