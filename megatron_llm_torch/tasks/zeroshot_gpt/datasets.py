"""Zero-shot LM evaluation datasets (reference:
tasks/zeroshot_gpt/datasets.py): sliding-window perplexity over a single
detokenized corpus (WIKITEXT103) and last-word cloze accuracy (LAMBADA).
"""

from __future__ import annotations

import json
import math

import numpy as np

from megatron_llm_torch.tasks.zeroshot_gpt.detokenizer import get_detokenizer


class LMDataset:
    """Overlapping [seq_len+1] windows over one long token stream; the pad
    mask zeroes positions already scored by a previous window."""

    def __init__(self, tokens, seq_len, pad_idx, num_original_tokens,
                 num_tokenized_tokens, overlapping_eval=None):
        self.tokens = list(tokens)
        self.seq_len = seq_len
        self.pad_idx = pad_idx
        self.overlapping_eval = max(1, overlapping_eval or seq_len)
        self.num_original_tokens = num_original_tokens
        self.num_tokenized_tokens = num_tokenized_tokens
        targets = max(len(self.tokens) - 1 - self.overlapping_eval, 0)
        self.total_sequences = max(
            math.ceil(targets / self.overlapping_eval) + 1, 1)

    def __len__(self):
        return self.total_sequences

    def __getitem__(self, idx):
        start = idx * self.overlapping_eval
        toks = self.tokens[start:start + self.seq_len + 1]
        n = len(toks)
        pad_mask = [1] * n
        if n < self.seq_len + 1:
            pad = self.seq_len + 1 - n
            toks = toks + [self.pad_idx] * pad
            pad_mask += [0] * pad
        pad_mask = np.asarray(pad_mask[1:], np.int64)
        if self.overlapping_eval != self.seq_len and idx != 0:
            # only the new tail tokens count in overlapped windows
            pad_mask[:-self.overlapping_eval] = 0
        return {"text": np.asarray(toks, np.int64), "pad_mask": pad_mask}


class LambadaDataset:
    """Cloze: predict the final word's token(s) given the passage."""

    def __init__(self, path, pad_idx, tokenizer, seq_len, strict=False):
        self.seq_len = seq_len
        self.pad_idx = pad_idx
        self.tokens, self.labels = [], []
        with open(path) as f:
            for line in f:
                text = json.loads(line)["text"]
                toks, labels = self._split(text, tokenizer, strict)
                self.tokens.append(toks)
                self.labels.append(labels)

    @staticmethod
    def _split(text, tokenizer, strict):
        if not strict:
            ids = tokenizer.tokenize(text)
            return ids[:-1], [ids[-1]]
        # strict: re-tokenize the prefix and the final whitespace word
        last_word = text.split()[-1]
        start = text.rfind(last_word)
        prefix = tokenizer.tokenize(text[:start].strip())
        label = tokenizer.tokenize(" " + last_word)
        return prefix, label

    def __len__(self):
        return len(self.tokens)

    def __getitem__(self, idx):
        toks = list(self.tokens[idx])
        labels = list(self.labels[idx])
        # left-truncate over-long rows so every row is exactly seq_len+1
        # wide: a single long passage must not produce a ragged batch
        # (np.stack raise) or a shape-mismatched jit input.  Degenerate
        # case first: a label longer than the whole window keeps only its
        # own tail.
        if len(labels) > self.seq_len + 1:
            labels = labels[-(self.seq_len + 1):]
        keep = self.seq_len + 1 - len(labels)
        if len(toks) > keep:
            toks = toks[len(toks) - keep:]
        pad_mask = [0] * len(toks) + [1] * len(labels)
        toks = toks + labels
        if len(toks) < self.seq_len + 1:
            pad = self.seq_len + 1 - len(toks)
            pad_mask += [0] * pad
            toks += [self.pad_idx] * pad
        return {"text": np.asarray(toks, np.int64),
                "pad_mask": np.asarray(pad_mask[1:], np.int64)}


def build_dataset(task, args, tokenizer):
    if task == "LAMBADA":
        assert len(args.valid_data) == 1
        return LambadaDataset(args.valid_data[0], tokenizer.eod, tokenizer,
                              args.seq_length, args.strict_lambada)
    if task == "WIKITEXT103":
        assert len(args.valid_data) == 1
        with open(args.valid_data[0], "rb") as f:
            raw = f.read().decode("utf-8")
        num_original_tokens = len(raw.strip().split(" "))
        detok = get_detokenizer(args.valid_data[0])(raw)
        tokens = tokenizer.tokenize(detok)
        print(f" > original tokens {num_original_tokens}, tokenized "
              f"{len(tokens)}", flush=True)
        return LMDataset(tokens, args.seq_length, tokenizer.eod,
                         num_original_tokens, len(tokens),
                         args.overlapping_eval)
    raise NotImplementedError(f"no dataset for task {task!r}")
