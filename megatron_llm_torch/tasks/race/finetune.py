"""RACE finetune driver (the counterpart of the root
``tasks/race/finetune.py``): multiple-choice model — samples are [C, s]
stacks, scored with a shared 1-logit head."""

from __future__ import annotations

import numpy as np

from megatron_llm_torch.models.classification import MultipleChoiceModel
from megatron_llm_torch.tasks.finetune_utils import (
    finetune,
    named_valid_splits,
)
from megatron_llm_torch.tasks.model_utils import bert_task_config
from megatron_llm_torch.tasks.race.data import RaceDataset


def race_collate(samples):
    """[C, s] per sample -> batch dict with the choice axis kept
    ([b, C, s]: ``MultipleChoiceModel`` flattens it)."""
    return {
        "tokens": np.stack([s["text"] for s in samples]).astype(np.int32),
        "tokentype_ids": np.stack([s["types"] for s in samples]
                                  ).astype(np.int32),
        "attention_mask": np.stack([s["padding_mask"] for s in samples]
                                   ).astype(np.int32),
        "labels": np.asarray([s["label"] for s in samples], np.int32),
        "loss_mask": np.ones(len(samples), np.float32),
    }


def main(args, tokenizer):
    train_ds = RaceDataset("training", args.train_data, tokenizer,
                           args.seq_length)
    # one dataset per dev path -> per-split accuracy
    valid_ds = None
    if args.valid_data:
        valid_ds = named_valid_splits(
            args.valid_data,
            lambda name, p: RaceDataset(name, [p], tokenizer,
                                        args.seq_length))

    model = MultipleChoiceModel(bert_task_config(args), device=args.device)
    _, best = finetune(args, model, train_ds, valid_ds,
                       collate=race_collate)
    if best is not None:
        print(f"best validation accuracy: {best * 100:.2f}%", flush=True)
    return best
