"""GLUE finetune driver (the counterpart of the root
``tasks/glue/finetune.py``): builds the 3-class (MNLI) or 2-class (QQP)
classification model over the BERT trunk and runs the generic epoch
loop."""

from __future__ import annotations

from megatron_llm_torch.models.classification import ClassificationModel
from megatron_llm_torch.tasks.finetune_utils import (
    finetune,
    named_valid_splits,
)
from megatron_llm_torch.tasks.model_utils import bert_task_config


def main(args, tokenizer):
    if args.task == "MNLI":
        from megatron_llm_torch.tasks.glue.mnli import MNLIDataset as Dataset
        num_classes = 3
    elif args.task == "QQP":
        from megatron_llm_torch.tasks.glue.qqp import QQPDataset as Dataset
        num_classes = 2
    else:
        raise ValueError(f"unknown GLUE task {args.task!r}")

    train_ds = Dataset("training", args.train_data, tokenizer,
                       args.seq_length)
    # one dataset per dev file -> per-split accuracy reporting (e.g. MNLI
    # dev-matched + dev-mismatched)
    valid_ds = None
    if args.valid_data:
        valid_ds = named_valid_splits(
            args.valid_data,
            lambda name, p: Dataset(name, [p], tokenizer, args.seq_length))

    model = ClassificationModel(bert_task_config(args), num_classes,
                                device=args.device)
    _, best = finetune(args, model, train_ds, valid_ds)
    if best is not None:
        print(f"best validation accuracy: {best * 100:.2f}%", flush=True)
    return best
