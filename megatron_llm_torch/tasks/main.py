"""Downstream-task driver (the counterpart of the root ``tasks/main.py``).

Usage:
  python -m megatron_llm_torch.tasks.main --task MNLI --train_data .../train.tsv
      --valid_data .../dev.tsv --pretrained_checkpoint ckpt --epochs 3 ...
  python -m megatron_llm_torch.tasks.main --task WIKITEXT103 --valid_data wiki.valid.tokens ...
  python -m megatron_llm_torch.tasks.main --task LAMBADA --valid_data lambada.jsonl ...
  python -m megatron_llm_torch.tasks.main --task RACE --train_data RACE/train/middle ...
  python -m megatron_llm_torch.tasks.main --task RETRIEVER-EVAL --evidence_data_path wiki.tsv ...

The flags are the trainer's (``arguments.py``) plus ``get_tasks_args``;
every task runs on the card unless ``--device cpu``.  ``main(argv)``
returns what the task's ``main(args, tokenizer)`` returns.
"""

from __future__ import annotations

import importlib
import sys
from typing import Optional, Sequence


def get_tasks_args(parser):
    """Extra flags shared by all tasks (reference: tasks/main.py:14-73)."""
    g = parser.add_argument_group("tasks")
    g.add_argument("--task", required=True)
    g.add_argument("--epochs", type=int, default=None,
                   help="finetuning epochs; 0 = evaluate only")
    g.add_argument("--pretrained_checkpoint", default=None)
    g.add_argument("--keep_last", action="store_true")
    g.add_argument("--train_data", nargs="+", default=None)
    g.add_argument("--valid_data", nargs="*", default=None)
    g.add_argument("--overlapping_eval", type=int, default=32)
    g.add_argument("--strict_lambada", action="store_true")
    g.add_argument("--qa_data_dev", default=None)
    g.add_argument("--qa_data_test", default=None)
    g.add_argument("--embedding_path", "--block_data_path",
                   dest="embedding_path", default=None)
    g.add_argument("--evidence_data_path", default=None,
                   help="evidence blocks for retrieval (falls back to "
                        "--data_path)")
    g.add_argument("--retriever_seq_length", type=int, default=None,
                   help="block seq length for retrieval (default: "
                        "--seq_length)")
    g.add_argument("--bert_load", default=None)
    g.add_argument("--ict_load", default=None)
    g.add_argument("--indexer_batch_size", type=int, default=128)
    g.add_argument("--indexer_log_interval", type=int, default=1000)
    g.add_argument("--faiss_match", default="string",
                   choices=["regex", "string"])
    g.add_argument("--faiss_topk_retrievals", type=int, default=100)
    g.add_argument("--eval_micro_batch_size", type=int, default=None)
    g.add_argument("--titles_data_path", default=None)
    g.add_argument("--use_one_sent_docs", action="store_true")
    g.add_argument("--biencoder_projection_dim", "--ict_head_size",
                   dest="biencoder_projection_dim", type=int, default=0)
    g.add_argument("--biencoder_shared_query_context_model",
                   action="store_true")
    g.add_argument("--retriever_report_topk_accuracies", nargs="*",
                   type=int, default=None)
    g.add_argument("--sample_rate", type=float, default=1.0,
                   help="subsample fraction of the evidence corpus "
                        "(reference orqa_wiki_dataset.py:140)")
    # MSDP (multi-stage dialogue prompting) flags
    g.add_argument("--guess_file", default=None)
    g.add_argument("--answer_file", default=None)
    g.add_argument("--prompt_file", default=None)
    g.add_argument("--prompt_type", default=None,
                   choices=[None, "knowledge", "response"])
    g.add_argument("--sample_input_file", default=None)
    g.add_argument("--sample_output_file", default=None)
    g.add_argument("--num_prompt_examples", type=int, default=10)
    g.add_argument("--out_seq_length", type=int, default=100)
    return parser


_PKG = "megatron_llm_torch.tasks"

#: task -> the module whose ``main(args, tokenizer)`` runs it (the
#: dispatch of tasks/main.py:78-100)
TASKS = {
    "RACE": "race.finetune",
    "MNLI": "glue.finetune",
    "QQP": "glue.finetune",
    "LAMBADA": "zeroshot_gpt.evaluate",
    "WIKITEXT103": "zeroshot_gpt.evaluate",
    # beyond-reference: multiple-choice loglikelihood-ranking tasks
    "PIQA": "zeroshot_gpt.mc_tasks",
    "HELLASWAG": "zeroshot_gpt.mc_tasks",
    "ARC-EASY": "zeroshot_gpt.mc_tasks",
    "ARC-CHALLENGE": "zeroshot_gpt.mc_tasks",
    "BOOLQ": "zeroshot_gpt.mc_tasks",
    "WINOGRANDE": "zeroshot_gpt.mc_tasks",
    "ICT-ZEROSHOT-NQ": "orqa.evaluate_orqa",
    "RETRIEVER-EVAL": "orqa.evaluate_orqa",
    "MSDP-PROMPT-KNWL": "msdp.prompt",
    "MSDP-PROMPT-RESP": "msdp.prompt",
    "MSDP-EVAL-F1": "msdp.evaluate",
}

#: tasks that build no model, so need no vocabulary size
_MODEL_FREE = {"MSDP-EVAL-F1"}


def parse(argv: Sequence[str]):
    """(args, tokenizer or None): the trainer's flags and the tasks'
    group, the trainer's refusals, and the tokenizer, which sets
    ``args.padded_vocab_size`` (``pretrain_entry.parse``'s steps)."""
    from megatron_llm_torch.arguments import (
        UNPORTED_TRAINING,
        parse_args,
        refuse_unported,
    )
    from megatron_llm_torch.tokenizer import build_tokenizer

    args = parse_args(list(argv), extra_args_provider=get_tasks_args)
    refuse_unported(args, UNPORTED_TRAINING, get_tasks_args)
    tokenizer = build_tokenizer(args) if args.tokenizer_type else None
    if args.padded_vocab_size is None and args.task not in _MODEL_FREE:
        raise SystemExit("need --vocab_size/--padded_vocab_size or a "
                         "tokenizer")
    return args, tokenizer


def main(argv: Optional[Sequence[str]] = None):
    args, tokenizer = parse(sys.argv[1:] if argv is None else argv)
    if args.task not in TASKS:
        raise NotImplementedError(f"task {args.task!r} is not implemented")
    module = importlib.import_module(f"{_PKG}.{TASKS[args.task]}")
    return module.main(args, tokenizer)


if __name__ == "__main__":
    main()
