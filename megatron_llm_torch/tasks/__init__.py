"""The downstream tasks of the PyTorch port (the counterpart of the repo's
root ``tasks/`` package): zero-shot WikiText-103 perplexity and LAMBADA
accuracy, multiple-choice ranking (PIQA, HellaSwag, ARC, BoolQ,
Winogrande), GLUE (MNLI, QQP) and RACE finetuning, ORQA retrieval recall
and MSDP prompting.  ``python -m megatron_llm_torch.tasks.main --task T``
runs one; each task's ``main(args, tokenizer)`` takes the parsed flags
and the tokenizer explicitly, and runs on the card unless ``--device
cpu``.  The pure-numpy modules (datasets, parsers, metrics) are copies
of the root package's with their imports changed."""
