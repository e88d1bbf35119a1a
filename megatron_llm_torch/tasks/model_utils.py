"""The models the tasks build from the flags: the GPT model of the
zero-shot and prompting tasks, with its params from ``--load`` or fresh
from ``--seed`` (the root tasks repeat these lines in each driver), and
the BERT config of the finetuning and retrieval tasks."""

from __future__ import annotations

from megatron_llm_torch import checkpointing
from megatron_llm_torch.config import transformer_config_from_args
from megatron_llm_torch.models.bert import BERT_ARCH_FLAGS
from megatron_llm_torch.models.gpt import GPTModel
from megatron_llm_torch.models.language_model import (
    init_language_model_params,
)


def bert_task_config(args):
    """The CLI's config with BERT's architecture forced (the root
    package's ``tasks/glue/finetune.py`` ``_cfg_from_args``)."""
    return transformer_config_from_args(args).replace(**BERT_ARCH_FLAGS)


def gpt_model_and_params(args, warning: str):
    """(GPTModel on ``--device``, params): ``--load``'s checkpoint without
    its optimizer state, held to the model's tree and dtypes, or a fresh
    init from ``--seed`` after printing ``warning``."""
    model = GPTModel(transformer_config_from_args(args), device=args.device)
    params = None
    if args.load:
        template = init_language_model_params(None, model.cfg,
                                              device="meta")
        params, _, _ = checkpointing.load_checkpoint(
            args.load, finetune=True, params_template=template,
            device=model.device)
    if params is None:
        print(f" > WARNING: {warning}", flush=True)
        params = model.init(args.seed)
    return model, params
