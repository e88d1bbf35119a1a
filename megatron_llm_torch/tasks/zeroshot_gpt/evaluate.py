"""GPT zero-shot evaluation: WIKITEXT103 perplexity, LAMBADA accuracy
(the counterpart of the root ``tasks/zeroshot_gpt/evaluate.py``).

Reference: ``tasks/zeroshot_gpt/evaluate.py`` — loss is summed over pad-
masked tokens and turned into (adjusted) perplexity; accuracy requires
every label token of the cloze word to be the argmax prediction.

One forward per fixed [b, s+1] batch on the model's device under
``torch.inference_mode``; tail batches are padded with copies of their
last row under a zero mask on the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from megatron_llm_torch.tasks.model_utils import gpt_model_and_params
from megatron_llm_torch.tasks.zeroshot_gpt.datasets import build_dataset


def _build_eval_fns(model):
    """(loss_sum, num_correct): each ``(params, tokens [b, s+1], pad_mask
    [b, s]) -> 0-d tensor`` on the model's device."""

    @torch.inference_mode()
    def loss_sum(params, tokens, pad_mask):
        inp, labels = tokens[:, :-1], tokens[:, 1:]
        loss_tok = model(params, inp, labels=labels)  # [b, s]
        if model.cfg.num_experts > 1:
            loss_tok, _ = loss_tok      # MoE: drop the routing aux at eval
        return torch.sum(loss_tok * pad_mask.to(loss_tok.dtype))

    @torch.inference_mode()
    def num_correct(params, tokens, pad_mask):
        inp, labels = tokens[:, :-1], tokens[:, 1:]
        logits = model(params, inp)
        pred = torch.argmax(logits, dim=-1)
        # masked positions count as correct; a row with no scored
        # position counts as nothing
        ok = torch.where(pad_mask > 0, pred == labels,
                         torch.ones_like(labels, dtype=torch.bool))
        return torch.sum(torch.prod(ok.to(torch.int32), dim=-1)
                         * (pad_mask.sum(-1) > 0).to(torch.int32))

    return loss_sum, num_correct


def evaluate(dataset, model, params, eval_metric, micro_batch_size,
             log_interval=20):
    loss_sum, num_correct = _build_eval_fns(model)
    total = 0.0
    n = len(dataset)
    bs = micro_batch_size
    dev = model.device
    for lo in range(0, n, bs):
        idx = range(lo, min(lo + bs, n))
        batch = [dataset[i] for i in idx]
        k = len(batch)
        toks = np.stack([b["text"] for b in batch])
        mask = np.stack([b["pad_mask"] for b in batch])
        if k < bs:  # pad to the batch size; padded rows carry zero mask
            toks = np.concatenate([toks, np.repeat(toks[-1:], bs - k, 0)])
            mask = np.concatenate(
                [mask, np.zeros((bs - k,) + mask.shape[1:], mask.dtype)])
        toks_t = torch.from_numpy(toks.astype(np.int64)).to(dev)
        mask_t = torch.from_numpy(mask.astype(np.int32)).to(dev)
        if eval_metric == "loss":
            total += float(loss_sum(params, toks_t, mask_t))
        else:
            total += float(num_correct(params, toks_t, mask_t))
        if (lo // bs) % log_interval == 0:
            print(f" > batch {lo // bs}/{(n + bs - 1) // bs}", flush=True)
    return total


def print_results(task, dataset, eval_metric, output):
    line = f" validation results on {task} | "
    if eval_metric == "loss":
        num_tok = dataset.num_tokenized_tokens
        num_orig = dataset.num_original_tokens
        val_loss = output / (num_tok - 1)
        ppl = math.exp(min(20, val_loss))
        ratio = (num_tok - 1) / (num_orig - 1)
        adjusted = math.exp(min(20, val_loss * ratio))
        line += (f"avg loss: {val_loss:.4E} | ppl: {ppl:.4E} | "
                 f"adjusted ppl: {adjusted:.4E} | token ratio: {ratio} |")
    else:
        acc = output / len(dataset)
        line += (f"number correct: {output:.4E} | total examples: "
                 f"{len(dataset):.4E} | avg accuracy: {acc:.4E}")
    print("-" * (len(line) + 1))
    print(line)
    print("-" * (len(line) + 1), flush=True)


def main(args, tokenizer):
    eval_metric = {"LAMBADA": "accuracy", "WIKITEXT103": "loss"}[args.task]
    model, params = gpt_model_and_params(
        args, "no checkpoint loaded; evaluating random init")
    dataset = build_dataset(args.task, args, tokenizer)
    output = evaluate(dataset, model, params, eval_metric,
                      args.micro_batch_size, args.log_interval)
    print_results(args.task, dataset, eval_metric, output)
    return output
