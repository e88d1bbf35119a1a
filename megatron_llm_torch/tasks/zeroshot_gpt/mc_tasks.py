"""Multiple-choice zero-shot tasks: PIQA, HellaSwag, ARC, BoolQ,
Winogrande (beyond-reference — the reference's zero-shot harness covers
LAMBADA and WIKITEXT103 only).

Standard log-likelihood ranking (the lm-eval-harness protocol): each
sample is a context plus N candidate continuations; the score of a
candidate is the sum of its tokens' log-probs conditioned on
context+prefix (optionally length-normalized), and the prediction is
the argmax.  Data: the tasks' public jsonl files, read locally.

The counterpart of the root ``tasks/zeroshot_gpt/mc_tasks.py``: the
parsers, the tokenisation at the boundary and the left truncation are
its; the row scores run under ``torch.inference_mode`` on the model's
device.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List

import numpy as np
import torch


# ---------------------------------------------------------------------------
# per-task jsonl parsers -> {context, choices: [str], gold: int}
# ---------------------------------------------------------------------------

def _parse_piqa(rec):
    return {"context": f"Question: {rec['goal']}\nAnswer:",
            "choices": [" " + rec["sol1"], " " + rec["sol2"]],
            "gold": int(rec["label"])}


def _parse_hellaswag(rec):
    ctx = rec.get("ctx") or (rec.get("ctx_a", "") + " " + rec.get("ctx_b", ""))
    return {"context": ctx.strip(),
            "choices": [" " + e for e in rec["endings"]],
            "gold": int(rec["label"])}


def _parse_arc(rec):
    ch = rec["choices"]
    labels = list(ch["label"])
    return {"context": f"Question: {rec['question']}\nAnswer:",
            "choices": [" " + t for t in ch["text"]],
            "gold": labels.index(rec["answerKey"])}


def _parse_boolq(rec):
    ans = rec["answer"]
    if isinstance(ans, str):
        ans = ans.strip().lower() == "true"
    return {"context": f"{rec['passage']}\nQuestion: {rec['question']}?\n"
                       f"Answer:",
            "choices": [" no", " yes"],
            "gold": int(bool(ans))}


def _parse_winogrande(rec):
    """lm-eval 'partial evaluation': context = sentence up to the blank
    with each option substituted; only the COMMON suffix after the blank
    is scored, so option-token likelihoods never enter the comparison."""
    sent = rec["sentence"]
    cut = sent.index("_")
    suffix = sent[cut + 1:]
    opts = [rec["option1"], rec["option2"]]
    if not suffix.strip():
        # blank at the very end: nothing shared to score; fall back to
        # ranking the substituted sentences themselves
        return {"context": sent[:cut].rstrip(),
                "choices": [" " + o for o in opts],
                "gold": int(rec["answer"]) - 1}
    return {"contexts": [sent[:cut] + o for o in opts],
            "choices": [suffix, suffix],
            "gold": int(rec["answer"]) - 1}


PARSERS: Dict[str, Callable] = {
    "PIQA": _parse_piqa,
    "HELLASWAG": _parse_hellaswag,
    "ARC-EASY": _parse_arc,
    "ARC-CHALLENGE": _parse_arc,
    "BOOLQ": _parse_boolq,
    "WINOGRANDE": _parse_winogrande,
}
# length-normalized accuracy (acc_norm) is standard for these two
LENGTH_NORMALIZED = {"HELLASWAG", "ARC-EASY", "ARC-CHALLENGE"}


def load_mc_samples(task: str, path: str) -> List[dict]:
    parse = PARSERS[task]
    samples = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                samples.append(parse(json.loads(line)))
    return samples


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------

def _row_scores_fn(model, length_normalize: bool):
    """``(params, tokens [b, s+1], cont_mask [b, s+1]) -> [b]`` fp32: the
    summed (or length-averaged) continuation log-prob."""

    @torch.inference_mode()
    def row_scores(params, tokens, cont_mask):
        inp, labels = tokens[:, :-1], tokens[:, 1:]
        # labels=None => the model returns plain logits (a mixture of
        # experts drops its routing aux on this path)
        logits = model(params, inp)
        lp = torch.log_softmax(logits.float(), dim=-1)
        picked = torch.gather(lp, -1, labels[..., None])[..., 0]
        m = cont_mask[:, 1:].float()
        s = torch.sum(picked * m, dim=-1)
        if length_normalize:
            s = s / torch.clamp(torch.sum(m, dim=-1), min=1.0)
        return s

    return row_scores


def score_choices(model, params, tokenizer, samples, seq_len: int,
                  batch_size: int = 8, length_normalize: bool = False,
                  pad_id: int = 0):
    """Accuracy of argmax_choice sum-logprob(continuation | context).

    Every (sample, choice) pair becomes one row [seq_len + 1]; rows are
    batched through one scorer that returns the summed (or
    length-averaged) continuation log-prob with pad/context positions
    masked out.

    Tokenization boundary convention: context and continuation are
    tokenized independently and concatenated -- the lm-eval-harness
    convention, so accuracies are comparable with published numbers even
    though tokenize(ctx)+tokenize(cont) can differ from tokenize(ctx+cont)
    at BPE merge boundaries.  Rows longer than seq_len+1 are
    left-truncated; how many lost context (and whether any continuation
    was clipped) is counted and reported instead of truncating silently.
    Returns (accuracy, scores [samples, max choices] with -inf past a
    sample's choices)."""
    row_scores = _row_scores_fn(model, length_normalize)
    dev = model.device

    rows, meta = [], []
    ctx_truncated = ctx_gone = cont_clipped = 0
    for si, s in enumerate(samples):
        for ci, choice in enumerate(s["choices"]):
            ctx = (s["contexts"][ci] if "contexts" in s
                   else s["context"])
            ctx_ids = tokenizer.tokenize(ctx)
            cont_ids = tokenizer.tokenize(choice)
            if not cont_ids:
                cont_ids = [pad_id]
            total = len(ctx_ids) + len(cont_ids)
            if total > seq_len + 1:
                ctx_truncated += 1
                if len(cont_ids) >= seq_len + 1:
                    ctx_gone += 1
                    if len(cont_ids) > seq_len + 1:
                        cont_clipped += 1
            ids = (ctx_ids + cont_ids)[-(seq_len + 1):]
            n_cont = min(len(cont_ids), len(ids))
            row = np.full(seq_len + 1, pad_id, np.int64)
            row[:len(ids)] = ids
            cmask = np.zeros(seq_len + 1, np.int32)
            cmask[len(ids) - n_cont:len(ids)] = 1
            rows.append((row, cmask))
            meta.append((si, ci))

    if ctx_truncated:
        print(f" > WARNING: {ctx_truncated}/{len(rows)} rows were "
              f"left-truncated to seq_len+1={seq_len + 1} "
              f"({ctx_gone} lost their entire context, "
              f"{cont_clipped} had the continuation itself clipped); "
              f"accuracies may drift from full-context reference numbers",
              flush=True)

    scores = np.full((len(samples), max(len(s["choices"])
                                        for s in samples)), -np.inf)
    for lo in range(0, len(rows), batch_size):
        chunk = rows[lo:lo + batch_size]
        k = len(chunk)
        if k < batch_size:  # pad to the batch size with the last row
            chunk = chunk + [chunk[-1]] * (batch_size - k)
        toks = torch.from_numpy(np.stack([c[0] for c in chunk])).to(dev)
        cmask = torch.from_numpy(np.stack([c[1] for c in chunk])).to(dev)
        out = row_scores(params, toks, cmask).cpu().numpy()[:k]
        for j, sc in enumerate(out):
            si, ci = meta[lo + j]
            scores[si, ci] = sc

    correct = sum(
        int(np.argmax(scores[i, :len(s["choices"])]) == s["gold"])
        for i, s in enumerate(samples))
    return correct / max(len(samples), 1), scores


def main(args, tokenizer):
    """tasks.main entry: --task PIQA|HELLASWAG|ARC-*|BOOLQ|WINOGRANDE
    --valid_data file.jsonl."""
    from megatron_llm_torch.tasks.model_utils import gpt_model_and_params

    model, params = gpt_model_and_params(
        args, "evaluating a randomly initialized model")
    task = args.task
    path = args.valid_data[0] if isinstance(args.valid_data, list) \
        else args.valid_data
    samples = load_mc_samples(task, path)
    acc, _ = score_choices(
        model, params, tokenizer, samples, model.cfg.seq_length,
        batch_size=args.micro_batch_size,
        length_normalize=task in LENGTH_NORMALIZED,
        pad_id=getattr(tokenizer, "pad", 0) or 0)
    kind = "acc_norm" if task in LENGTH_NORMALIZED else "acc"
    print(f" > {task}: {kind} = {acc * 100:.2f}% over {len(samples)} "
          f"samples", flush=True)
    return acc
