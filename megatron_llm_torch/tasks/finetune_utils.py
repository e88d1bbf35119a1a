"""Generic downstream-task finetuning loop (the counterpart of the root
``tasks/finetune_utils.py``).

Reference: ``tasks/finetune_utils.py`` — epoch-based training over an
in-memory dataset with per-epoch shuffling, periodic checkpointing, and an
accuracy evaluation at each epoch end.

One train step (the port's ``build_train_step`` with one micro-batch —
the classification models satisfy the generic model contract), numpy
batching on the host, tensors moved to the model's device.  Pretrained
BERT weights are grafted onto the classification trunk by matching the
``embedding``/``transformer``/``pooler`` subtrees; the task head keeps
its fresh init.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from megatron_llm_torch import checkpointing
from megatron_llm_torch import random as mrandom
from megatron_llm_torch.config import (
    parallel_config_from_args,
    train_config_from_args,
)
from megatron_llm_torch.optimizer import MegatronOptimizer
from megatron_llm_torch.optimizer.scheduler import OptimizerParamScheduler
from megatron_llm_torch.training import build_train_step
from megatron_llm_torch.tree import (
    tree_leaves,
    tree_leaves_with_path,
    tree_map,
)


def classification_collate(samples):
    """List of task samples -> one micro-batch dict (the M=1 microbatch
    axis is added by the caller)."""
    return {
        "tokens": np.stack([s["text"] for s in samples]).astype(np.int32),
        "tokentype_ids": np.stack([s["types"] for s in samples]
                                  ).astype(np.int32),
        "attention_mask": np.stack([s["padding_mask"] for s in samples]
                                   ).astype(np.int32),
        "labels": np.asarray([s["label"] for s in samples], np.int32),
        "loss_mask": np.ones(len(samples), np.float32),
    }


def _epoch_batches(dataset, batch_size, rng, keep_last=False,
                   collate=classification_collate):
    order = rng.permutation(len(dataset))
    stop = len(order) if keep_last else (len(order) // batch_size) * batch_size
    for lo in range(0, stop, batch_size):
        idx = order[lo:lo + batch_size]
        if not keep_last and len(idx) < batch_size:
            return
        yield collate([dataset[int(i)] for i in idx])


def _to_device(batch, device, micro_axis=False):
    """Host arrays -> int64 token tensors (float masks stay float) on
    ``device``, with a leading micro-batch axis of 1 if asked."""
    out = {}
    for k, v in batch.items():
        v = v[None] if micro_axis else v
        t = torch.from_numpy(np.ascontiguousarray(v))
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
    return out


def _structure(tree):
    """A subtree's key paths and shapes."""
    return [(p, tuple(t.shape)) for p, t in tree_leaves_with_path(tree)]


def load_pretrained_trunk(params, pretrained_checkpoint: str,
                          device="cuda"):
    """Graft matching subtrees (embedding/transformer/pooler) from a
    pretrained LM checkpoint onto freshly initialized task params, each
    cast to the task's dtype.  A subtree whose key paths or shapes
    differ is skipped with a line saying so."""
    loaded, _, _ = checkpointing.load_checkpoint(
        pretrained_checkpoint, finetune=True, device=device)
    if loaded is None:
        raise FileNotFoundError(
            f"no checkpoint found at {pretrained_checkpoint!r}")
    grafted = dict(params)
    for key in ("embedding", "transformer", "pooler"):
        if key in loaded and key in params:
            if _structure(params[key]) == _structure(loaded[key]):
                grafted[key] = tree_map(lambda t, s: s.to(t.dtype),
                                        params[key], loaded[key])
                print(f" > loaded pretrained {key!r}", flush=True)
            else:
                print(f" > skipped {key!r}: structure mismatch", flush=True)
    return grafted


def named_valid_splits(paths, make_dataset):
    """[(split_name, dataset)] from dev-file paths, one dataset per path
    (per-split reporting, reference eval_utils.accuracy_func_provider).
    Names come from the basename (extension stripped); collisions get a
    numeric suffix so two ``matched/dev.tsv mismatched/dev.tsv`` splits
    can't silently overwrite each other in the predictions dump."""
    splits = []
    seen = {}
    for p in paths:
        name = os.path.splitext(os.path.basename(os.path.normpath(p)))[0] \
            or "dev"
        if name in seen:
            seen[name] += 1
            name = f"{name}{seen[name]}"
        else:
            seen[name] = 0
        splits.append((name, make_dataset(name, p)))
    return splits


def accuracy_func_provider(model, params_getter, dataset, batch_size,
                           collate=classification_collate,
                           output_predictions: bool = False,
                           predictions_dir: Optional[str] = None):
    """Returns a callable computing top-1 accuracy
    (reference: tasks/eval_utils.py accuracy_func_provider).

    ``dataset``: either one dataset, or a list of ``(split_name, dataset)``
    pairs — per-split correct/total is printed like the reference's
    ``calculate_correct_answers`` and the overall accuracy returned.
    With ``output_predictions`` the per-sample softmaxes/labels/uids of
    every split are written to ``predictions_dir/predictions_epochN.json``
    (the reference torch-saves the same triple per split,
    eval_utils.py:56-59)."""
    if (isinstance(dataset, (list, tuple)) and dataset
            and isinstance(dataset[0], tuple)
            and isinstance(dataset[0][0], str)):
        splits = list(dataset)
    else:
        splits = [("validation", dataset)]

    @torch.inference_mode()
    def logits_fn(params, tokens, attention_mask, tokentype_ids):
        return model(params, tokens, attention_mask,
                     tokentype_ids=tokentype_ids)

    def eval_split(params, ds):
        correct = total = 0
        softmaxes, labels, ids = [], [], []
        for lo in range(0, len(ds), batch_size):
            samples = [ds[i]
                       for i in range(lo, min(lo + batch_size, len(ds)))]
            b = collate(samples)
            n = len(samples)
            # pad the tail batch to the batch size
            if n < batch_size:
                pad = batch_size - n
                b = {k: np.concatenate(
                    [v, np.repeat(v[-1:], pad, axis=0)]) for k, v in b.items()}
            t = _to_device(b, model.device)
            logits = logits_fn(params, t["tokens"], t["attention_mask"],
                               t["tokentype_ids"])
            logits = logits.float().cpu().numpy()[:n]
            pred = logits.argmax(-1)
            correct += int((pred == b["labels"][:n]).sum())
            total += n
            if output_predictions:
                e = np.exp(logits - logits.max(-1, keepdims=True))
                softmaxes.extend((e / e.sum(-1, keepdims=True)).tolist())
                labels.extend(b["labels"][:n].tolist())
                ids.extend(int(s.get("uid", lo + j))
                           for j, s in enumerate(samples))
        return correct, total, (softmaxes, labels, ids)

    def evaluate(epoch: int = -1):
        params = params_getter()
        correct = total = 0
        named_predictions = {}
        for name, ds in splits:
            c, t, preds = eval_split(params, ds)
            correct += c
            total += t
            pct = 100.0 * c / max(t, 1)
            print(f" > |epoch: {epoch}| metrics for {name}: "
                  f"correct / total = {c} / {t} = {pct:.4f} %", flush=True)
            if output_predictions:
                named_predictions[name] = {
                    "softmaxes": preds[0], "labels": preds[1],
                    "ids": preds[2],
                }
        pct = 100.0 * correct / max(total, 1)
        print(f" >> |epoch: {epoch}| overall: correct / total = "
              f"{correct} / {total} = {pct:.4f} %", flush=True)
        if output_predictions and predictions_dir:
            os.makedirs(predictions_dir, exist_ok=True)
            path = os.path.join(predictions_dir,
                                f"predictions_epoch{epoch}.json")
            with open(path, "w") as f:
                json.dump(named_predictions, f)
            print(f" > wrote predictions to {path}", flush=True)
        return correct / max(total, 1)

    return evaluate


def finetune(args, model, train_dataset, valid_dataset,
             collate=classification_collate,
             end_of_epoch_callback: Optional[Callable] = None):
    """Epoch-driven finetune (reference: tasks/finetune_utils.py:finetune).

    Uses the generic train step with one microbatch per step; the global
    batch is ``args.micro_batch_size x dp`` (dp is 1 in the port).
    ``valid_dataset`` may be a list of ``(split_name, dataset)`` pairs for
    per-split reporting.

    Reference-parity plumbing (tasks/finetune_utils.py:_train + main):
    warmup+decay LR schedule over the full epoch span, per-epoch
    checkpoint, best-accuracy checkpoint under ``<save>/best``, and
    prediction dumps at each eval when ``args.save`` is set.
    ``--no_save_optim`` leaves the optimizer state out of those
    checkpoints.  Returns (params, best accuracy or None).
    """
    tc = train_config_from_args(args)
    pc = parallel_config_from_args(args)
    dev = model.device

    params = model.init(args.seed)
    if getattr(args, "pretrained_checkpoint", None):
        params = load_pretrained_trunk(params, args.pretrained_checkpoint,
                                       device=dev)
    if args.fp16 or args.bf16:
        dt = torch.float16 if args.fp16 else torch.bfloat16
        params = tree_map(lambda p: p.to(dt), params)
    # build the optimizer from the *post-cast* leaf dtype so half-precision
    # params get fp32 master weights and fp32 Adam state instead of
    # silently updating in fp16/bf16
    optimizer = MegatronOptimizer(
        tc, params_dtype=tree_leaves(params)[0].dtype)
    opt_state = optimizer.init(params)

    step_fn = build_train_step(model, optimizer, pc, num_microbatches=1)
    batch_size = args.micro_batch_size * args.data_parallel_size
    rng = np.random.RandomState(args.seed)
    key = mrandom.base_key(args.seed + 1)

    epochs = args.epochs or 0
    # LR schedule over the whole finetune span (reference: _train drives
    # the standard OptimizerParamScheduler; warmup fraction from
    # --lr_warmup_fraction, linear decay to min_lr by the last iteration)
    steps_per_epoch = (len(train_dataset) // batch_size
                       if getattr(args, "keep_last", False) is False
                       else -(-len(train_dataset) // batch_size))
    total_iters = max(epochs * max(steps_per_epoch, 1), 1)
    warmup = getattr(args, "lr_warmup_fraction", None)
    scheduler = OptimizerParamScheduler(
        max_lr=args.lr, min_lr=getattr(args, "min_lr", 0.0) or 0.0,
        lr_warmup_steps=int((warmup or 0.0) * total_iters),
        lr_decay_steps=total_iters,
        lr_decay_style=getattr(args, "lr_decay_style", "linear") or "linear",
        start_wd=tc.weight_decay, end_wd=tc.weight_decay,
    )
    it = 0
    best = None
    state = {"params": params}
    eval_fn = None
    if valid_dataset is not None:
        eval_fn = accuracy_func_provider(
            model, lambda: state["params"], valid_dataset,
            batch_size, collate,
            output_predictions=bool(args.save),
            predictions_dir=args.save)

    def save(save_dir):
        checkpointing.save_checkpoint(
            save_dir, it, params,
            None if args.no_save_optim else opt_state)

    for epoch in range(epochs):
        for batch in _epoch_batches(train_dataset, batch_size, rng,
                                    keep_last=getattr(args, "keep_last",
                                                      False), collate=collate):
            global_batch = _to_device(batch, dev, micro_axis=True)  # M=1
            key, sub = mrandom.split(key)
            lr, wd = scheduler.step()
            params, opt_state, metrics = step_fn(
                params, opt_state, global_batch, sub, lr, wd)
            state["params"] = params
            it += 1
            if it % args.log_interval == 0:
                print(f"epoch {epoch} iter {it} | lr {lr:.3e} | "
                      f"loss {float(metrics['lm loss']):.4f}", flush=True)
        if eval_fn is not None:
            acc = eval_fn(epoch)
            print(f"epoch {epoch} | validation accuracy {acc * 100:.2f}%",
                  flush=True)
            if best is None or acc > best:
                best = acc
                if args.save:
                    # checkpoint-best: the reference keeps the per-epoch
                    # checkpoints and users pick by logged dev accuracy;
                    # a dedicated best/ copy makes the pick explicit
                    save(os.path.join(args.save, "best"))
                    print(f"epoch {epoch} | new best ({acc * 100:.2f}%): "
                          f"saved {args.save}/best", flush=True)
        if end_of_epoch_callback is not None:
            end_of_epoch_callback(epoch, params)
        if args.save:
            save(args.save)

    if epochs == 0 and eval_fn is not None:  # evaluation only
        acc = eval_fn(-1)
        print(f"validation accuracy {acc * 100:.2f}%", flush=True)
        best = acc
    return params, best
