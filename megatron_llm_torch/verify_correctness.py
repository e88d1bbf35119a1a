#!/usr/bin/env python
"""Forward-pass correctness harness: the port vs HuggingFace (the twin of
the repo's ``verify_correctness.py``).

Reference: ``verify_correctness.py`` — runs the Megatron forward and the
HF forward on the same batches and reports the max-abs logits error and
the loss delta (:130-189); the golden-model test holds the mean max-abs
error to 1e-3 (tests/test_llama_weights.py:117-118).

The port's forward is the one it serves and trains with: on the card its
norms and attention take the CUDA kernels (B or D, and F); the HF model
runs on the same device.  In fp32 the products run in full fp32 (TF32
off), or the check would measure TF32 rather than the weights.  It takes
the argv of ``examples/verify.sh``, prints one line a batch and a last
``verify_correctness: {...}`` JSON line, and exits 1 when the mean of the
batches' max-abs logits errors is above ``--atol``, as the JAX tool does.

Usage:
    python -m megatron_llm_torch.verify_correctness --model_name=llama2 \\
        --load=/ckpts/llama2-7b --huggingface_path=/hf/llama2-7b \\
        --iters=10 --batch=2 --seq_length=512
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model_name", default="llama2")
    p.add_argument("--load", required=True,
                   help="port checkpoint dir (release or iter)")
    p.add_argument("--huggingface_path", required=True)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--seq_length", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--atol", type=float, default=1e-3)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device of both forwards ('cpu' for tests)")
    return p


def load_model(load: str, model_name: str, device):
    """(model, params) of a port checkpoint, the config from its args."""
    from megatron_llm_torch import checkpointing
    from megatron_llm_torch.config import transformer_config_from_dict
    from megatron_llm_torch.models import MODEL_REGISTRY
    from megatron_llm_torch.models.language_model import (
        init_language_model_params,
    )

    cfg = transformer_config_from_dict(
        checkpointing.load_checkpoint_args(load))
    model = MODEL_REGISTRY[model_name](cfg, device=device)
    params, _, _ = checkpointing.load_checkpoint(
        load, finetune=True, device=device,
        params_template=init_language_model_params(None, model.cfg,
                                                   device="meta"))
    if params is None:
        raise SystemExit(f"--load {load}: no valid checkpoint there")
    return model, params


def run(argv: Optional[Sequence[str]] = None) -> dict:
    """Compare the two forwards; returns the errors, deltas and verdict."""
    from transformers import AutoModelForCausalLM

    from megatron_llm_torch.ops.cross_entropy import (
        vocab_parallel_cross_entropy,
    )

    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    model, params = load_model(args.load, args.model_name, device)
    hf = AutoModelForCausalLM.from_pretrained(
        args.huggingface_path, dtype=torch.float32).to(device).eval()

    rng = np.random.RandomState(args.seed)
    max_errs, loss_deltas = [], []
    for it in range(args.iters):
        toks = rng.randint(0, model.cfg.padded_vocab_size,
                           (args.batch, args.seq_length))
        labels = torch.from_numpy(np.roll(toks, -1, axis=1)).to(device)
        tokens = torch.from_numpy(toks).to(device)
        with torch.no_grad():
            hf_logits = hf(tokens).logits.float()
            my_logits = model(params, tokens).float()
        err = float((hf_logits - my_logits).abs().max())
        hf_loss = float(vocab_parallel_cross_entropy(hf_logits,
                                                     labels).mean())
        my_loss = float(vocab_parallel_cross_entropy(my_logits,
                                                     labels).mean())
        del hf_logits, my_logits
        max_errs.append(err)
        loss_deltas.append(abs(hf_loss - my_loss))
        print(f" iter {it}: max abs logits err {err:.3e} | "
              f"our loss {my_loss:.6f} | hf loss {hf_loss:.6f}", flush=True)

    mean_err = float(np.mean(max_errs))
    print(f" mean max-abs logits error over {args.iters} iters: "
          f"{mean_err:.3e} (tolerance {args.atol})", flush=True)
    result = {"max_abs_err": max(max_errs), "mean_max_abs_err": mean_err,
              "max_loss_delta": max(loss_deltas), "atol": args.atol,
              "iters": args.iters, "batch": args.batch,
              "seq_length": args.seq_length, "device": str(device),
              "ok": mean_err <= args.atol}
    print(" OK" if result["ok"] else " FAIL", flush=True)
    print("verify_correctness: " + json.dumps(result), flush=True)
    return result


def main(argv: Optional[Sequence[str]] = None) -> None:
    if not run(argv)["ok"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
