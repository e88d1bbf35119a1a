#!/usr/bin/env python
"""Checkpoint dtype conversion and format bridge on one device (the twin
of the repo's ``tools/checkpoint_util.py``).

Reference: ``tools/checkpoint_util.py`` — spawns loader & saver processes
connected by a queue speaking a named-message protocol to re-split
``mp_rank_XX_YYY`` shard files for a new (tp, pp) (:6-88).

The port's checkpoint is one logical param tree (``meta.json`` and one
``torch.save`` payload, ``megatron_llm_torch/checkpointing.py``), so the
tool reduces to load -> (optional dtype cast / arg rewrite) -> save, as
the JAX tool does: changing dtype, recording target parallel sizes in
args, re-writing a release checkpoint, and converting from and to the
reference's ``mp_rank`` layout (``--input_format`` / ``--output_format
megatron``, through ``weights_conversion/megatron_ckpt.py``; the output's
TP shards from ``--target_tensor_parallel_size``).  The JAX tool's
``orbax`` format is the JAX package's own; the port's format takes its
place among the choices under the name ``torch``.  The params are carried;
the optimizer state is not (neither tool restores it without a model).

    python -m megatron_llm_torch.tools.checkpoint_util --load_dir in \\
        --save_dir out --dtype bf16 --release
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

FORMATS = {
    "torch": "the port's checkpoint (megatron_llm_torch/checkpointing.py)",
    "megatron": "the reference's mp_rank torch checkpoint "
                "(megatron_llm_torch/weights_conversion/megatron_ckpt.py)",
}
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16,
          "fp16": torch.float16}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--load_dir", required=True)
    p.add_argument("--save_dir", required=True)
    p.add_argument("--target_tensor_parallel_size", type=int, default=None)
    p.add_argument("--target_pipeline_parallel_size", type=int, default=None)
    p.add_argument("--target_data_parallel_size", type=int, default=None)
    p.add_argument("--dtype", choices=sorted(DTYPES), default=None)
    p.add_argument("--release", action="store_true",
                   help="write as a release checkpoint (iteration 0)")
    fmt = "; ".join(f"{k} = {v}" for k, v in FORMATS.items())
    p.add_argument("--input_format", choices=sorted(FORMATS),
                   default="torch", help=fmt)
    p.add_argument("--output_format", choices=sorted(FORMATS),
                   default="torch")
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    from megatron_llm_torch import checkpointing
    from megatron_llm_torch.tree import tree_map
    from megatron_llm_torch.weights_conversion.megatron_ckpt import (
        load_reference_checkpoint,
        save_reference_checkpoint,
    )

    args = build_parser().parse_args(argv)
    if args.input_format == "megatron":
        params, cfg_over, meta = load_reference_checkpoint(args.load_dir)
        meta = dict(meta)
        # megatron checkpoints record args as a namespace; normalize to a
        # plain dict and fold in the recovered config overrides
        rec = meta.get("args") or {}
        if not isinstance(rec, dict):
            rec = dict(vars(rec))
        rec.update(cfg_over)
        meta["args"] = rec
    else:
        params, _, meta = checkpointing.load_checkpoint(args.load_dir,
                                                        device="cpu")
        if params is None:
            params, _, meta = checkpointing.load_checkpoint(
                args.load_dir, release=True, device="cpu")
    if params is None:
        raise SystemExit(f"no checkpoint found under {args.load_dir}")

    if args.dtype:
        params = tree_map(lambda x: x.to(DTYPES[args.dtype]), params)

    ckpt_args = dict(meta.get("args") or {})
    for k, v in (
        ("tensor_model_parallel_size", args.target_tensor_parallel_size),
        ("pipeline_model_parallel_size", args.target_pipeline_parallel_size),
        ("data_parallel_size", args.target_data_parallel_size),
    ):
        if v is not None:
            ckpt_args[k] = v

    iteration = 0 if args.release else int(meta.get("iteration") or 0)
    if args.output_format == "megatron":
        save_reference_checkpoint(
            args.save_dir, iteration, params, ckpt_args,
            tensor_parallel=args.target_tensor_parallel_size or 1)
    else:
        checkpointing.save_checkpoint(
            args.save_dir, iteration, params, args=ckpt_args,
            consumed_samples=meta.get("consumed_samples", 0),
            release=args.release,
        )
    print(f" resharded {args.load_dir} ({args.input_format}) -> "
          f"{args.save_dir} ({args.output_format}); target sizes recorded "
          f"in args")


if __name__ == "__main__":
    main()
