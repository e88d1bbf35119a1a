"""Start-up of a run (the counterpart of ``megatron_llm_tpu/initialize.py``):
parse and validate the flags, boot the process group, lay the ranks
out, and pad the vocabulary to ``make_vocab_size_divisible_by x tp``.

``initialize_parallel`` is the part the port's entry points call after
their own parsing: ``topology.initialize_distributed`` from torchrun's
environment (``--distributed_backend``, ``xla`` meaning the device's own
backend), then ``topology.initialize_model_parallel`` with the parsed
sizes.  It moves ``args.device`` to the rank's device (``cuda:<local
rank>``) and sets ``args.rank``.  ``initialize_megatron`` is the JAX
package's whole sequence for callers that build their own parser.
The fused cross entropy stays off at tp > 1, as the JAX package's
``apply_fused_ce_policy`` keeps it (``arguments.py``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch.distributed as dist

from megatron_llm_torch import arguments, topology


def initialize_parallel(args, init_method: Optional[str] = None):
    """Boot the process group (unless one is up) and lay the ranks out
    from the parsed sizes; returns ``args`` with ``device`` and ``rank``
    set.  ``init_method`` overrides torchrun's ``env://`` (the tests'
    file stores)."""
    args.device = topology.initialize_distributed(
        args.distributed_backend, args.device, init_method=init_method)
    args.rank = dist.get_rank() if dist.is_initialized() else 0
    topology.initialize_model_parallel(
        tensor_model_parallel_size=args.tensor_model_parallel_size,
        pipeline_model_parallel_size=args.pipeline_model_parallel_size,
        virtual_pipeline_model_parallel_size=(
            args.virtual_pipeline_model_parallel_size),
        context_parallel_size=args.context_parallel_size,
        num_slices=args.num_slices)
    return args


def initialize_megatron(extra_args_provider: Optional[Callable] = None,
                        args_list: Optional[Sequence[str]] = None,
                        init_method: Optional[str] = None):
    """Parse and validate the flags (dp derived from the world), boot the
    process group and the layout, then build the tokenizer, whose
    vocabulary sets the padded vocab (``--vocab_size`` pads the same way
    without one); returns ``(args, tokenizer)``."""
    args = arguments.parse_args(args_list, extra_args_provider)
    initialize_parallel(args, init_method)
    tokenizer = None
    if args.tokenizer_type is not None:
        from megatron_llm_torch.tokenizer import build_tokenizer

        tokenizer = build_tokenizer(args)   # sets args.padded_vocab_size
        arguments.apply_fused_ce_policy(args)
    return args, tokenizer
