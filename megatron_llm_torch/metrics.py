"""Pluggable validation metrics (the counterpart of
``megatron_llm_tpu/metrics.py``).

Reference: ``megatron/metrics.py:11-110`` — a ``METRICS`` registry mapping
name -> callable(MetricInput) -> dict, selected with ``--metrics
[all|names]`` (arguments.py:550) and evaluated inside ``loss_func`` during
validation (finetune.py:211-217).  As in the JAX package, no loop calls
the registry yet.  ``accuracy`` takes an argmax over the vocabulary (the
JAX package's ``vocab_parallel_max_indices`` on one device).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch


@dataclass
class MetricInput:
    """reference: metrics.py MetricInput."""

    batch: dict                 # tokens/labels/loss_mask (+ masks)
    logits: torch.Tensor        # [b, s, V]
    avg_loss: torch.Tensor      # scalar masked-mean CE


def perplexity(inp: MetricInput) -> Dict[str, torch.Tensor]:
    return {"perplexity": torch.exp(torch.as_tensor(inp.avg_loss))}


def accuracy(inp: MetricInput) -> Dict[str, torch.Tensor]:
    """Top-1 next-token accuracy over unmasked positions
    (reference uses vocab_parallel_max_indices, metrics.py)."""
    pred = torch.argmax(inp.logits, dim=-1)
    labels = inp.batch["labels"]
    mask = inp.batch.get("loss_mask")
    correct = (pred == labels).float()
    if mask is not None:
        mask = (mask > 0).float()
        return {"accuracy": (correct * mask).sum()
                / mask.sum().clamp(min=1.0)}
    return {"accuracy": correct.mean()}


def count_loss_mask(inp: MetricInput) -> Dict[str, torch.Tensor]:
    mask = inp.batch.get("loss_mask")
    if mask is None:
        return {"count_loss_mask": torch.tensor(0.0)}
    return {"count_loss_mask": (mask > 0).sum(dim=-1).float().mean()}


METRICS: Dict[str, Callable[[MetricInput], Dict[str, torch.Tensor]]] = {
    "perplexity": perplexity,
    "accuracy": accuracy,
    "count_loss_mask": count_loss_mask,
}


def recovery_counters() -> Dict[str, int]:
    """Host-side fault-tolerance counters (rewinds, save_retries,
    watchdog_fires, signal_saves) — merged into the training log /
    TB/W&B stream and the bench.py artifacts.  Re-exported here so
    metrics consumers need not import resilience."""
    from megatron_llm_torch.resilience import recovery_counters as rc

    return rc()


def telemetry_summary() -> Optional[Dict[str, float]]:
    """The active run's aggregate telemetry (mean MFU, mean
    tokens/sec/device, mean step time) from the --structured_log_dir
    stream; None when no stream is installed.  Re-exported here (like
    ``recovery_counters``) so metrics consumers need not import
    telemetry."""
    from megatron_llm_torch.telemetry import run_summary

    return run_summary()


def get_metric(name: str):
    if name not in METRICS:
        raise KeyError(
            f"unknown metric {name!r}; available: {sorted(METRICS)}"
        )
    return METRICS[name]


def resolve_metric_names(names):
    if names and "all" in names:
        return sorted(METRICS)
    return list(names or [])
