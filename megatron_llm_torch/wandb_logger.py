"""Weights & Biases logging as a tensorboard-writer shim (the counterpart
of ``megatron_llm_tpu/wandb_logger.py``).

Reference: ``megatron/wandb_logger.py:13-162`` — ``WandbTBShim`` exposes
``add_scalar`` so the training loop writes one code path for TB and wandb;
config (project/entity/name/id, API-key file) comes from args
(arguments.py:535-549), flushed each step (training.py:724-727).

When ``wandb`` is not installed the shim degrades to a JSONL metrics file
so runs remain inspectable offline, and it uses the real wandb package
when importable.  There is no TensorBoard writer: ``--tensorboard_dir``
writes the same JSONL file (``metrics.jsonl``) in that directory.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class WandbTBShim:
    def __init__(self, config: dict, project: Optional[str] = None,
                 entity: Optional[str] = None, name: Optional[str] = None,
                 run_id: Optional[str] = None,
                 api_key: Optional[str] = None,
                 fallback_path: str = "wandb_offline.jsonl",
                 resume: str = "allow",
                 force_offline: bool = False):
        # force_offline: write the JSONL stream directly without trying
        # wandb (--tensorboard_dir without --wandb_logger must produce the
        # file the user asked for, not a surprise wandb run)
        self._wandb = None
        self._file = None
        if not force_offline:
            try:
                import wandb  # noqa: F401

                if api_key:
                    os.environ.setdefault("WANDB_API_KEY", api_key)
                self._wandb = wandb
                self._run = wandb.init(project=project, entity=entity,
                                       name=name, id=run_id, resume=resume,
                                       config=config)
            except Exception:
                if resume == "must":
                    # --wandb_resume explicitly demanded that run; silently
                    # degrading to the offline file would fake a resume
                    raise
                self._wandb = None
        if self._wandb is None:
            self._file = open(fallback_path, "a", buffering=1)
            self._file.write(json.dumps({"event": "init", "config": config,
                                         "time": time.time()}) + "\n")
        self._pending = {}

    def add_scalar(self, key: str, value, iteration: int):
        self._pending.setdefault(iteration, {})[key] = float(value)

    def flush(self):
        for it in sorted(self._pending):
            payload = self._pending[it]
            if self._wandb is not None:
                self._wandb.log(payload, step=it)
            else:
                self._file.write(json.dumps({"step": it, **payload}) + "\n")
        self._pending.clear()

    def finish(self):
        # run-level recovery summary (rewinds / save_retries /
        # watchdog_fires / signal_saves) so a run's fault history is
        # visible without scanning the per-step stream
        try:
            from megatron_llm_torch.resilience import recovery_counters

            summary = recovery_counters()
        except Exception:
            summary = None
        # run-level telemetry aggregates (mean MFU, tokens/sec/device,
        # step time) when a --structured_log_dir stream is active
        try:
            from megatron_llm_torch.telemetry import run_summary

            t_summary = run_summary()
        except Exception:
            t_summary = None
        self.flush()
        if self._wandb is not None:
            if summary:
                for k, v in summary.items():
                    self._run.summary[f"recovery/{k}"] = v
            if t_summary:
                for k, v in t_summary.items():
                    if v is not None:
                        self._run.summary[f"telemetry/{k}"] = v
            self._run.finish()
        elif self._file is not None:
            if summary is not None:
                self._file.write(json.dumps(
                    {"event": "recovery_summary", **summary}) + "\n")
            if t_summary is not None:
                self._file.write(json.dumps(
                    {"event": "telemetry_summary", **t_summary}) + "\n")
            self._file.close()
