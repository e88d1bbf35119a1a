"""Deterministic, resumable batch samplers + loader (a copy of
``megatron_llm_tpu/data/data_samplers.py``).

Reference: ``megatron/data/data_samplers.py`` —
``MegatronPretrainingSampler`` (:49-96) resumes exactly from
``consumed_samples`` and slices each batch by DP rank; the random variant
(:120+) shuffles per epoch with a seed derived from the epoch.

The loader yields **global** host batches (numpy) shaped
``[num_micro, micro_batch * dp, seq]``.  The JAX package places them on
its mesh (``place_host_batch``, ``_verify_cross_host_batch``), whose
logical ``batch`` axis maps to ``dp``; the port's dp rank r keeps rows
``r * mb ... (r + 1) * mb - 1`` of each micro batch (``dp_rows``, the
slice the JAX placement gives that rank), and
``finetune.build_data_iterator`` moves them to the rank's device with
``torch.from_numpy(...).to(device)``.  ``consumed_samples`` counts the
global batch.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class MegatronPretrainingSampler:
    """Sequential sampler with exact ``consumed_samples`` resume."""

    def __init__(
        self,
        total_samples: int,
        consumed_samples: int,
        micro_batch_size: int,
        data_parallel_size: int,
        drop_last: bool = True,
    ):
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self.micro_batch_size = micro_batch_size
        self.data_parallel_size = data_parallel_size
        self.micro_batch_times_dp = micro_batch_size * data_parallel_size
        self.drop_last = drop_last
        assert self.total_samples > 0
        assert self.consumed_samples < self.total_samples

    def __len__(self):
        return self.total_samples

    def __iter__(self) -> Iterator[np.ndarray]:
        batch = []
        for idx in range(self.consumed_samples, self.total_samples):
            batch.append(idx)
            if len(batch) == self.micro_batch_times_dp:
                yield np.asarray(batch)
                batch = []
        if batch and not self.drop_last:
            yield np.asarray(batch)


class MegatronPretrainingRandomSampler:
    """Per-epoch shuffle with deterministic resume
    (reference: data_samplers.py:120+)."""

    def __init__(
        self,
        total_samples: int,
        consumed_samples: int,
        micro_batch_size: int,
        data_parallel_size: int,
        seed: int = 1234,
    ):
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self.micro_batch_size = micro_batch_size
        self.data_parallel_size = data_parallel_size
        self.micro_batch_times_dp = micro_batch_size * data_parallel_size
        self.seed = seed
        self.last_batch_size = self.total_samples % self.micro_batch_times_dp

    def __len__(self):
        return self.total_samples

    def __iter__(self):
        active = self.total_samples - self.last_batch_size
        while True:
            epoch = self.consumed_samples // active
            offset = self.consumed_samples % active
            rng = np.random.RandomState(self.seed + epoch)
            perm = rng.permutation(active)
            for i in range(offset, active, self.micro_batch_times_dp):
                batch = perm[i: i + self.micro_batch_times_dp]
                if len(batch) < self.micro_batch_times_dp:
                    break
                self.consumed_samples += len(batch)
                yield batch


def dp_rows(batch: dict, dp_rank: int, dp_size: int) -> dict:
    """dp rank ``dp_rank``'s rows of a global batch dict of
    ``[num_micro, mb * dp, ...]`` arrays: rows ``dp_rank * mb`` up to
    ``(dp_rank + 1) * mb`` of each micro batch."""
    if dp_size == 1:
        return batch
    out = {}
    for k, v in batch.items():
        rows = v.shape[1]
        if rows % dp_size:
            raise ValueError(f"{k}: {rows} rows a micro batch do not split "
                             f"over dp {dp_size}")
        mb = rows // dp_size
        out[k] = v[:, dp_rank * mb:(dp_rank + 1) * mb]
    return out


def build_pretraining_data_loader(
    dataset,
    consumed_samples: int,
    micro_batch_size: int,
    data_parallel_size: int,
    num_microbatches: int,
    dataloader_type: str = "single",
    seed: int = 1234,
    collate_fn=None,
    prefetch: int = 2,
):
    """Returns an iterator of global-batch dicts ready for the train step:
    {tokens, labels, loss_mask, position_ids} each
    [num_micro, micro*dp, seq] (reference: data_samplers.py:14-46)."""
    if dataset is None:
        return None
    if dataloader_type == "single":
        sampler = MegatronPretrainingSampler(
            len(dataset), consumed_samples, micro_batch_size,
            data_parallel_size,
        )
    elif dataloader_type == "cyclic":
        sampler = MegatronPretrainingRandomSampler(
            len(dataset), consumed_samples, micro_batch_size,
            data_parallel_size, seed=seed,
        )
    else:
        raise ValueError(f"unknown dataloader type {dataloader_type!r}")

    def gen():
        micro_iter = iter(sampler)
        while True:
            micros = []
            try:
                for _ in range(num_microbatches):
                    micros.append(next(micro_iter))
            except StopIteration:
                return
            if collate_fn is not None:
                yield collate_fn([
                    [dataset[int(i)] for i in m] for m in micros
                ])
                continue
            texts = np.stack([
                np.stack([dataset[int(i)]["text"] for i in m]) for m in micros
            ])  # [M, mb*dp, seq+1]
            tokens = texts[:, :, :-1].astype(np.int32)
            labels = texts[:, :, 1:].astype(np.int32)
            yield {
                "tokens": tokens,
                "labels": labels,
                "loss_mask": np.ones_like(tokens, np.float32),
            }

    if prefetch <= 0:
        return gen()
    return _Prefetcher(gen(), prefetch)


class _Prefetcher:
    """Background-thread prefetch (stands in for the reference's
    torch DataLoader worker pool).  An error in the thread (a corrupt
    file, a bad index) is raised again by the consumer's ``next``, not
    taken for the end of the data."""

    def __init__(self, it, depth: int):
        self._it = it
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        end = self._done
        try:
            for item in self._it:
                self._q.put(item)
        except Exception as e:
            end = e
        finally:
            self._q.put(end)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item
