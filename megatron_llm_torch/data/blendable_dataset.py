"""Weighted mixture of datasets (a copy of
``megatron_llm_tpu/data/blendable_dataset.py``).

Reference: ``megatron/data/blendable_dataset.py:12-52`` — greedy
proportional interleave built by the native helper.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from megatron_llm_torch.data import helpers


class BlendableDataset:
    def __init__(self, datasets: Sequence, weights: Sequence[float], size: int):
        assert len(datasets) == len(weights)
        self.datasets = list(datasets)
        weights = np.asarray(weights, np.float64)
        weights = weights / weights.sum()
        self.size = int(size)
        self.dataset_index, self.dataset_sample_index = (
            helpers.build_blending_indices(weights, self.size)
        )
        # every referenced sample must exist
        for d, ds in enumerate(self.datasets):
            need = int(self.dataset_sample_index[self.dataset_index == d].max(
                initial=-1)) + 1
            assert need <= len(ds), (
                f"blend requires {need} samples from dataset {d}, "
                f"only {len(ds)} available"
            )

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        d = self.dataset_index[idx]
        return self.datasets[d][self.dataset_sample_index[idx]]
