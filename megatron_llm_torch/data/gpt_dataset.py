"""Packed GPT pretraining dataset (a copy of
``megatron_llm_tpu/data/gpt_dataset.py``).

Reference: ``megatron/data/gpt_dataset.py`` — documents are packed into
fixed ``seq_length`` samples crossing doc boundaries; a triple of cached
index arrays drives deterministic random access:

* ``doc_idx``  — documents repeated num_epochs times, shuffled (:409-443)
* ``sample_idx`` — sample -> (doc position, offset) pairs, built by the
  native helper (:354-357; helpers.cpp:83)
* ``shuffle_idx`` — sample-level shuffle (:495-508)

All three are built once and cached as ``.npy`` keyed by
(num_samples, seq_length, seed) (:272-407).  ``__getitem__`` returns
``seq_length + 1`` tokens (input/label shift happens in the trainer).
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Optional, Sequence

import numpy as np

from megatron_llm_torch.data import helpers
from megatron_llm_torch.data.indexed_dataset import MMapIndexedDataset, make_dataset


def get_train_valid_test_split_(splits_string: str, size: int):
    """Parse '969,30,1'-style ratios into index boundaries
    (reference: gpt_dataset.py get_train_valid_test_split_)."""
    splits = []
    if splits_string.find(",") != -1:
        splits = [float(s) for s in splits_string.split(",")]
    elif splits_string.find("/") != -1:
        splits = [float(s) for s in splits_string.split("/")]
    else:
        splits = [float(splits_string)]
    while len(splits) < 3:
        splits.append(0.0)
    splits = splits[:3]
    total = sum(splits)
    assert total > 0.0
    splits = [s / total for s in splits]
    idx = [0]
    for s in splits:
        idx.append(idx[-1] + int(round(s * float(size))))
    diff = idx[-1] - size
    for i in range(1, len(idx)):
        idx[i] -= diff
    assert len(idx) == 4 and idx[-1] == size
    return idx


class GPTDataset:
    def __init__(
        self,
        name: str,
        data_prefix: str,
        documents: np.ndarray,
        indexed_dataset: MMapIndexedDataset,
        num_samples: int,
        seq_length: int,
        seed: int,
        cache_dir: Optional[str] = None,
    ):
        self.name = name
        self.indexed_dataset = indexed_dataset
        self.seq_length = seq_length
        assert np.min(documents) >= 0
        assert np.max(documents) < len(indexed_dataset.doc_idx) - 1

        self.doc_idx, self.sample_idx, self.shuffle_idx = _build_index_mappings(
            name, data_prefix, documents, indexed_dataset.sizes,
            num_samples, seq_length, seed, cache_dir,
        )

    def __len__(self):
        return self.sample_idx.shape[0] - 1

    def __getitem__(self, idx: int):
        idx = self.shuffle_idx[idx]
        doc_f, off_f = self.sample_idx[idx]
        doc_l, off_l = self.sample_idx[idx + 1]
        ds = self.indexed_dataset
        if doc_f == doc_l:
            sample = ds.get(self.doc_idx[doc_f], offset=off_f,
                            length=off_l - off_f + 1)
        else:
            parts = [ds.get(self.doc_idx[doc_f], offset=off_f)]
            for i in range(doc_f + 1, doc_l):
                parts.append(ds.get(self.doc_idx[i]))
            parts.append(ds.get(self.doc_idx[doc_l], length=off_l + 1))
            sample = np.concatenate(parts)
        assert len(sample) == self.seq_length + 1, (
            f"sample {idx}: got {len(sample)} tokens, "
            f"want {self.seq_length + 1}"
        )
        return {"text": np.asarray(sample, np.int64)}


def _build_index_mappings(
    name, data_prefix, documents, sizes, num_samples, seq_length, seed,
    cache_dir=None,
):
    tokens_per_epoch = int(np.sum(sizes[documents]))
    # epochs needed to cover num_samples packed samples (+1 shift token)
    num_epochs = 1
    while (num_epochs * tokens_per_epoch - 1) // seq_length < num_samples:
        num_epochs += 1

    cache_dir = cache_dir or (os.path.dirname(data_prefix) or ".")
    tag = hashlib.md5(
        f"{name}-{len(documents)}-{num_samples}-{seq_length}-{seed}".encode()
    ).hexdigest()[:16]
    base = os.path.join(cache_dir, f"{os.path.basename(data_prefix)}_{tag}")
    doc_p, samp_p, shuf_p = (base + "_doc_idx.npy", base + "_sample_idx.npy",
                             base + "_shuffle_idx.npy")

    if all(os.path.exists(p) for p in (doc_p, samp_p, shuf_p)):
        return (np.load(doc_p, mmap_mode="r"), np.load(samp_p, mmap_mode="r"),
                np.load(shuf_p, mmap_mode="r"))

    t0 = time.time()
    rng = np.random.RandomState(seed)
    # doc_idx: documents x epochs, shuffled (reference :409-443 shuffles all
    # but the last partial epoch separately; equal behaviour with full
    # shuffle is acceptable because we cap samples below)
    doc_idx = np.tile(documents, num_epochs)
    rng.shuffle(doc_idx)
    doc_idx = doc_idx.astype(np.int64)

    sample_idx = helpers.build_sample_idx(
        np.asarray(sizes, np.int32), doc_idx, seq_length, num_samples
    )

    shuffle_idx = np.arange(num_samples, dtype=np.int64)
    rng.shuffle(shuffle_idx)

    try:
        np.save(doc_p, doc_idx, allow_pickle=False)
        np.save(samp_p, sample_idx, allow_pickle=False)
        np.save(shuf_p, shuffle_idx, allow_pickle=False)
    except OSError:
        pass  # read-only data dir: skip caching
    if time.time() - t0 > 5:
        print(f" > built GPT index mappings for {name} in "
              f"{time.time() - t0:.1f}s ({num_samples} samples, "
              f"{num_epochs} epochs)")
    return doc_idx, sample_idx, shuffle_idx


def build_train_valid_test_datasets(
    data_prefix,
    splits_string: str,
    train_valid_test_num_samples: Sequence[int],
    seq_length: int,
    seed: int,
    data_impl: str = "mmap",
    skip_warmup: bool = True,
):
    """Reference: gpt_dataset.py:20-96 — single prefix split by ratio, or a
    weighted multi-prefix blend (handled by BlendableDataset)."""
    if isinstance(data_prefix, (list, tuple)) and len(data_prefix) > 1:
        from megatron_llm_torch.data.blendable_dataset import BlendableDataset

        # [w0, p0, w1, p1, ...]
        assert len(data_prefix) % 2 == 0
        weights = [float(w) for w in data_prefix[0::2]]
        prefixes = list(data_prefix[1::2])
        total = sum(weights)
        weights = [w / total for w in weights]
        per_ds = [
            [int(np.ceil(w * n * 1.005)) for n in train_valid_test_num_samples]
            for w in weights
        ]
        trains, valids, tests = [], [], []
        for prefix, nums in zip(prefixes, per_ds):
            tr, va, te = build_train_valid_test_datasets(
                prefix, splits_string, nums, seq_length, seed, data_impl,
                skip_warmup,
            )
            trains.append(tr); valids.append(va); tests.append(te)
        make = lambda dss, n: (
            BlendableDataset([d for d in dss if d is not None], weights, n)
            if any(d is not None for d in dss) else None
        )
        return (make(trains, train_valid_test_num_samples[0]),
                make(valids, train_valid_test_num_samples[1]),
                make(tests, train_valid_test_num_samples[2]))

    if isinstance(data_prefix, (list, tuple)):
        data_prefix = data_prefix[0]

    indexed = make_dataset(data_prefix, data_impl, skip_warmup)
    total_docs = len(indexed.doc_idx) - 1
    splits = get_train_valid_test_split_(splits_string, total_docs)

    def make_split(i, name):
        if splits[i + 1] <= splits[i] or train_valid_test_num_samples[i] == 0:
            return None
        documents = np.arange(splits[i], splits[i + 1], dtype=np.int32)
        return GPTDataset(name, data_prefix, documents, indexed,
                          train_valid_test_num_samples[i], seq_length, seed)

    return (make_split(0, "train"), make_split(1, "valid"),
            make_split(2, "test"))
