"""Memory-mapped indexed token dataset (a copy of
``megatron_llm_tpu/data/indexed_dataset.py``).

Capability parity with the reference's ``MMapIndexedDataset``
(``megatron/data/indexed_dataset.py:341+``): a flat ``.bin`` of tokens plus
an ``.idx`` holding per-sequence sizes/pointers and document boundaries,
memory-mapped for zero-copy random access; a builder with
``add_item``/``end_document``/``merge_file_``; dtype auto-selection by
vocab size.

The on-disk format is this framework's own (single header + three numpy
blocks); it is *not* byte-compatible with Megatron's .idx — conversion is a
re-preprocess with ``tools/preprocess_data.py``.
"""

from __future__ import annotations

import os
import shutil
import struct
from functools import lru_cache
from typing import Optional

import numpy as np

_MAGIC = b"MLTPUIDX"
_VERSION = 1

_DTYPES = {
    1: np.uint8,
    2: np.int8,
    3: np.int16,
    4: np.int32,
    5: np.int64,
    6: np.float32,
    7: np.float64,
    8: np.uint16,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def best_fitting_dtype(vocab_size: Optional[int] = None) -> np.dtype:
    # reference: indexed_dataset.py best_fitting_dtype — uint16 when the
    # vocab fits, else int32
    if vocab_size is not None and vocab_size < 65500:
        return np.dtype(np.uint16)
    return np.dtype(np.int32)


def data_file_path(prefix: str) -> str:
    return prefix + ".bin"


def index_file_path(prefix: str) -> str:
    return prefix + ".idx"


class MMapIndexedDataset:
    """Zero-copy random access over a (bin, idx) pair."""

    def __init__(self, path_prefix: str, skip_warmup: bool = True):
        self._path_prefix = path_prefix
        with open(index_file_path(path_prefix), "rb") as f:
            magic = f.read(8)
            if magic != _MAGIC:
                raise ValueError(
                    f"{index_file_path(path_prefix)}: bad magic {magic!r} "
                    "(not a megatron_llm_tpu indexed dataset)"
                )
            version, dtype_code, nseq, ndoc = struct.unpack("<QBQQ", f.read(25))
            if version != _VERSION:
                raise ValueError(f"unsupported index version {version}")
            self._dtype = np.dtype(_DTYPES[dtype_code])
            header_size = f.tell()
        idx_buf = np.memmap(index_file_path(path_prefix), mode="r")
        off = header_size
        self.sizes = np.frombuffer(idx_buf, np.int32, count=nseq, offset=off)
        off += nseq * 4
        self._pointers = np.frombuffer(idx_buf, np.int64, count=nseq, offset=off)
        off += nseq * 8
        self.doc_idx = np.frombuffer(idx_buf, np.int64, count=ndoc + 1, offset=off)
        self._bin = np.memmap(data_file_path(path_prefix), mode="r",
                              dtype=self._dtype)

    def __len__(self) -> int:
        return len(self.sizes)

    @property
    def dtype(self):
        return self._dtype

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            start, stop, step = idx.indices(len(self))
            assert step == 1
            return [self[i] for i in range(start, stop)]
        ptr = self._pointers[idx] // self._dtype.itemsize
        return self._bin[ptr: ptr + self.sizes[idx]]

    def get(self, idx: int, offset: int = 0, length: Optional[int] = None):
        """Partial sequence read (reference: MMapIndexedDataset.get)."""
        size = self.sizes[idx]
        if length is None:
            length = size - offset
        ptr = self._pointers[idx] // self._dtype.itemsize + offset
        return self._bin[ptr: ptr + length]

    @staticmethod
    def exists(path_prefix: str) -> bool:
        return os.path.exists(index_file_path(path_prefix)) and os.path.exists(
            data_file_path(path_prefix)
        )


class MMapIndexedDatasetBuilder:
    def __init__(self, out_file: str, dtype=np.int32):
        self._bin_path = out_file
        self._f = open(out_file, "wb")
        self._dtype = np.dtype(dtype)
        self._sizes = []
        self._doc_idx = [0]
        self._bytes_written = 0

    def add_item(self, tokens) -> None:
        arr = np.asarray(tokens, dtype=self._dtype)
        self._f.write(arr.tobytes(order="C"))
        self._sizes.append(len(arr))
        self._bytes_written += arr.nbytes

    def end_document(self) -> None:
        self._doc_idx.append(len(self._sizes))

    def merge_file_(self, another_prefix: str) -> None:
        """Append another dataset with the same dtype
        (reference: indexed_dataset.py merge_file_)."""
        other = MMapIndexedDataset(another_prefix)
        assert other.dtype == self._dtype
        base = len(self._sizes)
        offset_docs = other.doc_idx[1:]  # skip leading 0
        self._sizes.extend(other.sizes.tolist())
        self._doc_idx.extend((offset_docs + base).tolist())
        with open(data_file_path(another_prefix), "rb") as src:
            shutil.copyfileobj(src, self._f)
        self._bytes_written += other._bin.nbytes

    def finalize(self, index_file: str) -> None:
        self._f.close()
        sizes = np.asarray(self._sizes, np.int32)
        pointers = np.zeros(len(sizes), np.int64)
        if len(sizes) > 1:
            np.cumsum(sizes[:-1].astype(np.int64) * self._dtype.itemsize,
                      out=pointers[1:])
        doc_idx = np.asarray(self._doc_idx, np.int64)
        with open(index_file, "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<QBQQ", _VERSION,
                                _DTYPE_CODES[self._dtype],
                                len(sizes), len(doc_idx) - 1))
            f.write(sizes.tobytes())
            f.write(pointers.tobytes())
            f.write(doc_idx.tobytes())


def make_builder(out_file: str, impl: str = "mmap", vocab_size=None):
    # reference: indexed_dataset.py make_builder (impl kept for CLI parity;
    # only mmap exists here)
    assert impl == "mmap", "only the mmap implementation exists on TPU"
    return MMapIndexedDatasetBuilder(out_file, dtype=best_fitting_dtype(vocab_size))


def make_dataset(path_prefix: str, impl: str = "mmap", skip_warmup: bool = True):
    assert impl in ("mmap", "infer")
    return MMapIndexedDataset(path_prefix, skip_warmup)
