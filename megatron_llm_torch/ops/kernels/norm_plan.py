"""The plans of the norm kernels in ``csrc/layernorm.cu`` and the packed
calls of their C entries, shared by ``ops/kernels/rmsnorm.py`` and
``ops/kernels/layernorm.py``.

B (RMSNorm) and D (LayerNorm) are one forward kernel, ``norm_fwd_kernel``,
that keeps each row in registers, split over ``row_threads`` threads of
``vecs`` 16-byte vectors each (vector v of the row on thread
v % row_threads); ``plan(n, h, dtype, sm_count)`` picks (row_threads,
vecs, rows_per_block, grid) for a call.  E, the LayerNorm backward, holds
x and g of a row the same way and its dgamma and dbeta sums for the
columns each thread owns in registers; ``bwd_plan`` picks its plan.  The
kernels take the plans as given.
"""

from __future__ import annotations

import functools
import struct
from typing import Tuple

import torch

from megatron_llm_torch.ops.kernels import build

# the forward's limits: 16-byte vectors a thread, threads a block
MAX_VECS = 8
MAX_THREADS = 1024


def max_threads(vecs: int) -> int:
    """Most threads a forward block takes at ``vecs`` vectors a thread (the
    kernel's launch bounds: beyond 4 vectors a thread needs more than the
    64 registers a 1024-thread block leaves)."""
    return MAX_THREADS if vecs <= 4 else MAX_THREADS // 2


# threads a row that decode rows (at most one a block) and training rows
# aim for; threads a training-rows block (rows side by side); blocks an SM
# of a training-rows grid (a block then walks further rows, keeping its
# parameters).  The values that timed best at Falcon-7B's 4544 columns on
# the H100 (chip_smoke.py --measure --sweep; PERF.md).
_DECODE_ROW_THREADS = 256
_TRAIN_ROW_THREADS = 128
_TRAIN_BLOCK_THREADS = 512
_TRAIN_BLOCKS_PER_SM = 2


def _vectors(h: int, dtype: torch.dtype) -> Tuple[int, int]:
    """(elements a 16-byte vector, vectors a row)."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    if h % vec:
        raise ValueError(f"the norm kernels need h % {vec} == 0, got h = {h}")
    return vec, h // vec


def _covering(nvec: int, vecs: int) -> int:
    """Threads (a multiple of 32) that hold ``nvec`` vectors at ``vecs``
    a thread."""
    return 32 * -(-nvec // (32 * vecs))


@functools.lru_cache(maxsize=1024)
def plan(n: int, h: int, dtype: torch.dtype, sm_count: int = 132
         ) -> Tuple[int, int, int, int]:
    """(row_threads, vecs, rows_per_block, grid) of the forward on [n, h]
    rows of ``dtype``: a row's h / (16 / itemsize) vectors are spread over
    row_threads threads (a multiple of 32) of vecs vectors each, vector v
    on thread v % row_threads.  Of the pairs that cover the row, decode
    rows (n at most the SM count) take the one whose row_threads is
    nearest 256, one row a block; training rows the one nearest 128 (four
    warps a row), several rows to a block of about 512 threads, two
    blocks an SM.  Ties go to fewer idle vectors."""
    _, nvec = _vectors(h, dtype)
    cands = []
    for v in range(1, MAX_VECS + 1):
        t = _covering(nvec, v)
        if t <= max_threads(v):
            cands.append((t, v))
    if not cands:
        raise ValueError(f"norm rows of {h} {dtype} exceed one block's "
                         f"{MAX_THREADS} threads x {MAX_VECS} vectors")
    decode = n <= sm_count
    target = _DECODE_ROW_THREADS if decode else _TRAIN_ROW_THREADS
    t, v = min(cands, key=lambda c: (abs(c[0] - target), c[0] * c[1]))
    if decode:
        return t, v, 1, max(n, 1)
    rows = max(1, min(_TRAIN_BLOCK_THREADS, max_threads(v)) // t)
    return t, v, rows, min(-(-n // rows), _TRAIN_BLOCKS_PER_SM * sm_count)


def bwd_shape(vecs: int, vec: int) -> Tuple[int, bool]:
    """(most threads a block, whether the next row is loaded ahead) of E
    at ``vecs`` vectors of ``vec`` elements a thread (the kernel's
    ``BwdShape``): registers for the 2 * vecs * vec fp32 sums, 8 for x and
    g of a vector, 8 more to load the next row ahead, and 24 for the rest;
    ahead only where all of it fits the 128 registers of a 512-thread
    block."""
    need = 2 * vecs * vec + 8 * vecs + 24
    ahead = need + 8 * vecs <= 128
    need += 8 * vecs if ahead else 0
    return (512 if need <= 128 else 384 if need <= 168 else 256), ahead


# E's threads a row and threads a block aimed for, and its blocks an SM:
# every block writes one partial row of 2h fp32, so one block an SM
_BWD_ROW_THREADS = 192
_BWD_BLOCK_THREADS = 512
_BWD_BLOCKS_PER_SM = 1


@functools.lru_cache(maxsize=1024)
def bwd_plan(n: int, h: int, dtype: torch.dtype, sm_count: int = 132
             ) -> Tuple[int, int, int, int]:
    """(row_threads, vecs, rows_per_block, grid) of E on [n, h] rows of
    ``dtype``, the forward's vector-to-thread map.  Of the pairs that
    cover the row within ``bwd_shape``'s threads, the fewest idle vectors,
    then those that load the next row ahead, then row_threads nearest
    192; as many rows a block as fit 512 threads, one block an SM (each
    block's partial row is traffic of its own)."""
    vec, nvec = _vectors(h, dtype)
    cands = []
    for v in range(1, MAX_VECS + 1):
        t = _covering(nvec, v)
        limit, ahead = bwd_shape(v, vec)
        if t <= limit:
            cands.append((t * v - nvec, not ahead, abs(t - _BWD_ROW_THREADS),
                          t, v))
    if not cands:
        raise ValueError(f"layernorm backward rows of {h} {dtype} exceed "
                         f"its blocks' registers")
    *_, t, v = min(cands)
    limit, _ = bwd_shape(v, vec)
    rows = max(1, min(_BWD_BLOCK_THREADS, limit) // t)
    return t, v, rows, max(1, min(-(-n // rows),
                                  _BWD_BLOCKS_PER_SM * sm_count))


# (x dtype, parameter dtype) -> their codes, for the pairs the kernels take
CODES = {(x, p): (build.DTYPE_CODES[x], build.DTYPE_CODES[p])
         for x, p in ((torch.bfloat16, torch.bfloat16),
                      (torch.bfloat16, torch.float32),
                      (torch.float32, torch.float32))}
# the forward's C entry takes one packed NormFwdCall (csrc/layernorm.cu):
# the seven pointers x, gamma, beta, y, mu, rstd and the stream (beta, mu
# and rstd may be 0); n, h, the two dtype codes, the plan (row_threads,
# vecs, rows_per_block, grid) and rms (1 for RMSNorm); eps
FWD_CALL = struct.Struct("=7Q9if")
# E's takes one packed LnBwdCall: the nine pointers x, gamma, g, mu, rstd,
# dx, partial, sums and the stream; n, h, the two dtype codes and the plan
BWD_CALL = struct.Struct("=9Q8i")
_entries: dict = {}


def entry(name: str):
    """The library's entry ``name``, looked up once (no lock a call)."""
    fn = _entries.get(name)
    if fn is None:
        fn = _entries[name] = getattr(build.load_library(), name)
    return fn


def refuse(kind: str, x: torch.Tensor, scale: torch.Tensor, *others
           ) -> None:
    """Raise the error that says why a norm kernel does not take x [..., h]
    with ``scale`` [h] and the tensors ``others``, each (name, tensor,
    shape or None for any of x's row count of elements, dtype), that must
    lie beside them."""
    build.require_cuda(x, "x")
    build.require_cuda(scale, "scale")
    x_code, p_code = build.dtype_code(x), build.dtype_code(scale)
    if x_code == build.DTYPE_CODES[torch.float32] and p_code != x_code:
        raise TypeError(f"{kind}: a float32 x takes float32 parameters")
    if x.dim() < 1 or scale.dim() != 1 or x.shape[-1] != scale.shape[0]:
        raise ValueError(f"{kind} takes x [..., h] and scale [h], got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    h = x.shape[-1]
    for name, t, shape, dtype in others:
        build.require_cuda(t, name)
        if t.dtype != dtype or (tuple(t.shape) != tuple(shape)
                                if shape is not None
                                else t.numel() * h != x.numel()):
            raise ValueError(f"{kind}: {name} must be {dtype} of shape "
                             f"{shape or 'n rows'}, got {t.dtype}, "
                             f"{tuple(t.shape)}")
    dev = x.get_device()
    if any(t.get_device() != dev for t in (scale, *(o[1] for o in others))):
        raise ValueError(f"{kind}: every tensor must be on x's device")
    vec = 16 // x.element_size()
    if h % vec or x.data_ptr() % 16:
        raise ValueError(f"{kind} needs 16-byte aligned rows (h % {vec} "
                         f"== 0), got h = {h}")
    if any(t.data_ptr() % 16 for t in (scale, *(o[1] for o in others
                                                if o[2] is not None))):
        raise ValueError(f"{kind} needs 16-byte aligned parameters and "
                         f"gradients")
    raise ValueError(f"{kind}: inputs not taken")
