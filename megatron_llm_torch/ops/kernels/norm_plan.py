"""The plans of the norm kernels in ``csrc/layernorm.cu`` and the packed
calls of their C entries, shared by ``ops/kernels/rmsnorm.py`` and
``ops/kernels/layernorm.py``.

B (RMSNorm) and D (LayerNorm) are one forward kernel, ``norm_fwd_kernel``,
that keeps each row in registers, split over ``row_threads`` threads of
``vecs`` 16-byte vectors each (vector v of the row on thread
v % row_threads); ``plan(n, h, dtype, sm_count)`` picks (row_threads,
vecs, rows_per_block, grid) for a call.  C (RMSNorm) and E (LayerNorm)
are one backward kernel, ``norm_bwd_kernel``, that holds x and g of a row
the same way and its column sums (C's dscale; E's dgamma and dbeta) for
the columns each thread owns in registers; ``bwd_plan`` picks its plan,
``bwd_plans`` lists the plans it can be forced to, and ``bwd_walk`` is
the order in which it adds the column sums.  The kernels take the plans
as given.  The wrappers of both kernels check their inputs with
``fwd_checks`` and ``bwd_checks``, and the backward's launch
(``launch_bwd``) is shared by C and E.
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


def bwd_shape(vecs: int, vec: int, rms: bool = False) -> Tuple[int, bool]:
    """(most threads a block, whether the next row is loaded ahead) of the
    backward at ``vecs`` vectors of ``vec`` elements a thread (the
    kernel's ``BwdShape``): registers for the column sums (2 * vecs * vec
    fp32 for E's dgamma and dbeta, vecs * vec for C's dscale, ``rms``), 8
    for x and g of a vector, 8 more to load the next row ahead, and 24 for
    the rest; ahead only where all of it fits the 128 registers of a
    512-thread block."""
    need = (1 if rms else 2) * vecs * vec + 8 * vecs + 24
    ahead = need + 8 * vecs <= 128
    need += 8 * vecs if ahead else 0
    return (512 if need <= 128 else 384 if need <= 168 else 256), ahead


# the backward's threads a block and threads a row aimed for, and its
# blocks an SM: every block writes one partial row, so one block an SM.
# The rule that timed best for E at Falcon-7B's and GPT-2's rows and for C
# at Llama-2-7B's and Gemma-7B's (chip_smoke.py --measure --sweep; PERF.md)
_BWD_BLOCK_THREADS = 512
_BWD_ROW_THREADS = 256
_BWD_BLOCKS_PER_SM = 1


@functools.lru_cache(maxsize=1024)
def bwd_plan(n: int, h: int, dtype: torch.dtype, sm_count: int = 132,
             rms: bool = False) -> Tuple[int, int, int, int]:
    """(row_threads, vecs, rows_per_block, grid) of the backward on [n, h]
    rows of ``dtype`` (C with ``rms``, else E), the forward's
    vector-to-thread map.  Each pair that covers the row within
    ``bwd_shape``'s threads takes as many rows a block as fit 512 threads;
    of those, the fewest idle vectors, then those that load the next row
    ahead, then rows wider than one warp, then the most threads a block,
    then row_threads nearest 256; one block an SM (each block's partial
    row is traffic of its own)."""
    vec, nvec = _vectors(h, dtype)
    cands = []
    for v in range(1, MAX_VECS + 1):
        t = _covering(nvec, v)
        limit, ahead = bwd_shape(v, vec, rms)
        if t <= limit:
            rows = max(1, min(_BWD_BLOCK_THREADS, limit) // t)
            cands.append((t * v - nvec, not ahead, t == 32, -rows * t,
                          abs(t - _BWD_ROW_THREADS), t, v, rows))
    if not cands:
        raise ValueError(f"norm backward rows of {h} {dtype} exceed its "
                         f"blocks' registers")
    *_, t, v, rows = min(cands)
    return t, v, rows, max(1, min(-(-n // rows),
                                  _BWD_BLOCKS_PER_SM * sm_count))


def bwd_plans(n: int, h: int, dtype: torch.dtype, sm_count: int = 132,
              rms: bool = False) -> list:
    """``bwd_plan``'s plan for [n, h] rows first (C with ``rms``, else E),
    then every plan the backward can be forced to (tests and sweeps): each
    (row_threads, vecs) within ``bwd_shape``'s threads, with one row a
    block, two, and as many as fit its threads, over a grid of one block an
    SM (or fewer when the rows run out), one that walks the rows seven
    times and one larger than the row groups (blocks with no row write
    zero partial rows)."""
    vec, nvec = _vectors(h, dtype)
    first = bwd_plan(n, h, dtype, sm_count, rms)
    out = set()
    for v in range(1, MAX_VECS + 1):
        t = _covering(nvec, v)
        limit, _ = bwd_shape(v, vec, rms)
        if t > limit:
            continue
        most = max(1, min(_BWD_BLOCK_THREADS, limit) // t)
        for rows in {1, min(2, most), most}:
            groups = -(-n // rows)
            out |= {(t, v, rows, g) for g in (min(groups, sm_count),
                                              -(-groups // 7), groups + 5)}
    out.discard(first)
    return [first] + sorted(out)


def bwd_walk(contrib: torch.Tensor, p: Tuple[int, int, int, int]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward's column sums of ``contrib`` [n, w] fp32 (each row's
    share of them) in the kernels' order under plan ``p``: (partial
    [grid, w], sums [w]).  Block b's slot s takes rows b * rows + s +
    k * grid * rows for k = 0, 1, ..., adding them to its columns row by
    row; a block adds its slots' sums in slot order into its partial row;
    the column pass's warp i (of 8) adds partial rows i, i + 8, ... in
    order, then the warps' sums are added in warp order."""
    _, _, rows, grid = p
    n, w = contrib.shape
    dev = contrib.device
    stride = grid * rows
    trips = -(-n // stride)
    padded = torch.zeros(trips * stride, w, device=dev)
    padded[:n] = contrib
    acc = torch.zeros(grid, rows, w, device=dev)
    for k in range(trips):
        acc = acc + padded[k * stride:(k + 1) * stride].view(grid, rows, w)
    partial = acc[:, 0]
    for s in range(1, rows):
        partial = partial + acc[:, s]
    warps = []
    for i in range(8):
        part = torch.zeros(w, device=dev)
        for r in range(i, grid, 8):
            part = part + partial[r]
        warps.append(part)
    sums = warps[0]
    for part in warps[1:]:
        sums = sums + part
    return partial, sums


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
# the backward's takes one packed NormBwdCall: the nine pointers x, gamma,
# g, mu, rstd, dx, partial, sums and the stream (mu 0 for RMSNorm); n, h,
# the two dtype codes, the plan and rms (1 for RMSNorm)
BWD_CALL = struct.Struct("=9Q9i")
_entries: dict = {}


def entry(name: str):
    """The library's entry ``name``, looked up once (no lock a call)."""
    fn = _entries.get(name)
    if fn is None:
        fn = _entries[name] = getattr(build.load_library(), name)
    return fn


def fwd_checks(kind: str, x: torch.Tensor, scale: torch.Tensor, bias):
    """The forward's checks in one pass (B where ``bias`` is None, else
    D) on x [..., h] with ``scale`` and ``bias`` [h]: (dtype codes,
    device, h, the pointers of x, scale and bias, 0 for none).  A call
    that fails one is refused with the reason."""
    codes = CODES.get((x.dtype, scale.dtype))
    dev = x.get_device()
    if (codes is None or dev < 0 or x.dim() < 1 or scale.dim() != 1
            or scale.get_device() != dev
            or not (x.is_contiguous() and scale.is_contiguous())
            or (bias is not None
                and (bias.get_device() != dev or bias.dtype != scale.dtype
                     or bias.shape != scale.shape
                     or not bias.is_contiguous()))):
        _refuse_fwd(kind, x, scale, bias)
    h = scale.shape[0]
    xp, sp = x.data_ptr(), scale.data_ptr()
    bp = 0 if bias is None else bias.data_ptr()
    if x.shape[-1] != h or h % (16 // x.element_size()) or (xp | sp | bp) % 16:
        _refuse_fwd(kind, x, scale, bias)
    return codes, dev, h, xp, sp, bp


def _refuse_fwd(kind, x, scale, bias) -> None:
    """Raise the error that says why the forward does not take these."""
    if bias is None:
        refuse(kind, x, scale)
    refuse(kind, x, scale, ("bias", bias, tuple(scale.shape), scale.dtype))


def bwd_checks(kind: str, x2d: torch.Tensor, scale: torch.Tensor,
               g2d: torch.Tensor, mu, rstd: torch.Tensor):
    """The backward's checks in one pass (C where ``mu`` is None, else E)
    on x2d [n, h] with scale [h], g2d [n, h] and the forward's mu and rstd
    [n, 1] fp32: (dtype codes, device, the pointers of x, scale and g).  A
    call that fails one is refused with the reason."""
    codes = CODES.get((x2d.dtype, scale.dtype))
    dev = x2d.get_device()
    f32 = torch.float32
    if (codes is None or dev < 0 or x2d.dim() != 2 or scale.dim() != 1
            or g2d.dtype != x2d.dtype or g2d.shape != x2d.shape
            or rstd.dtype != f32 or scale.get_device() != dev
            or g2d.get_device() != dev or rstd.get_device() != dev
            or not (x2d.is_contiguous() and scale.is_contiguous()
                    and g2d.is_contiguous() and rstd.is_contiguous())
            or (mu is not None
                and (mu.dtype != f32 or mu.get_device() != dev
                     or not mu.is_contiguous()))):
        _refuse_bwd(kind, x2d, scale, g2d, mu, rstd)
    n, h = x2d.shape
    xp, sp, gp = x2d.data_ptr(), scale.data_ptr(), g2d.data_ptr()
    if (scale.shape[0] != h or h % (16 // x2d.element_size())
            or (xp | sp | gp) % 16 or rstd.numel() != n
            or (mu is not None and mu.numel() != n)):
        _refuse_bwd(kind, x2d, scale, g2d, mu, rstd)
    return codes, dev, xp, sp, gp


def _refuse_bwd(kind, x2d, scale, g2d, mu, rstd) -> None:
    """Raise the error that says why the backward does not take these."""
    if x2d.dim() != 2:
        raise ValueError(f"{kind} takes x [n, h], got {tuple(x2d.shape)}")
    stats = (("rstd", rstd, None, torch.float32),)
    if mu is not None:
        stats = (("mu", mu, None, torch.float32),) + stats
    refuse(kind, x2d, scale, ("g", g2d, tuple(x2d.shape), x2d.dtype), *stats)


def launch_bwd(kind: str, x2d: torch.Tensor, scale: torch.Tensor,
               g2d: torch.Tensor, mu, rstd: torch.Tensor, force_plan=None):
    """Launch the backward (C where ``mu`` is None, else E) on x2d [n, h]
    under ``force_plan`` or ``bwd_plan``'s plan: (dx [n, h] in x's dtype,
    the column sums [w] fp32, the partial rows [grid, w] fp32, the plan or
    None where there is no row), w = h for C (dscale) and 2h for E (dgamma,
    then dbeta).  The sums and the partial rows are two allocations, so a
    gradient that keeps the sums keeps nothing more; the column pass
    writes every column, so nothing is zeroed."""
    codes, dev, xp, sp, gp = bwd_checks(kind, x2d, scale, g2d, mu, rstd)
    n, h = x2d.shape
    rms = mu is None
    w = h if rms else 2 * h
    f32 = torch.float32
    dx = torch.empty_like(x2d)
    if n == 0:
        return (dx, x2d.new_zeros((w,), dtype=f32),
                x2d.new_empty((0, w), dtype=f32), None)
    p = force_plan or bwd_plan(n, h, x2d.dtype, build.sm_count(dev), rms)
    sums = x2d.new_empty((w,), dtype=f32)
    part = x2d.new_empty((p[3], w), dtype=f32)
    rc = entry("mlt_norm_bwd")(BWD_CALL.pack(
        xp, sp, gp, 0 if rms else mu.data_ptr(), rstd.data_ptr(),
        dx.data_ptr(), part.data_ptr(), sums.data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev), n, h, codes[0], codes[1],
        p[0], p[1], p[2], p[3], rms))
    if rc:
        build.check_rc(rc, kind)
    return dx, sums, part, p


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
