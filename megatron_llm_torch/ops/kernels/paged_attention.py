"""Ragged paged attention for the serving engine: the CUDA kernels of
``csrc/paged_attention.cu`` (A over plain pools, A' over int8 pools) and
their plain PyTorch version.

The counterpart of ``megatron_llm_tpu/ops/pallas/paged_attention.py``,
with the same two entries and arguments:

* ``paged_attention_decode`` — q ``[S, nh, d]``, one query token per
  slot, attending keys ``0..context_lens[s]``;
* ``paged_attention_prefill`` — q ``[S, C, nh, d]``, row ``j`` attending
  ``0..context_lens[s]+j`` (the chunk's own K/V already scattered into
  the pools).

Pools are ``[P, bs, g, d]`` (GQA when g < nh), ``block_tables`` ``[S, M]``
int32 with unowned entries pointing at the garbage block 0, and a
sliding window drops ``key_pos <= query_pos - window``.  int8 pools come
with ``k_scales`` / ``v_scales`` ``[P, bs, g]`` fp32 (absmax per page,
position and group) and are dequantised inside the kernel, so int8 is what
crosses device memory.  A CPU tensor takes the plain version (the port of
``_reference_paged_prefill``: a dense gather of every slot's table,
dequantised when there are scales, then masked fp32 softmax); a CUDA
tensor launches the kernel or raises.

On the card, ``plan`` picks the kernel from the call's shapes alone
(``kernel_variant``): "mma", the tensor-core kernel, for bf16 and fp16
calls with at least ``MMA_MIN_ROWS`` query rows a (slot, KV group)
(every prefill chunk, and the decode of GQA and MQA groups, as
Falcon-7B's 71 heads on one); "simt", the CUDA-core kernel, for the rest (MHA decode, one row a
group) and for fp32.  The keys of each block are split over
``key_splits`` blocks, and over at least ``table_splits`` where a long
block table would overflow the kernels' shared-memory page list; more
than one split writes fp32 partials that a
merge kernel adds in split order (``_reference_split_partials`` and
``_reference_merge`` are the plain versions of the two steps, and the
card tests hold a launch's partials to the first).  The plan lives here
only: the CUDA entry takes the variant and the splits it is given.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from megatron_llm_torch.ops.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256)
VARIANTS = ("simt", "mma")       # the C interface's codes 0 and 1
# The plan.  The tensor-core kernel takes a call from MMA_MIN_ROWS query
# rows a (slot, group) on, in tiles of MMA_TILE (flat rows, keys); the
# CUDA-core kernel takes 1, 2 or 4 rows a block and key tiles of
# SIMT_TILE_BYTES of K (16 to 64 keys) -- the tiles csrc/paged_attention.cu
# launches.  The keys split over the fewest blocks that fill the grid's
# last wave of SM-count blocks to WAVE_FILL percent, at most one split per
# 2 pages of the block table.  (chip_smoke.py sweeps the row threshold and
# the splits.)
MMA_MIN_ROWS = 2
MMA_TILE = (64, 64)
SIMT_TILE_BYTES = 16384
WAVE_FILL = 85      # percent
# block-table entries a split stages in shared memory: the kernels'
# kPagesSmem (16 KB) of int32; a longer table takes more splits
# (table_splits), as Llama-3.1's 131072 positions at 16 a page do
PAGES_SMEM_ENTRIES = 4096

# kernel launches through each entry since the last reset (plain
# counts; chip_smoke.py zeroes them before driving the serving path and
# reads them after): kernel A over plain pools, kernel A' over int8 pools.
# ``variant_launches`` counts the same launches by kernel variant, and
# ``merge_launches`` the merges of split keys.
decode_launches = 0
prefill_launches = 0
quant_decode_launches = 0
quant_prefill_launches = 0
merge_launches = 0
variant_launches: dict = {}


def kernel_variant(dtype: torch.dtype, rows_per_group: int, d: int,
                   quantized: bool) -> str:
    """The kernel a CUDA call takes: "mma" for bf16 and fp16 with at
    least MMA_MIN_ROWS query rows a (slot, KV group) (C * nh / g), else
    "simt".  Pools of q's dtype or int8 (``quantized``) take the same
    route.  Raises for a dtype or head_dim no kernel takes."""
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim must be one of {HEAD_DIMS}, got {d}")
    if dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"the paged kernels take float32, bfloat16 or "
                        f"float16 q, got {dtype}")
    del quantized   # int8 pools are converted where they are read
    if dtype != torch.float32 and rows_per_group >= MMA_MIN_ROWS:
        return "mma"
    return "simt"


def tile_shape(variant: str, dtype: torch.dtype, rows_per_group: int,
               d: int, quantized: bool) -> Tuple[int, int]:
    """(flat query rows, keys) of one block's tile for ``variant``."""
    if variant == "mma":
        return MMA_TILE
    rows = 4 if rows_per_group >= 3 else rows_per_group
    kv_bytes = 1 if quantized else dtype.itemsize
    return rows, min(64, max(16, SIMT_TILE_BYTES // (d * kv_bytes)))


def key_splits(blocks: int, M: int, bs: int, tile_keys: int,
               sm_count: int) -> int:
    """Blocks that share one (slot, row tile, group)'s keys: the fewest
    with which the grid of ``blocks`` x splits fills its last wave of
    ``sm_count`` blocks to WAVE_FILL percent (a wave that leaves SMs idle
    is the loss a split repairs; each split more costs a partial's write
    and its merge), at most one split per 2 pages of an M-page table and
    no more than its key tiles."""
    cap = max(1, min(M // 2, -(-M * bs // tile_keys)))
    for n in range(1, cap):
        grid = blocks * n
        if 100 * grid >= WAVE_FILL * -(-grid // sm_count) * sm_count:
            return n
    return cap


def pages_cap(M: int, bs: int, splits: int, tile_keys: int) -> int:
    """The most block-table entries one split's key tiles reach (the
    kernels' ``pages_cap``)."""
    max_tiles = -(-M * bs // tile_keys) + 1
    per_split = -(-max_tiles // splits)
    return min(M, per_split * tile_keys // bs + 2)


def table_splits(M: int, bs: int, tile_keys: int) -> int:
    """The fewest splits whose page lists fit the kernels' shared-memory
    list of PAGES_SMEM_ENTRIES entries."""
    n = 1
    while pages_cap(M, bs, n, tile_keys) > PAGES_SMEM_ENTRIES:
        n += 1
    return n


@functools.lru_cache(maxsize=1024)
def plan(dtype: torch.dtype, S: int, C: int, nh: int, g: int, d: int,
         bs: int, M: int, quantized: bool, sm_count: int,
         variant: Optional[str] = None) -> Tuple[str, int, int, int]:
    """(variant, tile rows, tile keys, splits) of a call on q
    [S, C, nh, d] over pools [P, bs, g, d] and an [S, M] table
    (``variant`` forces the kernel)."""
    rows = C * (nh // g)
    variant = variant or kernel_variant(dtype, rows, d, quantized)
    tr, tk = tile_shape(variant, dtype, rows, d, quantized)
    blocks = S * -(-rows // tr) * g
    return variant, tr, tk, max(key_splits(blocks, M, bs, tk, sm_count),
                                table_splits(M, bs, tk))


def _gather(k_pages, v_pages, block_tables, k_scales, v_scales):
    """Every slot's table as dense fp32 K and V [S, M * bs, g, d] (int8
    pools times their scales)."""
    S, M = block_tables.shape
    _, bs, g, d = k_pages.shape
    bt = block_tables.long()
    k = k_pages[bt].reshape(S, M * bs, g, d).float()
    v = v_pages[bt].reshape(S, M * bs, g, d).float()
    if k_scales is not None:
        k = k * k_scales[bt].reshape(S, M * bs, g, 1)
        v = v * v_scales[bt].reshape(S, M * bs, g, 1)
    return k, v


def _reference_paged_prefill(q, k_pages, v_pages, block_tables,
                             context_lens, k_scales, v_scales, scale,
                             window):
    """Plain version: dense-gather chunked prefill in fp32 (int8 pools
    times their scales); q [S, C, nh, d] -> [S, C, nh, d] in q's dtype."""
    S, C, nh, d = q.shape
    bs, g = k_pages.shape[1], k_pages.shape[2]
    M = block_tables.shape[1]
    qpg = nh // g
    k, v = _gather(k_pages, v_pages, block_tables, k_scales, v_scales)
    qg = q.reshape(S, C, g, qpg, d).float()
    scores = torch.einsum("bsgpd,btgd->bgpst", qg, k) * scale
    key_pos = torch.arange(M * bs, device=q.device)
    pos = (context_lens.long()[:, None]
           + torch.arange(C, device=q.device)[None, :])          # [S, C]
    valid = key_pos[None, None, :] <= pos[:, :, None]            # [S, C, T]
    if window is not None:
        valid &= key_pos[None, None, :] > (pos[:, :, None] - window)
    scores = torch.where(valid[:, None, None], scores,
                         torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgpst,btgd->bsgpd", probs, v)
    return out.reshape(S, C, nh, d).to(q.dtype)


def _reference_paged_attention(q, k_pages, v_pages, block_tables,
                               context_lens, k_scales, v_scales, scale,
                               window):
    """Decode plain version: the C == 1 instance of the prefill one."""
    return _reference_paged_prefill(q[:, None], k_pages, v_pages,
                                    block_tables, context_lens, k_scales,
                                    v_scales, scale, window)[:, 0]


def _split_key_ranges(context_lens, C, qpg, M, bs, window, tile_rows,
                      tile_keys, splits):
    """[splits, S, C * qpg, 2]: the keys [a, b) that each split of the
    block holding flat row r of slot s covers (the kernels' ``block_of``):
    the block's key range [lo, hi], cut into tiles of ``tile_keys`` and
    the tiles shared out in order."""
    R = C * qpg
    r0 = torch.arange(R) // tile_rows * tile_rows
    r1 = torch.clamp(r0 + tile_rows, max=R) - 1
    ctx = context_lens.long().cpu()[:, None]
    pos_lo = ctx + r0 // qpg
    hi = torch.clamp(ctx + r1 // qpg, max=M * bs - 1)
    lo = (torch.clamp(pos_lo - window + 1, min=0) if window is not None
          else torch.zeros_like(pos_lo))
    t0 = lo // tile_keys
    n = torch.where(hi >= lo, hi // tile_keys - t0 + 1, 0)
    sp = torch.arange(splits)[:, None, None]
    a = (t0 + sp * n // splits) * tile_keys
    b = (t0 + (sp + 1) * n // splits) * tile_keys
    return torch.stack([a, b], dim=-1)


def _reference_split_partials(q, k_pages, v_pages, block_tables,
                              context_lens, k_scales, v_scales, scale,
                              window, *, tile_rows, tile_keys, splits):
    """Plain version of one kernel launch with its keys split: q
    [S, C, nh, d] -> fp32 partials (o [splits, S, C, nh, d] not yet
    divided by l, m [splits, S, C, nh] the row's largest score in the
    split, -inf where no key of the split reaches it, l its sum of
    exp(score - m)), each split over the keys ``_split_key_ranges``
    gives it."""
    S, C, nh, d = q.shape
    bs, g = k_pages.shape[1], k_pages.shape[2]
    M = block_tables.shape[1]
    qpg = nh // g
    T = M * bs
    k, v = _gather(k_pages, v_pages, block_tables, k_scales, v_scales)
    qg = q.reshape(S, C, g, qpg, d).float()
    scores = torch.einsum("bsgpd,btgd->bsgpt", qg, k) * scale
    key = torch.arange(T, device=q.device)
    pos = (context_lens.long()[:, None]
           + torch.arange(C, device=q.device)[None, :])          # [S, C]
    valid = key <= pos[:, :, None]                               # [S, C, T]
    if window is not None:
        valid &= key > pos[:, :, None] - window
    ranges = _split_key_ranges(context_lens, C, qpg, M, bs, window,
                               tile_rows, tile_keys, splits).to(q.device)
    ranges = ranges.reshape(splits, S, C, 1, qpg, 2)
    in_split = ((key >= ranges[..., :1]) & (key < ranges[..., 1:])
                & valid[None, :, :, None, None, :])  # [z, S, C, 1, qpg, T]
    s = scores[None].masked_fill(~in_split, float("-inf"))
    m = s.amax(-1)                                    # [z, S, C, g, qpg]
    p = torch.exp(s - torch.where(m == float("-inf"), 0.0, m)[..., None])
    l = p.sum(-1)
    o = torch.einsum("zbsgpt,btgd->zbsgpd", p, v)
    return (o.reshape(splits, S, C, nh, d), m.reshape(splits, S, C, nh),
            l.reshape(splits, S, C, nh))


def _reference_merge(o, m, l, dtype):
    """Plain version of the merge kernel: the splits' partials -> the
    output [S, C, nh, d] in ``dtype`` (0 for a row no key reaches)."""
    mt = m.amax(0)
    w = torch.exp(m - torch.where(mt == float("-inf"), 0.0, mt))
    lt = (l * w).sum(0)
    out = (o * w[..., None]).sum(0)
    return (out / torch.where(lt == 0, 1.0, lt)[..., None]).to(dtype)


def _refuse_placement(named) -> None:
    """Raise for the first tensor of ``named`` that is not a contiguous
    CUDA tensor on the first one's device."""
    device = named[0][1].device
    for name, t in named:
        build.require_cuda(t, name)
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, q on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (the kernel reads "
                             f"dense rows), got strides {t.stride()}")


def _ragged_call(q, k_pages, v_pages, block_tables, context_lens,
                 k_scales, v_scales, *, scale, window, variant=None,
                 splits=None, partials=False):
    """Launch the kernel on q [S, C, nh, d]: A' when the pools come with
    scales, else A, the variant and the splits of ``plan`` unless given
    (a sweep forces them).  Returns the output; with ``partials`` (more
    than one split), also the splits' fp32 partials as the merge read
    them, o [splits, S, C, nh, d], m and l [splits, S, C, nh] (a test's
    view of one split launch)."""
    global merge_launches
    quantized = k_scales is not None
    tensors = (q, k_pages, v_pages, block_tables, context_lens)
    if quantized:
        tensors += (k_scales, v_scales)
    device = q.device
    if not all(t.is_cuda and t.is_contiguous() and t.device == device
               for t in tensors):
        _refuse_placement(list(zip(
            ("q", "k_pages", "v_pages", "block_tables", "context_lens",
             "k_scales", "v_scales"), tensors)))
    S, C, nh, d = q.shape
    P, bs, g, dk = k_pages.shape
    if v_pages.shape != k_pages.shape or dk != d or nh % g:
        raise ValueError(f"pools {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if quantized:
        if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
            raise TypeError("pools that come with scales must be int8")
        for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
            if t.dtype != torch.float32 or t.shape != (P, bs, g):
                raise ValueError(f"{name} must be fp32 [P, bs, g] = "
                                 f"{(P, bs, g)}, got {t.dtype} "
                                 f"{tuple(t.shape)}")
    elif k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("q and the pools must share one dtype (or the "
                        "pools are int8 and come with scales)")
    if (block_tables.dtype != torch.int32
            or context_lens.dtype != torch.int32
            or block_tables.dim() != 2 or block_tables.shape[0] != S
            or context_lens.shape != (S,)):
        raise ValueError("block_tables [S, M] and context_lens [S] must be "
                         "int32")
    M = block_tables.shape[1]
    code = build.dtype_code(q)
    variant, _, _, planned = plan(q.dtype, S, C, nh, g, d, bs, M,
                                  quantized, build.sm_count(device),
                                  variant)
    if variant == "mma" and q.dtype == torch.float32:
        raise TypeError("the tensor-core kernel takes bf16 or fp16 q")
    splits = splits or planned
    if partials and splits < 2:
        raise ValueError("partials come from a launch of 2 splits or more")
    out = torch.empty_like(q)
    o_part = ml_part = None
    if splits > 1:
        # one fp32 scratch: o [splits, S, C, nh, d], then (m, l) a row
        rows = S * C * nh
        scratch = torch.empty(splits * rows * (d + 2), dtype=torch.float32,
                              device=device)
        o_part = scratch.data_ptr()
        ml_part = o_part + 4 * splits * rows * d
    rc = build.load_library().mlt_ragged_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if quantized else None,
        v_scales.data_ptr() if quantized else None,
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        o_part, ml_part, S, C, nh, g, d, bs, M, float(scale),
        -1 if window is None else int(window), splits,
        VARIANTS.index(variant), code, build.stream_handle(q))
    build.check_rc(rc, "ragged paged attention")
    variant_launches[variant] = variant_launches.get(variant, 0) + 1
    if splits == 1:
        return out
    merge_launches += 1
    if not partials:
        return out
    o = scratch[:splits * rows * d].view(splits, S, C, nh, d)
    ml = scratch[splits * rows * d:].view(splits, S, C, nh, 2)
    return out, o, ml[..., 0], ml[..., 1]


def _check_scales(k_scales, v_scales) -> None:
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales come together")


def _check_inference_only(*tensors) -> None:
    """The paged reads have no backward: an input that requires grad
    would silently cut the graph, so it is refused."""
    if any(t.requires_grad for t in tensors):
        raise ValueError("paged attention is inference-only: its inputs "
                         "must not require grad (run it under "
                         "torch.no_grad())")


def paged_attention_decode(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    *,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Ragged paged attention for one decode token per slot: q [S, nh, d]
    -> [S, nh, d] in q's dtype."""
    global decode_launches, quant_decode_launches
    _check_scales(k_scales, v_scales)
    _check_inference_only(q, k_pages, v_pages)
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"q [S, nh, d] and pools [P, bs, g, d], got "
                         f"{tuple(q.shape)} / {tuple(k_pages.shape)}")
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return _reference_paged_attention(
            q, k_pages, v_pages, block_tables, context_lens, k_scales,
            v_scales, softmax_scale, sliding_window)
    out = _ragged_call(q[:, None], k_pages, v_pages, block_tables,
                       context_lens, k_scales, v_scales,
                       scale=softmax_scale, window=sliding_window)[:, 0]
    if k_scales is None:
        decode_launches += 1
    else:
        quant_decode_launches += 1
    return out


def paged_attention_prefill(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    *,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
    block_q: Optional[int] = None,
) -> torch.Tensor:
    """Ragged paged attention for one prefill chunk per slot: q
    [S, C, nh, d] -> [S, C, nh, d].  Padded tail rows of a short final
    chunk are garbage in, garbage out (the engine reads only the last
    valid row).  ``block_q``, the JAX kernel's q-block, is kept only so
    that the signature stays the JAX package's: it must divide C as
    there, and changes nothing (the CUDA kernels tile the chunk's query
    rows by their own plan)."""
    global prefill_launches, quant_prefill_launches
    _check_scales(k_scales, v_scales)
    _check_inference_only(q, k_pages, v_pages)
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError(f"q [S, C, nh, d] and pools [P, bs, g, d], got "
                         f"{tuple(q.shape)} / {tuple(k_pages.shape)}")
    if block_q is not None and (block_q <= 0 or q.shape[1] % block_q):
        raise ValueError(f"block_q {block_q} must divide the chunk "
                         f"{q.shape[1]}")
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return _reference_paged_prefill(
            q, k_pages, v_pages, block_tables, context_lens, k_scales,
            v_scales, softmax_scale, sliding_window)
    out = _ragged_call(q, k_pages, v_pages, block_tables, context_lens,
                       k_scales, v_scales, scale=softmax_scale,
                       window=sliding_window)
    if k_scales is None:
        prefill_launches += 1
    else:
        quant_prefill_launches += 1
    return out
