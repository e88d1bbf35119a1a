"""Ragged paged attention for the serving engine: the CUDA kernel
``csrc/paged_attention.cu`` and its plain PyTorch version.

The counterpart of ``megatron_llm_tpu/ops/pallas/paged_attention.py``,
with the same two entries and arguments:

* ``paged_attention_decode`` — q ``[S, nh, d]``, one query token per
  slot, attending keys ``0..context_lens[s]``;
* ``paged_attention_prefill`` — q ``[S, C, nh, d]``, row ``j`` attending
  ``0..context_lens[s]+j`` (the chunk's own K/V already scattered into
  the pools).

Pools are ``[P, bs, g, d]`` (GQA when g < nh), ``block_tables`` ``[S, M]``
int32 with unowned entries pointing at the garbage block 0, and a
sliding window drops ``key_pos <= query_pos - window``.  A CPU tensor
takes the plain version (the port of ``_reference_paged_prefill``: a
dense gather of every slot's table, then masked fp32 softmax); a CUDA
tensor launches the kernel or raises.  int8 pools (``k_scales`` /
``v_scales``) are a later slice and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from megatron_llm_torch.ops.kernels import build

NEG_INF = -1e30
# query rows per block of the CUDA kernel for prefill: the default
# q-block holds this many (chunk row, head) rows, so the block's 4 warps
# split the keys of each page and a chunk spreads over C * qpg / 4
# blocks (more warps in flight to hide the shuffle and load latencies;
# chip_smoke.py times 1..64 rows per block at Llama-2-7B prefill)
_KERNEL_ROWS_PER_BLOCK = 4

# kernel launches through each entry since the last reset (plain
# counts; chip_smoke.py zeroes them before driving the serving path and
# reads them after)
decode_launches = 0
prefill_launches = 0


def _reference_paged_prefill(q, k_pages, v_pages, block_tables,
                             context_lens, scale, window):
    """Plain version: dense-gather chunked prefill in fp32; q
    [S, C, nh, d] -> [S, C, nh, d] in q's dtype."""
    S, C, nh, d = q.shape
    bs, g = k_pages.shape[1], k_pages.shape[2]
    M = block_tables.shape[1]
    qpg = nh // g
    bt = block_tables.long()
    k = k_pages[bt].reshape(S, M * bs, g, d).float()
    v = v_pages[bt].reshape(S, M * bs, g, d).float()
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
                               context_lens, scale, window):
    """Decode plain version: the C == 1 instance of the prefill one."""
    return _reference_paged_prefill(q[:, None], k_pages, v_pages,
                                    block_tables, context_lens, scale,
                                    window)[:, 0]


def _ragged_call(q, k_pages, v_pages, block_tables, context_lens, *,
                 scale, window, block_q):
    """Launch the kernel on q [S, C, nh, d] with block_q | C."""
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables),
                    ("context_lens", context_lens)):
        build.require_cuda(t, name)
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (the kernel reads "
                             f"dense rows), got strides {t.stride()}")
    S, C, nh, d = q.shape
    P, bs, g, dk = k_pages.shape
    if v_pages.shape != k_pages.shape or dk != d or nh % g:
        raise ValueError(f"pools {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("q and the pools must share one dtype")
    if (block_tables.dtype != torch.int32
            or context_lens.dtype != torch.int32
            or block_tables.dim() != 2 or block_tables.shape[0] != S
            or context_lens.shape != (S,)):
        raise ValueError("block_tables [S, M] and context_lens [S] must be "
                         "int32")
    if d not in (32, 64, 128, 256):
        raise ValueError(f"head_dim must be 32, 64, 128 or 256, got {d}")
    if C % block_q:
        raise ValueError(f"block_q {block_q} must divide the chunk {C}")
    code = build.dtype_code(q)
    out = torch.empty_like(q)
    lib = build.load_library()
    rc = lib.mlt_ragged_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        S, C, nh, g, d, bs, block_tables.shape[1], block_q, float(scale),
        -1 if window is None else int(window), code,
        build.stream_handle(q))
    build.check_rc(rc, "ragged paged attention")
    return out


def _check_unported(k_scales, v_scales) -> None:
    if k_scales is not None or v_scales is not None:
        raise NotImplementedError(
            "int8 KV pools are not ported yet (the quantized variant of "
            "the ragged kernel is a later slice)")


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
    global decode_launches
    _check_unported(k_scales, v_scales)
    _check_inference_only(q, k_pages, v_pages)
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"q [S, nh, d] and pools [P, bs, g, d], got "
                         f"{tuple(q.shape)} / {tuple(k_pages.shape)}")
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return _reference_paged_attention(
            q, k_pages, v_pages, block_tables, context_lens, softmax_scale,
            sliding_window)
    out = _ragged_call(q[:, None], k_pages, v_pages, block_tables,
                       context_lens, scale=softmax_scale,
                       window=sliding_window, block_q=1)[:, 0]
    decode_launches += 1
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
    valid row)."""
    global prefill_launches
    _check_unported(k_scales, v_scales)
    _check_inference_only(q, k_pages, v_pages)
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError(f"q [S, C, nh, d] and pools [P, bs, g, d], got "
                         f"{tuple(q.shape)} / {tuple(k_pages.shape)}")
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return _reference_paged_prefill(
            q, k_pages, v_pages, block_tables, context_lens, softmax_scale,
            sliding_window)
    C, nh = q.shape[1], q.shape[2]
    qpg = max(nh // k_pages.shape[2], 1)
    bq = min(block_q or max(_KERNEL_ROWS_PER_BLOCK // qpg, 1), C)
    while C % bq:       # q-blocks tile the chunk exactly
        bq -= 1
    out = _ragged_call(q, k_pages, v_pages, block_tables, context_lens,
                       scale=softmax_scale, window=sliding_window,
                       block_q=bq)
    prefill_launches += 1
    return out
