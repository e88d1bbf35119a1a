"""Flash attention for training: the CUDA kernels
``csrc/flash_attention.cu`` and their plain PyTorch versions.

The counterpart of ``megatron_llm_tpu/ops/pallas/flash_attention.py``:

* F, the forward (``_fwd_kernel``): o and the per-row log-sum-exp;
* G, the fused backward (``_bwd_fused_kernel``): dq, dk, dv in one sweep;
* H, the two-pass backward (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``).

``flash_attention(q, k, v, *, causal, sliding_window, softmax_scale)``
takes q ``[b, s, nh, d]`` and k, v ``[b, s, ng, d]`` (GQA/MQA when
ng < nh) and is differentiable: an autograd function whose forward is F
and whose backward is G when both lengths are multiples of
``BWD_BLOCK``, else H (the shape alone decides, as ``_bwd_call`` does).
A CPU tensor takes the plain versions: ``_reference_attention`` (the JAX
package's, also returning the fp32 LSE) and ``_reference_attention_bwd``,
which applies the kernels' formulas (p = exp(s - lse), delta =
rowsum(dO * O), ds = p * (dp - delta)) rather than autograd of the plain
forward.  A CUDA tensor launches the kernels or raises.  A row that no
key reaches gives o = 0 and lse = NEG_INF, and a zero gradient.

The kernel variant is chosen by dtype and head_dim alone
(``kernel_variant``): bf16 takes the Hopper kernels (F, G at d 64 and
128, and H's dQ pass, on wgmma with a TMA ring; G at d 256 and H's dK/dV
pass on mma.sync with a cp.async ring), fp32 the CUDA-core kernels of
the checking path.  At MQA/GQA shapes the
backward splits each KV group's query heads over blocks
(``head_splits``) and sums the splits' fp32 partial dK/dV in a fixed
order.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from megatron_llm_torch.ops.kernels import build

NEG_INF = -1e30
# the backward tile the G/H choice keys on: the fused kernel takes
# lengths that are multiples of it (the JAX package's condition for its
# fused kernel, whose dq slab needs complete q-blocks)
BWD_BLOCK = 64
HEAD_DIMS = (64, 128, 256)

# Tile shapes (rows of q, rows of k) of the kernels, by dtype and head_dim:
# the forward, G, H's dQ pass and H's dK/dV pass.  The same table as
# ``mlt_flash_tiles`` in csrc/flash_attention.cu (each kernel's shared
# memory fits the card's 227 KB at its head_dim); the backward's head
# split reads the k-tile of its dK/dV kernel.
TILES = {
    (torch.bfloat16, 64): ((128, 128), (64, 128), (128, 64), (64, 64)),
    (torch.bfloat16, 128): ((128, 128), (64, 64), (128, 64), (64, 64)),
    (torch.bfloat16, 256): ((128, 64), (64, 32), (64, 64), (64, 32)),
    (torch.float32, 64): ((32, 32),) * 4,
    (torch.float32, 128): ((32, 32),) * 4,
    (torch.float32, 256): ((16, 16),) * 4,
}

# kernel launches since the last reset (plain counts; chip_smoke.py zeroes
# them before driving the training path and reads them after).  One H
# launch is one call of the two-pass backward (its dQ pass, then its
# dK/dV pass).  ``variant_launches`` counts the same launches by
# ``kernel_variant``.
fwd_launches = 0
bwd_fused_launches = 0
bwd_launches = 0
variant_launches: dict = {}


def uses_fused_backward(sq: int, sk: int) -> bool:
    """G for lengths that are multiples of the backward tile, else H."""
    return sq % BWD_BLOCK == 0 and sk % BWD_BLOCK == 0


def kernel_variant(dtype: torch.dtype, d: int, kind: str) -> str:
    """The kernel a CUDA call of ``kind`` ("fwd", "fused" for G,
    "two_pass" for H) takes for this dtype and head_dim:

    * bf16: "fwd_bf16_wgmma" (F: wgmma, TMA ring, warp-specialised);
      "bwd_fused_bf16_wgmma" (G at d 64 and 128: wgmma, TMA ring, dK/dV
      in registers) or "bwd_fused_bf16_mma" (G at d 256: mma.sync,
      cp.async ring, dK/dV in registers); "bwd_two_pass_bf16_wgmma" (H:
      the dQ pass on wgmma with a TMA ring and dQ in registers, then the
      mma.sync dK/dV kernel);
    * fp32: "fwd_fp32", "bwd_fused_fp32", "bwd_two_pass_fp32" (CUDA-core
      products between shared-memory tiles).

    Raises for a dtype or head_dim that no kernel takes."""
    if kind not in ("fwd", "fused", "two_pass"):
        raise ValueError(f"unknown flash attention pass {kind!r}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim must be one of {HEAD_DIMS}, got {d}")
    tag = {torch.bfloat16: "bf16", torch.float32: "fp32"}.get(dtype)
    if tag is None:
        raise TypeError(f"the flash kernels take float32 or bfloat16, got "
                        f"{dtype}")
    if kind == "fwd":
        return f"fwd_{tag}" + ("_wgmma" if tag == "bf16" else "")
    if kind == "fused":
        if tag == "fp32":
            return "bwd_fused_fp32"
        return "bwd_fused_bf16_" + ("mma" if d == 256 else "wgmma")
    return f"bwd_two_pass_{tag}" + ("_wgmma" if tag == "bf16" else "")


def head_splits(b: int, sk: int, ng: int, qpg: int, block_k: int,
                sm_count: int) -> int:
    """How many blocks share one KV group's query heads in the backward's
    dK/dV grid: enough that the grid (k-tiles x groups x batch x splits)
    covers two waves of the card's SMs, at most one head a split.  MHA at
    training lengths keeps 1; Falcon-7B in bf16 (16 k-tiles of 128 keys x
    1 group) takes 17."""
    blocks = b * ng * -(-sk // block_k)
    return max(1, min(qpg, -(-2 * sm_count // blocks)))


def _count(variant: str) -> None:
    variant_launches[variant] = variant_launches.get(variant, 0) + 1


def _visible(sq: int, sk: int, causal: bool, window: Optional[int],
             device) -> torch.Tensor:
    """[sq, sk] bool: key k is visible to query q."""
    q = torch.arange(sq, device=device)[:, None]
    k = torch.arange(sk, device=device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        ok &= k <= q
    if window is not None:
        ok &= k > q - window
    return ok


def _reference_attention(q, k, v, causal, sliding_window, softmax_scale
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward: (o [b, sq, nh, d] in v's dtype, lse [b, nh, sq]
    fp32).  Scores in the inputs' dtype, softmax in fp32, probabilities
    cast to v's dtype for the PV product, as in the JAX package."""
    b, sq, nh, d = q.shape
    sk, ng = k.shape[1], k.shape[2]
    qpg = nh // ng
    qg = q.reshape(b, sq, ng, qpg, d)
    scores = torch.einsum("bsgpd,btgd->bgpst", qg, k).float() * softmax_scale
    vis = _visible(sq, sk, causal, sliding_window, q.device)
    scores = scores.masked_fill(~vis, NEG_INF)
    reached = vis.any(dim=-1)                                    # [sq]
    probs = torch.softmax(scores, dim=-1) * reached[:, None]
    lse = torch.where(reached, torch.logsumexp(scores, dim=-1),
                      torch.tensor(NEG_INF, device=q.device))
    ctx = torch.einsum("bgpst,btgd->bsgpd", probs.to(v.dtype), v)
    return ctx.reshape(b, sq, nh, d), lse.reshape(b, nh, sq)


def _reference_attention_bwd(q, k, v, o, lse, do, causal, sliding_window,
                             softmax_scale):
    """Plain backward in fp32: (dq, dk, dv) in the inputs' dtypes."""
    b, sq, nh, d = q.shape
    sk, ng = k.shape[1], k.shape[2]
    qpg = nh // ng
    qg = q.float().reshape(b, sq, ng, qpg, d)
    dog = do.float().reshape(b, sq, ng, qpg, d)
    kf, vf = k.float(), v.float()
    vis = _visible(sq, sk, causal, sliding_window, q.device)
    s = torch.einsum("bsgpd,btgd->bgpst", qg, kf) * softmax_scale
    lse_g = lse.reshape(b, ng, qpg, sq, 1)
    p = torch.where(vis, torch.exp(torch.where(vis, s - lse_g, 0.0)), 0.0)
    delta = (do.float() * o.float()).sum(-1)                     # [b, sq, nh]
    delta_g = delta.reshape(b, sq, ng, qpg).permute(0, 2, 3, 1)[..., None]
    dp = torch.einsum("bsgpd,btgd->bgpst", dog, vf)
    ds = p * (dp - delta_g)
    dq = torch.einsum("bgpst,btgd->bsgpd", ds, kf) * softmax_scale
    dk = torch.einsum("bgpst,bsgpd->btgd", ds, qg) * softmax_scale
    dv = torch.einsum("bgpst,bsgpd->btgd", p, dog)
    return (dq.reshape(b, sq, nh, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _k_tile_range(sk: int, q0: int, br: int, bc: int, causal: bool,
                  window: Optional[int]) -> Tuple[int, int]:
    """First and last k-tile of ``bc`` keys that the causal band and the
    window let the q-tile of ``br`` rows at ``q0`` reach (the kernels'
    ``k_tile_range``)."""
    lo, hi = 0, (sk - 1) // bc
    if causal:
        hi = min(hi, (q0 + br - 1) // bc)
    if window is not None:
        lo = max(0, q0 - window + 1) // bc
    return lo, hi


def _dq_walk(sq: int, sk: int, d: int, causal: bool,
             window: Optional[int]):
    """H's bf16 dQ pass as its blocks walk it: (q0, q1, k-tiles) for each
    q-tile of rows [q0, q1), with its tile from ``TILES`` (the last tile
    ragged)."""
    br, bc = TILES[(torch.bfloat16, d)][2]
    walk = []
    for q0 in range(0, sq, br):
        lo, hi = _k_tile_range(sk, q0, br, bc, causal, window)
        walk.append((q0, min(q0 + br, sq),
                     [(k0, min(k0 + bc, sk))
                      for k0 in range(lo * bc, (hi + 1) * bc, bc)]))
    return walk


def _reference_dq_tiles(q, k, v, o, lse, do, causal, window,
                        softmax_scale):
    """Plain dq in fp32 along the dQ pass's walk (``_dq_walk``): for each
    q-tile, p = exp(s * scale - lse) over the visible pairs of each k-tile
    it reaches, ds = p * (dp - delta), dq = scale * sum ds k; a row no key
    reaches keeps dq = 0.  Returns dq in q's dtype."""
    b, sq, nh, d = q.shape
    sk, ng = k.shape[1], k.shape[2]
    qpg = nh // ng
    qf, dof = q.float(), do.float()
    kf, vf = k.float(), v.float()
    delta = (dof * o.float()).sum(-1)                            # [b, sq, nh]
    dq = torch.zeros((b, sq, nh, d), dtype=torch.float32, device=q.device)
    for q0, q1, ktiles in _dq_walk(sq, sk, d, causal, window):
        qg = qf[:, q0:q1].reshape(b, q1 - q0, ng, qpg, d)
        dog = dof[:, q0:q1].reshape(b, q1 - q0, ng, qpg, d)
        lse_t = lse[:, :, q0:q1].reshape(b, ng, qpg, q1 - q0, 1)
        dl = delta[:, q0:q1].reshape(b, q1 - q0, ng, qpg)
        dl = dl.permute(0, 2, 3, 1)[..., None]
        acc = torch.zeros_like(qg)
        for k0, k1 in ktiles:
            vis = _visible(sq, sk, causal, window, q.device)[q0:q1, k0:k1]
            s = torch.einsum("bsgpd,btgd->bgpst", qg, kf[:, k0:k1])
            p = torch.where(vis, torch.exp(torch.where(
                vis, s * softmax_scale - lse_t, 0.0)), 0.0)
            dp = torch.einsum("bsgpd,btgd->bgpst", dog, vf[:, k0:k1])
            ds = p * (dp - dl)
            acc += torch.einsum("bgpst,btgd->bsgpd", ds, kf[:, k0:k1])
        dq[:, q0:q1] = (acc * softmax_scale).reshape(b, q1 - q0, nh, d)
    return dq.to(q.dtype)


def _split_head_ranges(qpg: int, splits: int):
    """The query heads [lo, hi) within a group that each split owns (the
    kernels' ``split_heads``)."""
    return [(i * qpg // splits, (i + 1) * qpg // splits)
            for i in range(splits)]


def _reference_dkv_partials(q, k, v, o, lse, do, causal, sliding_window,
                            softmax_scale, splits):
    """Plain per-split dK, dV in fp32: [splits, 2, b, sk, ng, d], split i
    holding the contribution of the query heads ``_split_head_ranges``
    gives it in every group, as the split kernels write them."""
    b, sq, nh, d = q.shape
    ng = k.shape[2]
    qpg = nh // ng
    parts = []
    for lo, hi in _split_head_ranges(qpg, splits):
        heads = torch.tensor([gi * qpg + j for gi in range(ng)
                              for j in range(lo, hi)], device=q.device)
        _, dk, dv = _reference_attention_bwd(
            q.float()[:, :, heads], k.float(), v.float(),
            o.float()[:, :, heads], lse[:, heads], do.float()[:, :, heads],
            causal, sliding_window, softmax_scale)
        parts.append(torch.stack((dk, dv)))
    return torch.stack(parts)


def _sum_splits(parts: torch.Tensor) -> torch.Tensor:
    """The splits' partials added in split order (flash_dkv_sum_kernel's
    order): [splits, ...] -> [...]."""
    acc = parts[0].clone()
    for p in parts[1:]:
        acc += p
    return acc


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(q, k, v) -> int:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError("q, k and v must share one dtype")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash attention takes q [b, s, nh, d] and k, v "
                         f"[b, s, ng, d], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, nh, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or nh % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim must be one of {HEAD_DIMS}, got {d}")
    code = build.dtype_code(q)
    _check_layout(q, "q")
    _check_layout(k, "k")
    _check_layout(v, "v")
    return code


def _readable(t: torch.Tensor) -> bool:
    """The kernels read [b, s, heads, d] through the batch, sequence and
    head strides, 16 bytes at a time: the head axis must be contiguous
    and every row 16-byte aligned."""
    vec = 16 // t.element_size()
    return (t.stride(-1) == 1 and not any(st % vec for st in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def _check_layout(t: torch.Tensor, name: str) -> None:
    if not _readable(t):
        raise ValueError(f"{name} needs a contiguous head axis and 16-byte "
                         f"aligned rows, got strides {t.stride()}")


def _strides(*tensors) -> ctypes.Array:
    vals = []
    for t in tensors:
        vals += list(t.stride()[:3]) if t is not None else [0, 0, 0]
    return (ctypes.c_longlong * 12)(*vals)


def _window_arg(window: Optional[int]) -> int:
    return -1 if window is None else int(window)


def flash_attention_fwd_kernel(q, k, v, causal: bool,
                               window: Optional[int], scale: float):
    """Launch F; returns (o [b, sq, nh, d], lse [b, nh, sq] fp32)."""
    global fwd_launches
    code = _check(q, k, v)
    b, sq, nh, d = q.shape
    sk, ng = k.shape[1], k.shape[2]
    o = torch.empty((b, sq, nh, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, nh, sq), dtype=torch.float32, device=q.device)
    if b == 0 or sq == 0 or sk == 0:
        return o.zero_(), lse.fill_(NEG_INF)
    lib = build.load_library()
    rc = lib.mlt_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           o.data_ptr(), lse.data_ptr(),
                           _strides(q, k, v, None), b, sq, sk, nh, ng, d,
                           float(scale), int(causal), _window_arg(window),
                           code, build.stream_handle(q))
    build.check_rc(rc, "flash attention forward")
    fwd_launches += 1
    _count(kernel_variant(q.dtype, d, "fwd"))
    return o, lse


def flash_attention_bwd_kernel(q, k, v, o, lse, do, causal: bool,
                               window: Optional[int], scale: float):
    """Launch G or H (by shape); returns (dq, dk, dv) in the inputs'
    dtype."""
    global bwd_fused_launches, bwd_launches
    code = _check(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or o.shape != q.shape:
        raise ValueError("do and o must match q")
    _check_layout(do, "do")
    b, sq, nh, d = q.shape
    sk, ng = k.shape[1], k.shape[2]
    if lse.shape != (b, nh, sq) or lse.dtype != torch.float32:
        raise ValueError("lse must be the forward's [b, nh, sq] fp32")
    lse = lse.contiguous()
    o = o.contiguous()
    dev = q.device
    # delta = rowsum(dO * O) is computed by the kernels' pre-pass, which
    # also zeroes G's fp32 dq buffer
    delta = torch.empty((b, nh, sq), dtype=torch.float32, device=dev)
    dk = torch.empty((b, sk, ng, d), dtype=k.dtype, device=dev)
    dv = torch.empty((b, sk, ng, d), dtype=v.dtype, device=dev)
    fused = uses_fused_backward(sq, sk)
    dq = torch.empty((b, sq, nh, d),
                     dtype=torch.float32 if fused else q.dtype, device=dev)
    splits = head_splits(b, sk, ng, nh // ng,
                         TILES[(q.dtype, d)][1 if fused else 3][1],
                         build.sm_count(dev))
    part = (torch.empty((splits, 2, b, sk, ng, d), dtype=torch.float32,
                        device=dev) if splits > 1 else None)
    lib = build.load_library()
    rc = lib.mlt_flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                           delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                           dv.data_ptr(),
                           part.data_ptr() if part is not None else None,
                           _strides(q, k, v, do), b, sq, sk, nh, ng, d,
                           float(scale), int(causal), _window_arg(window),
                           int(fused), splits, code, build.stream_handle(q))
    build.check_rc(rc, "flash attention backward")
    _count(kernel_variant(q.dtype, d, "fused" if fused else "two_pass"))
    if fused:
        bwd_fused_launches += 1
        dq = dq.to(q.dtype)
    else:
        bwd_launches += 1
    return dq, dk, dv


def flash_attention_fwd(q, k, v, causal: bool, window: Optional[int],
                        scale: float):
    """The plain forward for CPU tensors, F for CUDA ones."""
    if q.device.type == "cpu":
        return _reference_attention(q, k, v, causal, window, scale)
    return flash_attention_fwd_kernel(q, k, v, causal, window, scale)


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool,
                        window: Optional[int], scale: float):
    """The plain backward for CPU tensors, G or H for CUDA ones."""
    if q.device.type == "cpu":
        return _reference_attention_bwd(q, k, v, o, lse, do, causal, window,
                                        scale)
    return flash_attention_bwd_kernel(q, k, v, o, lse, do, causal, window,
                                      scale)


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` as is when the kernels can read it through its strides, else
    a contiguous copy (only the layout changes; CPU tensors pass)."""
    if t.device.type == "cpu" or _readable(t):
        return t
    return t.contiguous()


class _FlashAttention(torch.autograd.Function):
    """Forward: F, saving (q, k, v, o, lse).  Backward: G or H (the
    ``_flash_fwd`` / ``_flash_bwd`` pair of the JAX package)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        q, k, v = (_kernel_layout(t) for t in (q, k, v))
        o, lse = flash_attention_fwd(q, k, v, causal, window, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = (causal, window, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, scale = ctx.opts
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse,
                                         _kernel_layout(do), causal, window,
                                         scale)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    sliding_window: Optional[int] = None,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q [b, s, nh, d]; k, v [b, s, ng, d] (GQA when ng < nh) ->
    [b, s, nh, d], differentiable in q, k and v."""
    if sliding_window is not None:
        if not causal:
            raise ValueError("a sliding window needs causal attention")
        if sliding_window < 1:
            raise ValueError(f"sliding_window must be >= 1, got "
                             f"{sliding_window}")
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, bool(causal), sliding_window,
                                 float(softmax_scale))
