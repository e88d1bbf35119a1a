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
HEAD_DIMS = (64, 128)

# kernel launches since the last reset (plain counts; chip_smoke.py zeroes
# them before driving the training path and reads them after).  One H
# launch is one call of the two-pass backward (its dQ pass, then its
# dK/dV pass).
fwd_launches = 0
bwd_fused_launches = 0
bwd_launches = 0


def uses_fused_backward(sq: int, sk: int) -> bool:
    """G for lengths that are multiples of the backward tile, else H."""
    return sq % BWD_BLOCK == 0 and sk % BWD_BLOCK == 0


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
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dk = torch.empty((b, sk, ng, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, sk, ng, d), dtype=v.dtype, device=v.device)
    fused = uses_fused_backward(sq, sk)
    if fused:
        dq = torch.zeros((b, sq, nh, d), dtype=torch.float32,
                         device=q.device)
    else:
        dq = torch.empty((b, sq, nh, d), dtype=q.dtype, device=q.device)
    lib = build.load_library()
    rc = lib.mlt_flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                           dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                           _strides(q, k, v, do), b, sq, sk, nh, ng, d,
                           float(scale), int(causal), _window_arg(window),
                           int(fused), code, build.stream_handle(q))
    build.check_rc(rc, "flash attention backward")
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
