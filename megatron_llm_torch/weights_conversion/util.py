"""Weight-layout transforms shared by the port's HF <-> Megatron
converters (a copy of the repo's ``weights_conversion/util.py``).

Reference: ``weights_conversion/hf_to_megatron.py:117-258`` (rotary QKV
permutation + GQA packing) and ``megatron_to_hf.py:47-79`` (inverse).

Layout facts:

* HF applies RoPE with rotate-half (feature halves), Meta/this framework
  with interleaved even/odd pairs — converting requires permuting the
  rows of the q/k projections per head: meta_row[2p + h] = hf_row[p + h*d/2].
* This framework packs QKV column-parallel in Megatron's grouped-GQA
  layout ``[ng, q_per_group + 2, d]`` over the output dim
  (models/transformer.py:_qkv_out_dim), kernels stored [in, out]
  (HF Linear stores [out, in]).
"""

from __future__ import annotations

import numpy as np


def rotary_hf_to_interleaved(w: np.ndarray, head_dim: int) -> np.ndarray:
    """Permute rows of an HF q/k projection [n_heads*d, hidden] from
    rotate-half to interleaved layout."""
    out_dim, hidden = w.shape
    n_heads = out_dim // head_dim
    w = w.reshape(n_heads, 2, head_dim // 2, hidden)
    w = np.transpose(w, (0, 2, 1, 3))  # [nh, d/2, 2, hid]
    return w.reshape(out_dim, hidden)


def rotary_interleaved_to_hf(w: np.ndarray, head_dim: int) -> np.ndarray:
    """Inverse of rotary_hf_to_interleaved."""
    out_dim, hidden = w.shape
    n_heads = out_dim // head_dim
    w = w.reshape(n_heads, head_dim // 2, 2, hidden)
    w = np.transpose(w, (0, 2, 1, 3))  # [nh, 2, d/2, hid]
    return w.reshape(out_dim, hidden)


def pack_qkv(
    q: np.ndarray, k: np.ndarray, v: np.ndarray,
    num_heads: int, num_kv_heads: int, head_dim: int,
) -> np.ndarray:
    """[*, hidden] HF projections -> packed grouped kernel [hidden, qkv_out].

    q: [nh*d, hid], k/v: [ng*d, hid] ->
    kernel [hid, ng*(qpg+2)*d] with per-group [q_0..q_{qpg-1}, k, v].
    """
    ng, qpg = num_kv_heads, num_heads // num_kv_heads
    d = head_dim
    hid = q.shape[1]
    qg = q.reshape(ng, qpg, d, hid)
    kg = k.reshape(ng, 1, d, hid)
    vg = v.reshape(ng, 1, d, hid)
    packed = np.concatenate([qg, kg, vg], axis=1)  # [ng, qpg+2, d, hid]
    packed = packed.reshape(ng * (qpg + 2) * d, hid)
    return np.ascontiguousarray(packed.T)  # [hid, out]


def unpack_qkv(
    kernel: np.ndarray, num_heads: int, num_kv_heads: int, head_dim: int,
):
    """Inverse of pack_qkv: kernel [hid, out] -> (q, k, v) HF-shaped
    [*, hidden]."""
    ng, qpg = num_kv_heads, num_heads // num_kv_heads
    d = head_dim
    hid = kernel.shape[0]
    w = np.ascontiguousarray(kernel.T).reshape(ng, qpg + 2, d, hid)
    q = w[:, :qpg].reshape(ng * qpg * d, hid)
    k = w[:, qpg].reshape(ng * d, hid)
    v = w[:, qpg + 1].reshape(ng * d, hid)
    return q, k, v


def pack_glu_ffn(gate: np.ndarray, up: np.ndarray) -> np.ndarray:
    """HF gate_proj/up_proj [ffn, hid] -> dense_h_to_4h kernel
    [hid, 2*ffn] with (a=gate | b=up) halves matching
    ops/activations.swiglu's chunk order."""
    return np.ascontiguousarray(np.concatenate([gate, up], axis=0).T)


def unpack_glu_ffn(kernel: np.ndarray):
    w = np.ascontiguousarray(kernel.T)
    ffn = w.shape[0] // 2
    return w[:ffn], w[ffn:]


def rotary_hf_to_interleaved_bias(b: np.ndarray, head_dim: int) -> np.ndarray:
    """Bias analogue of ``rotary_hf_to_interleaved`` ([out_dim] vector)."""
    return rotary_hf_to_interleaved(b[:, None], head_dim)[:, 0]


def pack_qkv_bias(
    qb: np.ndarray, kb: np.ndarray, vb: np.ndarray,
    num_heads: int, num_kv_heads: int, head_dim: int,
) -> np.ndarray:
    """Bias analogue of ``pack_qkv``: [*] vectors -> packed
    [ng*(qpg+2)*d] matching the grouped kernel column order."""
    ng, qpg = num_kv_heads, num_heads // num_kv_heads
    d = head_dim
    qg = qb.reshape(ng, qpg, d)
    kg = kb.reshape(ng, 1, d)
    vg = vb.reshape(ng, 1, d)
    return np.ascontiguousarray(
        np.concatenate([qg, kg, vg], axis=1).reshape(ng * (qpg + 2) * d))


def rotary_interleaved_to_hf_bias(b: np.ndarray, head_dim: int) -> np.ndarray:
    """Inverse of ``rotary_hf_to_interleaved_bias``."""
    return rotary_interleaved_to_hf(b[:, None], head_dim)[:, 0]


def unpack_qkv_bias(
    packed: np.ndarray, num_heads: int, num_kv_heads: int, head_dim: int,
):
    """Inverse of ``pack_qkv_bias``: [ng*(qpg+2)*d] -> (qb, kb, vb)."""
    ng, qpg = num_kv_heads, num_heads // num_kv_heads
    d = head_dim
    w = packed.reshape(ng, qpg + 2, d)
    qb = w[:, :qpg].reshape(ng * qpg * d)
    kb = w[:, qpg].reshape(ng * d)
    vb = w[:, qpg + 1].reshape(ng * d)
    return qb, kb, vb
