"""Transformer core: attention (flash attention for the no-cache
forward, the paged KV branch of the serving engine), MLP, pre-LN layer
and the layer stack, for inference and single-device training.

The counterpart of ``megatron_llm_tpu/models/transformer.py``, with its
layouts: activations ``[b, s, ...]``, the packed grouped QKV projection
``[ng, q_per_group + 2, d]``, per-layer params stacked on a leading
``[num_layers]`` axis, and page pools ``[P, bs, g, d]``.  The stack is a
Python loop over the layers (the JAX package scans it); each forward
unbinds the stacked params once, so the backward stacks each leaf's
layer grads once.  Dropout in training, recompute and the chunked
attention of long unfused sequences are later slices and raise
``NotImplementedError``.

The JAX package's paged branch is functional: it returns fresh pools.
Here the scatter writes into the pools in place, which saves copying a
whole pool per layer per step; the returned cache dicts hold the same
tensors.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from megatron_llm_torch.config import PositionEmbeddingType, TransformerConfig
from megatron_llm_torch.ops.activations import apply_mlp_activation
from megatron_llm_torch.ops.kernels.flash_attention import flash_attention
from megatron_llm_torch.ops.kernels.paged_attention import (
    paged_attention_decode,
    paged_attention_prefill,
)
from megatron_llm_torch.ops.layernorm import apply_norm, init_norm_params
from megatron_llm_torch.ops.rope import apply_rotary_emb, precompute_freqs_cis
from megatron_llm_torch.ops.softmax import (
    causal_mask,
    fused_scale_mask_softmax,
    sliding_window_mask,
)
from megatron_llm_torch.parallel.layers import (
    column_parallel_linear,
    init_linear_params,
    init_method_for,
    row_parallel_linear,
    scaled_init_method_normal,
)
from megatron_llm_torch.tree import tree_map

# the JAX package routes a flash-eligible unfused attention at least this
# long to its q-chunked XLA path (ops/chunked_attention.py), not ported
CHUNKED_ATTENTION_MIN_SEQ = 4096


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _qkv_out_dim(cfg: TransformerConfig) -> int:
    ng = cfg.num_query_groups
    qpg = cfg.num_attention_heads // ng
    return ng * (qpg + 2) * cfg.head_dim


def _out_init(cfg: TransformerConfig):
    if cfg.use_scaled_init_method:
        return scaled_init_method_normal(cfg.init_method_std, cfg.num_layers)
    return init_method_for(cfg)


def init_attention_params(generator, cfg: TransformerConfig, dtype,
                          device=None):
    init = init_method_for(cfg)
    return {
        "query_key_value": init_linear_params(
            generator, cfg.hidden_size, _qkv_out_dim(cfg),
            bias=cfg.add_bias_linear or cfg.add_qkv_bias,
            init_method=init, dtype=dtype, device=device),
        "dense": init_linear_params(
            generator, cfg.num_attention_heads * cfg.head_dim,
            cfg.hidden_size, bias=cfg.add_bias_linear,
            init_method=_out_init(cfg), dtype=dtype, device=device),
    }


def init_mlp_params(generator, cfg: TransformerConfig, dtype, device=None):
    mult = 2 if cfg.glu_activation else 1
    return {
        "dense_h_to_4h": init_linear_params(
            generator, cfg.hidden_size, mult * cfg.ffn_hidden_size,
            bias=cfg.add_bias_linear, init_method=init_method_for(cfg),
            dtype=dtype, device=device),
        "dense_4h_to_h": init_linear_params(
            generator, cfg.ffn_hidden_size, cfg.hidden_size,
            bias=cfg.add_bias_linear, init_method=_out_init(cfg),
            dtype=dtype, device=device),
    }


def init_layer_params(generator, cfg: TransformerConfig, dtype, device=None):
    """One pre-LN decoder layer: input_norm, attention,
    post_attention_norm, mlp."""
    return {
        "input_norm": init_norm_params(cfg.hidden_size, cfg.normalization,
                                       dtype, device),
        "attention": init_attention_params(generator, cfg, dtype, device),
        "mlp": init_mlp_params(generator, cfg, dtype, device),
        "post_attention_norm": init_norm_params(
            cfg.hidden_size, cfg.normalization, dtype, device),
    }


def init_stack_params(generator, cfg: TransformerConfig, dtype,
                      device=None):
    """Layer-stacked params: every leaf gets a leading [num_layers] axis.
    Each layer is drawn and copied into the stacked tensors in turn, so
    the peak is one layer above the final size."""
    L = cfg.num_layers
    layers = None
    for i in range(L):
        lp = init_layer_params(generator, cfg, dtype, device)
        if layers is None:
            layers = tree_map(lambda t: torch.empty(
                (L,) + tuple(t.shape), dtype=t.dtype, device=t.device), lp)
        tree_map(lambda dst, src: dst[i].copy_(src), layers, lp)
    return {
        "layers": layers,
        "final_norm": init_norm_params(cfg.hidden_size, cfg.normalization,
                                       dtype, device),
    }


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _split_qkv(mixed: torch.Tensor, cfg: TransformerConfig):
    """mixed [b, s, ng*(qpg+2)*d] in Megatron's grouped layout ->
    q [b, s, nh, d], k [b, s, ng, d], v [b, s, ng, d]."""
    b, s, _ = mixed.shape
    ng = cfg.num_query_groups
    qpg = cfg.num_attention_heads // ng
    d = cfg.head_dim
    mixed = mixed.reshape(b, s, ng, qpg + 2, d)
    q = mixed[:, :, :, :qpg, :].reshape(b, s, ng * qpg, d)
    k = mixed[:, :, :, qpg, :]
    v = mixed[:, :, :, qpg + 1, :]
    return q, k, v


def core_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   cfg: TransformerConfig,
                   attention_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Unfused attention: scaled QK^T -> masked softmax -> PV, with GQA
    contracting group-shared K/V.  ``attention_mask`` [b, 1, sq, sk] bool
    (True = masked); None applies the causal (+ window) mask."""
    b, sq, nh, d = q.shape
    ng = k.shape[2]
    qpg = nh // ng
    sk = k.shape[1]
    qg = q.reshape(b, sq, ng, qpg, d)
    scores = torch.einsum("bsgpd,btgd->bgpst", qg, k)
    if attention_mask is None:
        if cfg.sliding_window_size is not None:
            mask = sliding_window_mask(sq, sk, cfg.sliding_window_size,
                                       device=q.device)
        else:
            mask = causal_mask(sq, sk, device=q.device)
        mask = mask[None, None, None]
    else:
        mask = attention_mask[:, :, None]
    probs = fused_scale_mask_softmax(
        scores, mask, scale=1.0 / math.sqrt(d),
        softmax_in_fp32=cfg.attention_softmax_in_fp32)
    ctx = torch.einsum("bgpst,btgd->bsgpd", probs.to(v.dtype), v)
    return ctx.reshape(b, sq, nh, d)


def _paged_scatter(kv_cache: dict, k: torch.Tensor, v: torch.Tensor,
                   dest: torch.Tensor) -> dict:
    """Write the chunk's K/V rows into the page pools, in place, at flat
    positions ``dest`` ([b, n] indices into the [P*bs] position axis).
    Returns the pages-only cache dict."""
    out = {}
    flat_dest = dest.reshape(-1)
    for name, val in (("k_pages", k), ("v_pages", v)):
        pool = kv_cache[name]
        P, bs = pool.shape[:2]
        flat = pool.view((P * bs,) + tuple(pool.shape[2:]))
        flat[flat_dest] = val.reshape((-1,) + tuple(pool.shape[2:])).to(
            pool.dtype)
        out[name] = pool
    return out


def attention(x: torch.Tensor, params, cfg: TransformerConfig, *,
              freqs: Optional[tuple], attention_mask: Optional[torch.Tensor],
              position_ids: Optional[torch.Tensor],
              kv_cache: Optional[dict] = None, train: bool = False):
    """QKV projection, RoPE, attention, output projection.  With a paged
    ``kv_cache`` (pools plus block_tables / context_lens / valid_lens)
    returns ``(out, new_cache)``."""
    cdt = cfg.compute_torch_dtype
    mixed = column_parallel_linear(x, params["query_key_value"],
                                   compute_dtype=cdt)
    q, k, v = _split_qkv(mixed, cfg)
    if (cfg.position_embedding_type == PositionEmbeddingType.rotary
            and freqs is not None):
        cos, sin = freqs
        q = apply_rotary_emb(q, cos, sin, position_ids)
        k = apply_rotary_emb(k, cos, sin, position_ids)

    new_cache = None
    ctx = None
    if kv_cache is not None:
        if "k_pages" not in kv_cache:
            raise NotImplementedError(
                "only the paged KV cache of the serving engine is ported "
                "(linear, rolling and int8 caches are later slices)")
        # PAGED cache: one pool of [P, bs] pages per layer shared by all
        # slots; row s of the batch (a serving slot) reads and writes
        # through its block table.  Padded and inactive tokens
        # (j >= valid_lens) write to the garbage block 0.  The read is
        # ops/kernels/paged_attention.py: the decode entry for one token
        # per slot, the prefill entry for a chunk (the CUDA kernel on a
        # CUDA tensor, its plain version on a CPU one).  The JAX package's
        # dense-gather branch and its kernel on/off switches are not
        # ported: on the card every paged read is the kernel.
        bt = kv_cache["block_tables"]
        ctx_lens = kv_cache["context_lens"]
        vlen = kv_cache["valid_lens"]
        P, bs = kv_cache["k_pages"].shape[:2]
        M = bt.shape[1]
        n = k.shape[1]
        d = k.shape[3]
        j = torch.arange(n, device=x.device)[None, :]
        pos = ctx_lens.long()[:, None] + j                   # [b, n]
        blk = torch.gather(bt.long(), 1, (pos // bs).clamp(0, M - 1))
        real = j < vlen.long()[:, None]
        dest = torch.where(real, blk * bs + pos % bs, pos % bs)
        dest = dest.clamp(0, P * bs - 1)
        new_cache = _paged_scatter(kv_cache, k, v, dest)
        kernel_kw = dict(softmax_scale=1.0 / math.sqrt(d),
                         sliding_window=cfg.sliding_window_size)
        kp, vp = new_cache["k_pages"], new_cache["v_pages"]
        if n == 1:
            ctx = paged_attention_decode(q[:, 0].contiguous(), kp, vp, bt,
                                         ctx_lens, **kernel_kw)[:, None]
        else:
            ctx = paged_attention_prefill(q.contiguous(), kp, vp, bt,
                                          ctx_lens, **kernel_kw)
        new_cache.update({"block_tables": bt,
                          "context_lens": ctx_lens + vlen,
                          "valid_lens": vlen})
    if ctx is None:
        # the no-cache forward, dispatched as in the JAX package: flash
        # attention (kernels F and G/H on the card, their plain versions
        # on the CPU) when the causal(+window) mask is the whole mask and
        # no attention dropout runs, else core_attention
        flash_eligible = (attention_mask is None
                          and not (train and cfg.attention_dropout > 0.0))
        if cfg.use_flash_attn and flash_eligible:
            ctx = flash_attention(q, k, v, causal=True,
                                  sliding_window=cfg.sliding_window_size,
                                  softmax_scale=1.0 / math.sqrt(
                                      cfg.head_dim))
        elif flash_eligible and q.shape[1] >= CHUNKED_ATTENTION_MIN_SEQ:
            raise NotImplementedError(
                f"unfused attention at {q.shape[1]} tokens takes the JAX "
                f"package's chunked_causal_attention, which is not ported; "
                f"use flash attention")
        else:
            ctx = core_attention(q, k, v, cfg, attention_mask)

    b, s = ctx.shape[:2]
    ctx = ctx.reshape(b, s, cfg.num_attention_heads * cfg.head_dim)
    out = row_parallel_linear(ctx, params["dense"], compute_dtype=cdt)
    if kv_cache is not None:
        return out, new_cache
    return out


# ---------------------------------------------------------------------------
# MLP, layer, stack
# ---------------------------------------------------------------------------

def mlp(x: torch.Tensor, params, cfg: TransformerConfig) -> torch.Tensor:
    cdt = cfg.compute_torch_dtype
    h = column_parallel_linear(x, params["dense_h_to_4h"], compute_dtype=cdt)
    h = apply_mlp_activation(h, cfg)
    return row_parallel_linear(h, params["dense_4h_to_h"], compute_dtype=cdt)


def _norm_uses_kernel(cfg: TransformerConfig) -> bool:
    return cfg.use_fused_rmsnorm and cfg.normalization == "rmsnorm"


def transformer_layer(x: torch.Tensor, params, cfg: TransformerConfig, *,
                      freqs=None, attention_mask=None, position_ids=None,
                      kv_cache=None, train: bool = False):
    """One pre-LN decoder layer (sequential attention then MLP).  Returns
    ``(out, new_cache)``; ``new_cache`` is None without a cache."""
    if train and (cfg.hidden_dropout > 0.0 or cfg.attention_dropout > 0.0):
        raise NotImplementedError(
            "dropout in training is not ported yet (it comes with "
            "random.py); set hidden_dropout and attention_dropout to 0")

    def norm(h, p):
        return apply_norm(h, p, cfg.normalization,
                          eps=cfg.layernorm_epsilon,
                          fp32_compute=cfg.norm_in_fp32,
                          use_kernel=_norm_uses_kernel(cfg))

    ln_out = norm(x, params["input_norm"])
    attn_kw = dict(freqs=freqs, attention_mask=attention_mask,
                   position_ids=position_ids, kv_cache=kv_cache, train=train)
    if kv_cache is not None:
        attn_out, new_cache = attention(ln_out, params["attention"], cfg,
                                        **attn_kw)
    else:
        attn_out = attention(ln_out, params["attention"], cfg, **attn_kw)
        new_cache = None
    h = x + attn_out
    ln2 = norm(h, params["post_attention_norm"])
    return h + mlp(ln2, params["mlp"], cfg), new_cache


def transformer_stack(x: torch.Tensor, stack_params, cfg: TransformerConfig,
                      *, freqs=None, attention_mask=None, position_ids=None,
                      kv_caches=None, train: bool = False):
    """Run the layers in turn, then the final norm.  Returns
    ``(h, new_caches)`` with ``kv_caches``, else ``h``.

    The final norm goes through the RMSNorm kernel like the layers' norms
    (under ``use_fused_rmsnorm``), where the JAX package takes its plain
    norm: this way no plain norm runs on the card."""
    if train and cfg.recompute_granularity is not None:
        raise NotImplementedError(
            f"recompute_granularity={cfg.recompute_granularity!r} is not "
            f"ported yet (torch.utils.checkpoint is a later slice)")
    # one unbind per leaf and forward: indexing p[i] per layer would give
    # each layer's backward a whole [L, ...] zero tensor to scatter into
    unbound = tree_map(lambda p: p.unbind(0), stack_params["layers"])
    new_caches = [] if kv_caches is not None else None
    h = x
    for i in range(cfg.num_layers):
        layer_p = tree_map(lambda p: p[i], unbound)
        h, c = transformer_layer(
            h, layer_p, cfg, freqs=freqs, attention_mask=attention_mask,
            position_ids=position_ids,
            kv_cache=kv_caches[i] if kv_caches is not None else None,
            train=train)
        if new_caches is not None:
            new_caches.append(c)
    h = apply_norm(h, stack_params["final_norm"], cfg.normalization,
                   eps=cfg.layernorm_epsilon, fp32_compute=cfg.norm_in_fp32,
                   use_kernel=_norm_uses_kernel(cfg))
    if kv_caches is not None:
        return h, new_caches
    return h


@functools.lru_cache(maxsize=8)
def _rotary_tables(rot_d: int, seq_len: int, theta: float,
                   scaling_factor: float, llama3: Optional[tuple],
                   device: torch.device):
    return precompute_freqs_cis(
        rot_d, seq_len, theta=theta, scaling_factor=scaling_factor,
        llama3_scaling=(dict(zip(
            ("factor", "low_freq_factor", "high_freq_factor",
             "original_max_position"), llama3)) if llama3 else None),
        device=device)


def rotary_freqs(cfg: TransformerConfig, seq_len: Optional[int] = None,
                 device=None):
    """(cos, sin) tables for the model's rotary embedding, or None.  The
    tables are computed once per (shape, device) and reused; callers
    must not write into them."""
    if cfg.position_embedding_type != PositionEmbeddingType.rotary:
        return None
    rot_d = int(cfg.head_dim * cfg.rotary_percent)
    rot_d -= rot_d % 2
    return _rotary_tables(rot_d, seq_len or cfg.max_position_embeddings,
                          float(cfg.rope_theta),
                          float(cfg.rope_scaling_factor),
                          cfg.rope_llama3_scaling,
                          torch.device(device or "cpu"))
