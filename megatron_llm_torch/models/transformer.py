"""Transformer core: attention (flash attention for the no-cache
forward, the paged KV branch of the serving engine over plain or int8
pools), MLP or mixture of experts (``models/moe.py``), the decoder
layer (pre- or post-LN, sequential or Falcon's parallel attention +
MLP) and the layer stack, for inference and single-device training.

The counterpart of ``megatron_llm_tpu/models/transformer.py``, with its
layouts: activations ``[b, s, ...]``, the packed grouped QKV projection
``[ng, q_per_group + 2, d]``, per-layer params stacked on a leading
``[num_layers]`` axis, and page pools ``[P, bs, g, d]``.  The stack is a
Python loop over the layers (the JAX package scans it); each forward
unbinds the stacked params once, so the backward stacks each leaf's
layer grads once.

With ``num_experts > 1`` each layer's MLP is the mixture of experts, and
the no-cache stack returns the sum over the layers of their routing aux
``[lb, z]`` beside the hidden states (the JAX package carries it through
its scan); the paged branch drops it, as the JAX package does.

Dropout follows the JAX package's sites and streams: the step's key
(an integer, ``megatron_llm_torch/random.py``) is split into one key a
layer and each layer's into the attention-probs, post-attention and
post-MLP sites; each mask is drawn from a generator seeded inside the
layer function, so recompute (``torch.utils.checkpoint`` of each layer,
``recompute_granularity``) draws the same masks again.  Long unfused
attention takes the q-chunked path (``ops/chunked_attention.py``).

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
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from megatron_llm_torch import random as mrandom
from megatron_llm_torch.config import PositionEmbeddingType, TransformerConfig
from megatron_llm_torch.models.moe import init_moe_mlp_params, moe_mlp
from megatron_llm_torch.ops import chunked_attention
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
from megatron_llm_torch.quantization import absmax_quantize_int8
from megatron_llm_torch.tree import tree_map


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
    """The dense MLP's params, or the mixture of experts' when
    ``num_experts > 1``."""
    if cfg.num_experts > 1:
        return init_moe_mlp_params(generator, cfg, dtype, device)
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
    """One decoder layer: input_norm, attention, mlp, and the pre-MLP
    post_attention_norm unless attention and MLP run in parallel
    (``parallel_attn``), where ``parallel_layernorm`` gives the MLP branch
    its own mlp_norm."""
    params = {
        "input_norm": init_norm_params(cfg.hidden_size, cfg.normalization,
                                       dtype, device),
        "attention": init_attention_params(generator, cfg, dtype, device),
        "mlp": init_mlp_params(generator, cfg, dtype, device),
    }
    if not cfg.parallel_attn:
        params["post_attention_norm"] = init_norm_params(
            cfg.hidden_size, cfg.normalization, dtype, device)
    if cfg.parallel_layernorm:
        params["mlp_norm"] = init_norm_params(
            cfg.hidden_size, cfg.normalization, dtype, device)
    return params


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
                   attention_mask: Optional[torch.Tensor],
                   dropout_key: Optional[int] = None,
                   train: bool = False) -> torch.Tensor:
    """Unfused attention: scaled QK^T -> masked softmax -> dropout -> PV,
    with GQA contracting group-shared K/V.  ``attention_mask`` [b, 1, sq,
    sk] bool (True = masked); None applies the causal (+ window) mask.
    The probs are dropped in training with a ``dropout_key``."""
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
    probs = _dropout(probs, cfg.attention_dropout, dropout_key, train)
    ctx = torch.einsum("bgpst,btgd->bsgpd", probs.to(v.dtype), v)
    return ctx.reshape(b, sq, nh, d)


def _paged_scatter(kv_cache: dict, k: torch.Tensor, v: torch.Tensor,
                   dest: torch.Tensor) -> dict:
    """Write the chunk's K/V rows into the page pools, in place, at flat
    positions ``dest`` ([b, n] indices into the [P*bs] position axis): one
    body for the int8 and the full-precision pools.  int8 pools quantise
    on write with per-(position, group) absmax scales.  Returns the
    pages-only cache dict."""
    if "k_pages_q" in kv_cache:
        # K and V in one call: the same values from half the launches
        q8, scale = absmax_quantize_int8(torch.stack((k, v)), axis=-1)
        writes = {"k_pages_q": q8[0], "k_pages_scale": scale[0],
                  "v_pages_q": q8[1], "v_pages_scale": scale[1]}
    else:
        writes = {"k_pages": k, "v_pages": v}
    out = {}
    flat_dest = dest.reshape(-1)
    for name, val in writes.items():
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
              kv_cache: Optional[dict] = None,
              dropout_key: Optional[int] = None, train: bool = False):
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
        quantized = "k_pages_q" in kv_cache
        if not quantized and "k_pages" not in kv_cache:
            raise NotImplementedError(
                "only the paged KV cache of the serving engine is ported "
                "(the linear and rolling caches are later slices)")
        # PAGED cache: one pool of [P, bs] pages per layer shared by all
        # slots; row s of the batch (a serving slot) reads and writes
        # through its block table.  Keys: (k_pages | k_pages_q +
        # k_pages_scale), the same for v.  Padded and inactive tokens
        # (j >= valid_lens) write to the garbage block 0.  The read is
        # ops/kernels/paged_attention.py: the decode entry for one token
        # per slot, the prefill entry for a chunk (the CUDA kernel on a
        # CUDA tensor, its plain version on a CPU one).  The JAX package's
        # dense-gather branch and its kernel on/off switches are not
        # ported: on the card every paged read is the kernel.
        bt = kv_cache["block_tables"]
        ctx_lens = kv_cache["context_lens"]
        vlen = kv_cache["valid_lens"]
        P, bs = kv_cache["k_pages_q" if quantized
                         else "k_pages"].shape[:2]
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
        kernel_kw = dict(k_scales=new_cache.get("k_pages_scale"),
                         v_scales=new_cache.get("v_pages_scale"),
                         softmax_scale=1.0 / math.sqrt(d),
                         sliding_window=cfg.sliding_window_size)
        kp = new_cache["k_pages_q" if quantized else "k_pages"]
        vp = new_cache["v_pages_q" if quantized else "v_pages"]
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
        # no attention dropout runs; without flash, the q-chunked path
        # for long sequences under the same conditions, else
        # core_attention
        flash_eligible = (attention_mask is None
                          and not (train and cfg.attention_dropout > 0.0))
        if cfg.use_flash_attn and flash_eligible:
            ctx = flash_attention(q, k, v, causal=True,
                                  sliding_window=cfg.sliding_window_size,
                                  softmax_scale=1.0 / math.sqrt(
                                      cfg.head_dim))
        elif (flash_eligible and q.shape[1]
              >= chunked_attention.CHUNKED_ATTENTION_MIN_SEQ):
            ctx = chunked_attention.chunked_causal_attention(
                q, k, v, causal=True,
                sliding_window=cfg.sliding_window_size,
                softmax_scale=1.0 / math.sqrt(cfg.head_dim))
        else:
            ctx = core_attention(q, k, v, cfg, attention_mask, dropout_key,
                                 train)

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
    return ((cfg.use_fused_rmsnorm and cfg.normalization == "rmsnorm")
            or (cfg.use_fused_layernorm
                and cfg.normalization == "layernorm"))


@functools.lru_cache(maxsize=64)
def _keep_scale(rate: float, dtype: torch.dtype) -> float:
    """1 - rate as the JAX package divides by it: in fp32, then rounded
    to the activation's dtype."""
    return torch.tensor(1.0 - rate, dtype=torch.float32).to(dtype).item()


def _dropout(x: torch.Tensor, rate: float, key: Optional[int],
             train: bool) -> torch.Tensor:
    """Inverted dropout at ``rate`` with the mask of ``key``; the identity
    outside training, without a key, or at a rate of 0."""
    if not train or key is None or rate <= 0.0:
        return x
    keep = mrandom.bernoulli(key, 1.0 - rate, x.shape, x.device)
    return x * keep.to(x.dtype) / _keep_scale(rate, x.dtype)


def transformer_layer(x: torch.Tensor, params, cfg: TransformerConfig, *,
                      freqs=None, attention_mask=None, position_ids=None,
                      kv_cache=None, rng_key: Optional[int] = None,
                      train: bool = False,
                      hidden_dropout: Optional[float] = None):
    """One decoder layer: pre-LN (default) or post-LN (``use_post_ln``),
    attention then MLP, or Falcon's parallel attention + MLP
    (``parallel_attn``, with the MLP's own norm under
    ``parallel_layernorm``).  ``rng_key`` is the layer's dropout key and
    ``hidden_dropout`` overrides the config's rate (LIMA's per-layer
    rate).  Returns ``(out, new_cache, moe_aux)``: ``new_cache`` is None
    without a cache, ``moe_aux`` (the routing aux ``[lb, z]`` fp32) None
    for a dense MLP."""
    if hidden_dropout is None:
        hidden_dropout = cfg.hidden_dropout
    k_attn_drop, k_h1, k_h2 = (mrandom.split(rng_key, 3)
                               if rng_key is not None else (None,) * 3)

    def norm(h, p):
        return apply_norm(h, p, cfg.normalization,
                          eps=cfg.layernorm_epsilon,
                          fp32_compute=cfg.norm_in_fp32,
                          use_kernel=_norm_uses_kernel(cfg))

    ln_out = norm(x, params["input_norm"]) if not cfg.use_post_ln else x
    attn_kw = dict(freqs=freqs, attention_mask=attention_mask,
                   position_ids=position_ids, kv_cache=kv_cache,
                   dropout_key=k_attn_drop, train=train)
    if kv_cache is not None:
        attn_out, new_cache = attention(ln_out, params["attention"], cfg,
                                        **attn_kw)
    else:
        attn_out = attention(ln_out, params["attention"], cfg, **attn_kw)
        new_cache = None

    def run_mlp(inp):
        if cfg.num_experts > 1:
            return moe_mlp(inp, params["mlp"], cfg)
        return mlp(inp, params["mlp"], cfg), None

    if cfg.parallel_attn:
        # the MLP reads the same norm output as attention (or its own),
        # and attn + mlp are added before the one residual add
        mlp_in = (norm(x, params["mlp_norm"]) if cfg.parallel_layernorm
                  else ln_out)
        mlp_out, moe_aux = run_mlp(mlp_in)
        out = x + _dropout(attn_out + mlp_out, hidden_dropout, k_h1, train)
        if cfg.use_post_ln:
            out = norm(out, params["input_norm"])
        return out, new_cache, moe_aux
    h = x + _dropout(attn_out, hidden_dropout, k_h1, train)
    if cfg.use_post_ln:
        h = norm(h, params["input_norm"])
    ln2 = (norm(h, params["post_attention_norm"]) if not cfg.use_post_ln
           else h)
    mlp_out, moe_aux = run_mlp(ln2)
    out = h + _dropout(mlp_out, hidden_dropout, k_h2, train)
    if cfg.use_post_ln:
        out = norm(out, params["post_attention_norm"])
    return out, new_cache, moe_aux


def _lima_dropout_rates(cfg: TransformerConfig) -> list:
    """LIMA's linearly increasing layer dropout p_l = p * l / (L - 1), the
    JAX package's fp32 values as Python floats."""
    L = cfg.num_layers
    if L == 1:
        return [0.0]
    rates = (torch.tensor(cfg.hidden_dropout, dtype=torch.float32)
             * torch.arange(L, dtype=torch.float32) / (L - 1))
    return rates.tolist()


# the selective policy keeps the dense products (the JAX package's
# dots_with_no_batch_dims_saveable: core_attention's einsums are batched,
# so they are recomputed with the norms, rope, attention, softmax and
# dropout)
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _selective_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def transformer_stack(x: torch.Tensor, stack_params, cfg: TransformerConfig,
                      *, freqs=None, attention_mask=None, position_ids=None,
                      kv_caches=None, rng_key: Optional[int] = None,
                      train: bool = False):
    """Run the layers in turn, then the final norm.  Returns
    ``(h, new_caches)`` with ``kv_caches``, else ``h``, or ``(h,
    moe_aux)`` for a mixture of experts (the layers' ``[lb, z]`` added
    up in layer order, in fp32).

    ``rng_key`` (the stack's dropout key) is split into one key a layer;
    ``lima_dropout`` gives each layer its own hidden-dropout rate.  Under
    ``recompute_granularity`` each layer of a forward that builds a graph
    runs under ``torch.utils.checkpoint`` (non-reentrant, as
    ``torch.autograd.grad`` needs): 'full', 'uniform' and 'block' keep
    only the layer's input, 'selective' also the outputs of its dense
    products; a checkpointed MoE layer returns its aux with its output,
    so the aux is counted once.  ``recompute_num_layers`` is not read,
    as in the JAX package.

    The final norm goes through the norm kernel like the layers' norms
    (under ``use_fused_rmsnorm`` / ``use_fused_layernorm``), where the JAX
    package takes its plain norm: this way no plain norm runs on the
    card."""
    L = cfg.num_layers
    rates = _lima_dropout_rates(cfg) if cfg.lima_dropout else None
    keys = mrandom.split(rng_key, L) if rng_key is not None else (None,) * L
    recompute = None
    if (train and kv_caches is None and torch.is_grad_enabled()
            and cfg.recompute_granularity is not None):
        recompute = ({} if cfg.recompute_granularity != "selective"
                      else {"context_fn": functools.partial(
                          create_selective_checkpoint_contexts,
                          _selective_policy)})
    # one unbind per leaf and forward: indexing p[i] per layer would give
    # each layer's backward a whole [L, ...] zero tensor to scatter into
    unbound = tree_map(lambda p: p.unbind(0), stack_params["layers"])
    new_caches = [] if kv_caches is not None else None

    moe_on = cfg.num_experts > 1

    def layer_fn(h, layer_p, key, rate):
        out, _, moe_aux = transformer_layer(
            h, layer_p, cfg, freqs=freqs, attention_mask=attention_mask,
            position_ids=position_ids, rng_key=key, train=train,
            hidden_dropout=rate)
        return (out, moe_aux) if moe_on else out

    h = x
    aux_acc = (torch.zeros(2, dtype=torch.float32, device=x.device)
               if moe_on and kv_caches is None else None)
    for i in range(L):
        layer_p = tree_map(lambda p: p[i], unbound)
        rate = rates[i] if rates is not None else None
        if kv_caches is not None:
            # the routing aux is not needed at decode time: dropped
            h, c, _ = transformer_layer(
                h, layer_p, cfg, freqs=freqs, attention_mask=attention_mask,
                position_ids=position_ids, kv_cache=kv_caches[i])
            new_caches.append(c)
            continue
        if recompute is not None:
            # the masks' generators are seeded inside layer_fn, so the
            # recompute draws the same masks; no default generator is read
            out = checkpoint(layer_fn, h, layer_p, keys[i], rate,
                             use_reentrant=False, preserve_rng_state=False,
                             **recompute)
        else:
            out = layer_fn(h, layer_p, keys[i], rate)
        if moe_on:
            h, moe_aux = out
            aux_acc = aux_acc + moe_aux
        else:
            h = out
    h = apply_norm(h, stack_params["final_norm"], cfg.normalization,
                   eps=cfg.layernorm_epsilon, fp32_compute=cfg.norm_in_fp32,
                   use_kernel=_norm_uses_kernel(cfg))
    if kv_caches is not None:
        return h, new_caches
    return (h, aux_acc) if moe_on else h


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
