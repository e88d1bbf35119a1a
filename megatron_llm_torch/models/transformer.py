"""Transformer core: attention (flash attention for the no-cache
forward, the paged KV branch of the serving engine over plain or int8
pools, the legacy generate path's linear, int8 linear and rolling
caches), MLP or mixture of experts (``models/moe.py``), the decoder
layer (pre- or post-LN, sequential or Falcon's parallel attention +
MLP; and T5's decoder layer, which adds the cross-attention over the
encoder's output) and the layer stack, for inference and training, on
one device or at tensor-parallel size above 1.

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

The JAX package's cache branches are functional: they return fresh
pools and caches.  Here every cache is written in place, which saves
copying a whole cache per layer per step; the returned cache dicts hold
the same tensors, and a cache's ``index`` is a Python int.

At tp > 1 (``topology``) a rank holds its slice of every sharded leaf
(``parallel/sharding.py``): its query heads and their KV groups, its
columns of the MLP; attention and flash run on the local heads, and the
linears' collectives (``parallel/layers.py``) join the ranks.  Under
``sequence_parallel`` the residual stream, the norms and the hidden
dropouts work on this rank's sequence shard ``[b, s / tp, h]``, and a
dropout mask is this shard's slice of the one-device mask
(``random.bernoulli``).  Serving at tp > 1 is not ported (the JAX
engine has no mesh either): ``language_model_forward`` refuses a cache.
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
from megatron_llm_torch import topology
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
    SEQ_DIM,
    column_parallel_linear,
    init_linear_params,
    init_method_for,
    init_method_normal,
    row_parallel_linear,
    scaled_init_method_normal,
)
from megatron_llm_torch.parallel.sharding import local_heads
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


def init_cross_attention_params(generator, cfg: TransformerConfig, dtype,
                                device=None):
    """A decoder layer's cross-attention: ``query`` (from the decoder's
    stream), the packed ``key_value`` (from the encoder's output) and
    ``dense``, at the full head count (no GQA)."""
    init = init_method_normal(cfg.init_method_std)
    out_init = (scaled_init_method_normal(cfg.init_method_std,
                                          cfg.num_layers)
                if cfg.use_scaled_init_method else init)
    nh_d = cfg.num_attention_heads * cfg.head_dim
    return {
        "query": init_linear_params(
            generator, cfg.hidden_size, nh_d, bias=cfg.add_bias_linear,
            init_method=init, dtype=dtype, device=device),
        "key_value": init_linear_params(
            generator, cfg.hidden_size, 2 * nh_d, bias=cfg.add_bias_linear,
            init_method=init, dtype=dtype, device=device),
        "dense": init_linear_params(
            generator, nh_d, cfg.hidden_size, bias=cfg.add_bias_linear,
            init_method=out_init, dtype=dtype, device=device),
    }


def init_layer_params(generator, cfg: TransformerConfig, dtype, device=None,
                      layer_type: str = "encoder"):
    """One layer: input_norm, attention, mlp, and the pre-MLP
    post_attention_norm unless attention and MLP run in parallel
    (``parallel_attn``), where ``parallel_layernorm`` gives the MLP branch
    its own mlp_norm.  A ``"decoder"`` layer (T5's) adds the
    cross-attention ``inter_attention`` and its
    ``post_inter_attention_norm``."""
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
    if layer_type == "decoder":
        params["inter_attention"] = init_cross_attention_params(
            generator, cfg, dtype, device)
        params["post_inter_attention_norm"] = init_norm_params(
            cfg.hidden_size, cfg.normalization, dtype, device)
    return params


def init_stack_params(generator, cfg: TransformerConfig, dtype,
                      device=None, layer_type: str = "encoder",
                      shard_layer=None, rows=None):
    """Layer-stacked params: every leaf gets a leading [num_layers] axis.
    Each layer is drawn and copied into the stacked tensors in turn, so
    the peak is one layer above the final size.  ``shard_layer(layer)``,
    when given, cuts each drawn layer to this rank's tensor-parallel
    slices before it is stacked.  ``rows`` (a pipeline stage's natural
    layers, in its row order) keeps those layers alone; every layer is
    still drawn, so that a seed gives the same model at every pp."""
    L = cfg.num_layers
    slot = {layer: j for j, layer in enumerate(rows)} if rows is not None \
        else {i: i for i in range(L)}
    layers = None
    for i in range(L):
        lp = init_layer_params(generator, cfg, dtype, device, layer_type)
        if i not in slot:
            continue
        if shard_layer is not None:
            lp = shard_layer(lp)
        if layers is None:
            layers = tree_map(lambda t: torch.empty(
                (len(slot),) + tuple(t.shape), dtype=t.dtype,
                device=t.device), lp)
        tree_map(lambda dst, src: dst[slot[i]].copy_(src), layers, lp)
    return {
        "layers": layers,
        "final_norm": init_norm_params(cfg.hidden_size, cfg.normalization,
                                       dtype, device),
    }


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def sequence_parallel_on(cfg: TransformerConfig) -> bool:
    """Sequence parallelism is on: asked for, at tp > 1."""
    return bool(getattr(cfg, "sequence_parallel", False)) and \
        topology.get_tensor_model_parallel_world_size() > 1


def sequence_shard(full_len: int) -> tuple:
    """(dim, start, length) of this rank's sequence shard of a ``[b, s,
    ...]`` tensor of ``full_len`` positions."""
    tp = topology.get_tensor_model_parallel_world_size()
    n = full_len // tp
    return (SEQ_DIM, topology.get_tensor_model_parallel_rank() * n, n)


def _split_qkv(mixed: torch.Tensor, cfg: TransformerConfig):
    """mixed [b, s, ng*(qpg+2)*d] in Megatron's grouped layout ->
    q [b, s, nh, d], k [b, s, ng, d], v [b, s, ng, d], with this rank's
    heads and groups at tp > 1."""
    b, s, _ = mixed.shape
    nh, ng = local_heads(cfg)
    qpg = nh // ng
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
    local = None
    if topology.get_tensor_model_parallel_world_size() > 1:
        # this rank's heads of the one-device mask [b, nh, sq, sk]
        local = ((b, cfg.num_attention_heads, sq, sk), (
            1, topology.get_tensor_model_parallel_rank() * nh, nh))
    probs = _dropout(probs, cfg.attention_dropout, dropout_key, train,
                     local=local)
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


def _window_mask(key_pos: torch.Tensor, pos: torch.Tensor,
                 cfg: TransformerConfig) -> torch.Tensor:
    """[sq, sk] bool, True where query position ``pos`` may read key
    position ``key_pos``: causal, and inside the sliding window if any."""
    valid = key_pos[None, :] <= pos[:, None]
    if cfg.sliding_window_size is not None:
        valid &= key_pos[None, :] > pos[:, None] - cfg.sliding_window_size
    return valid


def _dense_cache_step(kv_cache: dict, k: torch.Tensor, v: torch.Tensor,
                      cfg: TransformerConfig):
    """The non-paged decode caches of ``text_generation/generation.py``
    (``init_kv_caches``), each written in place at ``kv_cache["index"]``
    (a Python int):

    * rolling (``"rolling"`` key; sliding-window models): a ring of W
      slots, slot j holding the newest position == j (mod W) written so
      far.  The chunk attends over [the ring as it was before the chunk
      || the chunk], and only then is the chunk written, so its writes
      never clobber keys its own queries still need; a chunk of n >= W
      writes only its last W tokens (all n would hit each slot more than
      once, where only the newest may win);
    * int8 linear (``k_q``, ``k_scale``, ``v_q``, ``v_scale``): K/V as
      int8 with per-(batch, position, group) absmax scales, quantised on
      write and dequantised on read;
    * linear (``k``, ``v``): the whole [b, max_len] cache, masked beyond
      the current positions.

    Returns (keys, values, mask [b, 1, sq, sk] with True = masked, the
    new cache dict with ``index`` advanced by the chunk)."""
    idx = int(kv_cache["index"])
    b, n = k.shape[:2]
    dev = k.device
    pos = idx + torch.arange(n, device=dev)
    if "rolling" in kv_cache:
        assert cfg.sliding_window_size is not None, \
            "rolling KV caches require a sliding-window model"
        ring_k, ring_v = kv_cache["k"], kv_cache["v"]
        W = ring_k.shape[1]
        last_pre = idx - 1
        # newest position == slot (mod W) written before this chunk;
        # negative = never written
        slot = torch.arange(W, device=dev)
        cache_pos = last_pre - torch.remainder(last_pre - slot, W)
        key_pos = torch.cat([cache_pos, pos])
        valid = (key_pos[None, :] >= 0) & _window_mask(key_pos, pos, cfg)
        keys = torch.cat([ring_k, k.to(ring_k.dtype)], dim=1)
        values = torch.cat([ring_v, v.to(ring_v.dtype)], dim=1)
        if n >= W:
            w_pos, wk, wv = pos[-W:], k[:, -W:], v[:, -W:]
        else:
            w_pos, wk, wv = pos, k, v
        write = torch.remainder(w_pos, W)
        ring_k[:, write] = wk.to(ring_k.dtype)
        ring_v[:, write] = wv.to(ring_v.dtype)
        new_cache = {"k": ring_k, "v": ring_v, "index": idx + n,
                     "rolling": None}
    elif "k_q" in kv_cache:
        kq, ks = absmax_quantize_int8(k, axis=-1)
        vq, vs = absmax_quantize_int8(v, axis=-1)
        for name, val in (("k_q", kq), ("k_scale", ks), ("v_q", vq),
                          ("v_scale", vs)):
            kv_cache[name][:, idx:idx + n] = val
        sk = kv_cache["k_q"].shape[1]
        valid = _window_mask(torch.arange(sk, device=dev), pos, cfg)
        cdt = k.dtype
        keys = (kv_cache["k_q"].to(cdt)
                * kv_cache["k_scale"][..., None].to(cdt))
        values = (kv_cache["v_q"].to(cdt)
                  * kv_cache["v_scale"][..., None].to(cdt))
        new_cache = {name: kv_cache[name]
                     for name in ("k_q", "k_scale", "v_q", "v_scale")}
        new_cache["index"] = idx + n
    else:
        kv_cache["k"][:, idx:idx + n] = k
        kv_cache["v"][:, idx:idx + n] = v
        keys, values = kv_cache["k"], kv_cache["v"]
        valid = _window_mask(torch.arange(keys.shape[1], device=dev), pos,
                             cfg)
        new_cache = {"k": keys, "v": values, "index": idx + n}
    mask = (~valid)[None, None].expand(b, 1, -1, -1)
    return keys, values, mask, new_cache


def attention(x: torch.Tensor, params, cfg: TransformerConfig, *,
              freqs: Optional[tuple], attention_mask: Optional[torch.Tensor],
              position_ids: Optional[torch.Tensor],
              kv_cache: Optional[dict] = None,
              dropout_key: Optional[int] = None, train: bool = False):
    """QKV projection, RoPE, attention, output projection.  With a
    ``kv_cache`` returns ``(out, new_cache)``: a paged one (pools plus
    block_tables / context_lens / valid_lens) for the serving engine, or
    a rolling, int8 linear or linear one (``_dense_cache_step``) for the
    legacy generate path."""
    cdt = cfg.compute_torch_dtype
    sp = sequence_parallel_on(cfg)
    mixed = column_parallel_linear(x, params["query_key_value"],
                                   compute_dtype=cdt, sequence_parallel=sp)
    q, k, v = _split_qkv(mixed, cfg)
    if (cfg.position_embedding_type == PositionEmbeddingType.rotary
            and freqs is not None):
        cos, sin = freqs
        q = apply_rotary_emb(q, cos, sin, position_ids)
        k = apply_rotary_emb(k, cos, sin, position_ids)

    new_cache = None
    ctx = None
    if kv_cache is not None and not ("k_pages" in kv_cache
                                     or "k_pages_q" in kv_cache):
        # the legacy generate path's caches (text_generation/generation.py):
        # their mask goes to core_attention below
        k, v, attention_mask, new_cache = _dense_cache_step(kv_cache, k, v,
                                                            cfg)
    elif kv_cache is not None:
        quantized = "k_pages_q" in kv_cache
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
        flash_eligible = (kv_cache is None and attention_mask is None
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
    ctx = ctx.reshape(b, s, q.shape[2] * cfg.head_dim)
    out = row_parallel_linear(ctx, params["dense"], compute_dtype=cdt,
                              sequence_parallel=sp)
    if kv_cache is not None:
        return out, new_cache
    return out


def cross_attention(x: torch.Tensor, encoder_output: torch.Tensor, params,
                    cfg: TransformerConfig, *,
                    enc_dec_mask: Optional[torch.Tensor],
                    dropout_key: Optional[int] = None,
                    train: bool = False) -> torch.Tensor:
    """Encoder-decoder attention: Q from the decoder's stream, the packed
    KV from the encoder's output (``[b, sk, nh, 2, d]``, K first), the
    full head count, through ``core_attention``.  ``enc_dec_mask`` [b, 1,
    sq, sk] bool (True = masked); None attends everywhere."""
    nh, d = cfg.num_attention_heads, cfg.head_dim
    cdt = cfg.compute_torch_dtype
    q = column_parallel_linear(x, params["query"], compute_dtype=cdt)
    kv = column_parallel_linear(encoder_output, params["key_value"],
                                compute_dtype=cdt)
    b, sq = x.shape[:2]
    sk = encoder_output.shape[1]
    q = q.reshape(b, sq, nh, d)
    kv = kv.reshape(b, sk, nh, 2, d)
    k, v = kv[:, :, :, 0, :], kv[:, :, :, 1, :]
    if enc_dec_mask is None:
        enc_dec_mask = torch.zeros((1, 1, sq, sk), dtype=torch.bool,
                                   device=x.device)
    ctx = core_attention(q, k, v, cfg, enc_dec_mask, dropout_key, train)
    return row_parallel_linear(ctx.reshape(b, sq, nh * d), params["dense"],
                               compute_dtype=cdt)


# ---------------------------------------------------------------------------
# MLP, layer, stack
# ---------------------------------------------------------------------------

def mlp(x: torch.Tensor, params, cfg: TransformerConfig) -> torch.Tensor:
    cdt = cfg.compute_torch_dtype
    sp = sequence_parallel_on(cfg)
    h = column_parallel_linear(x, params["dense_h_to_4h"], compute_dtype=cdt,
                               sequence_parallel=sp)
    h = apply_mlp_activation(h, cfg)
    return row_parallel_linear(h, params["dense_4h_to_h"], compute_dtype=cdt,
                               sequence_parallel=sp)


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
             train: bool, local=None) -> torch.Tensor:
    """Inverted dropout at ``rate`` with the mask of ``key``; the identity
    outside training, without a key, or at a rate of 0.  ``local =
    (full shape, (dim, start, length))``: ``x`` is that slice of a tensor
    of the full shape (a tensor-parallel shard), and takes that slice of
    the full shape's mask.  At dp > 1 ``x`` (batch-major) holds this
    rank's rows of the global micro batch, and the mask is drawn at the
    global batch's rows too, so that every tp x dp gives the one-device
    masks."""
    if not train or key is None or rate <= 0.0:
        return x
    full, cuts = (tuple(x.shape), []) if local is None else \
        (tuple(local[0]), [local[1]])
    dp = topology.get_data_parallel_world_size()
    if dp > 1:
        b = full[0]
        full = (b * dp,) + full[1:]
        cuts.append((0, topology.get_data_parallel_rank() * b, b))
    if not cuts:
        keep = mrandom.bernoulli(key, 1.0 - rate, x.shape, x.device)
    else:
        keep = mrandom.bernoulli(key, 1.0 - rate, full, x.device,
                                 local=cuts).reshape(x.shape)
    return x * keep.to(x.dtype) / _keep_scale(rate, x.dtype)


def _sequence_local(x: torch.Tensor, cfg: TransformerConfig):
    """``_dropout``'s ``local`` for a residual-stream tensor: its
    sequence shard's slice under sequence parallelism, else None."""
    if not sequence_parallel_on(cfg):
        return None
    tp = topology.get_tensor_model_parallel_world_size()
    full = (x.shape[0], x.shape[1] * tp) + tuple(x.shape[2:])
    return full, sequence_shard(full[1])


def transformer_layer(x: torch.Tensor, params, cfg: TransformerConfig, *,
                      freqs=None, attention_mask=None, position_ids=None,
                      kv_cache=None, rng_key: Optional[int] = None,
                      train: bool = False,
                      hidden_dropout: Optional[float] = None,
                      encoder_output: Optional[torch.Tensor] = None,
                      enc_dec_mask: Optional[torch.Tensor] = None):
    """One layer: pre-LN (default) or post-LN (``use_post_ln``),
    attention then MLP, or Falcon's parallel attention + MLP
    (``parallel_attn``, with the MLP's own norm under
    ``parallel_layernorm``); a layer with ``inter_attention`` params
    given an ``encoder_output`` (T5's decoder) runs the cross-attention
    over it between attention and MLP.  ``rng_key`` is the layer's
    dropout key (split in 5 for a decoder layer, in 3 otherwise, as the
    JAX package splits it) and ``hidden_dropout`` overrides the config's
    rate (LIMA's per-layer rate).  Returns ``(out, new_cache, moe_aux)``:
    ``new_cache`` is None without a cache, ``moe_aux`` (the routing aux
    ``[lb, z]`` fp32) None for a dense MLP."""
    is_decoder = "inter_attention" in params and encoder_output is not None
    if is_decoder and cfg.parallel_attn:
        raise NotImplementedError(
            "cross-attention (T5 decoder) is not supported with "
            "parallel_attn")
    if hidden_dropout is None:
        hidden_dropout = cfg.hidden_dropout
    k_x_drop = k_hx = None
    if rng_key is None:
        k_attn_drop = k_h1 = k_h2 = None
    elif is_decoder:
        k_attn_drop, k_h1, k_h2, k_x_drop, k_hx = mrandom.split(rng_key, 5)
    else:
        k_attn_drop, k_h1, k_h2 = mrandom.split(rng_key, 3)

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
            if topology.get_tensor_model_parallel_world_size() > 1:
                raise NotImplementedError(
                    "the mixture of experts at tp > 1 is not ported "
                    "(ROADMAP item 15)")
            return moe_mlp(inp, params["mlp"], cfg)
        return mlp(inp, params["mlp"], cfg), None

    if cfg.parallel_attn:
        # the MLP reads the same norm output as attention (or its own),
        # and attn + mlp are added before the one residual add
        mlp_in = (norm(x, params["mlp_norm"]) if cfg.parallel_layernorm
                  else ln_out)
        mlp_out, moe_aux = run_mlp(mlp_in)
        out = x + _dropout(attn_out + mlp_out, hidden_dropout, k_h1, train,
                           local=_sequence_local(x, cfg))
        if cfg.use_post_ln:
            out = norm(out, params["input_norm"])
        return out, new_cache, moe_aux
    h = x + _dropout(attn_out, hidden_dropout, k_h1, train,
                     local=_sequence_local(x, cfg))
    if cfg.use_post_ln:
        h = norm(h, params["input_norm"])
    ln2 = (norm(h, params["post_attention_norm"]) if not cfg.use_post_ln
           else h)
    if is_decoder:
        inter_out = cross_attention(ln2, encoder_output,
                                    params["inter_attention"], cfg,
                                    enc_dec_mask=enc_dec_mask,
                                    dropout_key=k_x_drop, train=train)
        h = h + _dropout(inter_out, hidden_dropout, k_hx, train)
        if cfg.use_post_ln:
            h = norm(h, params["post_attention_norm"])
        ln2 = (norm(h, params["post_inter_attention_norm"])
               if not cfg.use_post_ln else h)
    mlp_out, moe_aux = run_mlp(ln2)
    out = h + _dropout(mlp_out, hidden_dropout, k_h2, train,
                       local=_sequence_local(h, cfg))
    if cfg.use_post_ln:
        out = norm(out, params["post_inter_attention_norm" if is_decoder
                               else "post_attention_norm"])
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
                      train: bool = False,
                      encoder_output: Optional[torch.Tensor] = None,
                      enc_dec_mask: Optional[torch.Tensor] = None):
    """Run the layers in turn, then the final norm; a decoder stack's
    layers also attend ``encoder_output`` under ``enc_dec_mask``.  Returns
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

    def layer_fn(h, layer_p, key, rate, enc_out=None):
        out, _, moe_aux = transformer_layer(
            h, layer_p, cfg, freqs=freqs, attention_mask=attention_mask,
            position_ids=position_ids, rng_key=key, train=train,
            hidden_dropout=rate, encoder_output=enc_out,
            enc_dec_mask=enc_dec_mask)
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
            # a decoder's layers also take the encoder's output
            extra = (encoder_output,) if encoder_output is not None else ()
            out = checkpoint(layer_fn, h, layer_p, keys[i], rate, *extra,
                             use_reentrant=False, preserve_rng_state=False,
                             **recompute)
        else:
            out = layer_fn(h, layer_p, keys[i], rate, encoder_output)
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
