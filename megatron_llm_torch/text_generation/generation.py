"""KV-cached autoregressive generation and beam search (the counterpart of
``megatron_llm_tpu/text_generation/generation.py``), and the serving
engine's paged KV pools.

The legacy generate path: prefill up to the shortest prompt, then one
token a step for the whole batch, with the reference's ragged-prompt
scheme (prompt tokens override samples until each row's length is
passed), sampling, stop and ban rules and per-token log-probs.  The JAX
package jits the decode into one ``while_loop``; here it is a Python loop
of eager steps whose one host sync a step is the loop's own "every row
is done" test.  Caches are written in place (``models/transformer.py``
``_dense_cache_step``); beam search reorders them with ``index_select``
into fresh tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from megatron_llm_torch.config import TransformerConfig
from megatron_llm_torch.models.language_model import language_model_forward
from megatron_llm_torch.text_generation.sampling import sample

NEG_INF_LOGIT = -1e10


def init_kv_caches(cfg: TransformerConfig, batch: int, max_len: int,
                   dtype=None, rolling: bool = False,
                   quantized: bool = False, device="cuda"):
    """Per-layer decode caches on ``device``: linear ``k`` / ``v`` [batch,
    max_len, groups, head_dim] in the compute dtype; ``rolling``
    (sliding-window models only) a ring of ``min(max_len, window)``
    slots, marked by a ``"rolling"`` key; ``quantized`` int8 ``k_q`` /
    ``v_q`` with fp32 absmax scales ``k_scale`` / ``v_scale`` [batch,
    max_len, groups] (ones until written; linear only).  ``index`` starts
    at 0."""
    dtype = dtype or cfg.compute_torch_dtype
    ng, d = cfg.num_query_groups, cfg.head_dim
    if rolling:
        assert cfg.sliding_window_size is not None, \
            "rolling caches need a sliding-window model"
        size = min(max_len, cfg.sliding_window_size)
    else:
        size = max_len
    shape = (batch, size, ng, d)
    if quantized:
        assert not rolling, "int8 KV cache: linear cache only"
        return [{"k_q": torch.zeros(shape, dtype=torch.int8, device=device),
                 "k_scale": torch.ones(shape[:3], dtype=torch.float32,
                                       device=device),
                 "v_q": torch.zeros(shape, dtype=torch.int8, device=device),
                 "v_scale": torch.ones(shape[:3], dtype=torch.float32,
                                       device=device),
                 "index": 0}
                for _ in range(cfg.num_layers)]
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device),
             "index": 0,
             **({"rolling": None} if rolling else {})}
            for _ in range(cfg.num_layers)]


def init_paged_kv_caches(cfg: TransformerConfig, num_blocks: int,
                         block_size: int, dtype=None, device="cuda",
                         quantized: bool = False):
    """Per-layer page pools ``[num_blocks, block_size, groups, head_dim]``
    on ``device``, shared by every active request through per-slot block
    tables: ``k_pages`` / ``v_pages`` in the compute dtype, or, when
    ``quantized``, int8 ``k_pages_q`` / ``v_pages_q`` with fp32 absmax
    scales ``k_pages_scale`` / ``v_pages_scale`` ``[num_blocks, block_size,
    groups]`` (ones until written).  Block 0 is the reserved garbage
    block."""
    dtype = dtype or cfg.compute_torch_dtype
    shape = (num_blocks, block_size, cfg.num_query_groups, cfg.head_dim)
    if quantized:
        return [{"k_pages_q": torch.zeros(shape, dtype=torch.int8,
                                          device=device),
                 "k_pages_scale": torch.ones(shape[:3], dtype=torch.float32,
                                             device=device),
                 "v_pages_q": torch.zeros(shape, dtype=torch.int8,
                                          device=device),
                 "v_pages_scale": torch.ones(shape[:3], dtype=torch.float32,
                                             device=device)}
                for _ in range(cfg.num_layers)]
    return [{"k_pages": torch.zeros(shape, dtype=dtype, device=device),
             "v_pages": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.num_layers)]


def _forward_with_cache(model, params, tokens: torch.Tensor, caches,
                        start_pos: int):
    """Run the model over ``tokens`` [b, n], writing KV at ``start_pos``;
    returns (logits [b, n, V], the new caches)."""
    caches = [dict(c, index=start_pos) for c in caches]
    b, n = tokens.shape
    position_ids = (start_pos + torch.arange(n, device=tokens.device)
                    )[None, :].expand(b, n)
    return language_model_forward(params, tokens, position_ids, None,
                                  model.cfg, kv_caches=caches)


def _prefill_chunks(b: int, n: int, threshold: Optional[int]) -> int:
    """Micro-batch count for the prefill forward: the smallest divisor C of
    b with (b / C) * n <= threshold (the reference's
    ``--inference_batch_times_seqlen_threshold``)."""
    if threshold is None or b * n <= threshold or b <= 1:
        return 1
    for c in range(2, b + 1):
        if b % c == 0 and (b // c) * n <= threshold:
            return c
    return b


def _picked_log_probs(logits: torch.Tensor, toks: torch.Tensor
                      ) -> torch.Tensor:
    """log p(toks[:, t + 1] | prefix) from logits [b, n, V] -> [b, n - 1]."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(lp[:, :-1], -1, toks[:, 1:, None].long())[..., 0]


@torch.no_grad()
def generate_tokens(model, params, prompt_tokens: torch.Tensor,
                    prompt_lengths: torch.Tensor,
                    generator: Optional[torch.Generator], *,
                    max_new_tokens: int, min_prompt_len: int,
                    top_k: int = 0, top_p: float = 0.0,
                    temperature: float = 1.0, greedy: bool = False,
                    eod_id: Optional[int] = None,
                    return_log_probs: bool = False,
                    batch_times_seqlen_threshold: Optional[int] = None,
                    top_p_decay: float = 0.0, top_p_bound: float = 0.0,
                    extra_stop_ids: tuple = (), stop_pairs: tuple = (),
                    ban_pairs: tuple = (), rolling_cache: bool = False,
                    cache_len: Optional[int] = None,
                    int8_kv_cache: bool = False):
    """prompt_tokens [b, max_prompt] (right-padded), prompt_lengths [b] ->
    (tokens [b, total], the position the loop stopped at, log_probs [b,
    total] fp32; zeros unless ``return_log_probs``).

    ``cache_len`` allocates the linear caches with at least this many
    positions (masked beyond the current one, so the results are the
    same); rolling caches are the window's size regardless.
    ``int8_kv_cache`` stores K/V as int8 with per-position scales (linear
    caches only).  ``batch_times_seqlen_threshold`` splits a prefill of
    more batch x seqlen tokens into micro-batches, so the [b, n, V]
    logits never exist at once.  ``top_p_decay`` / ``top_p_bound``
    multiply top_p by the decay each generated token, floored at the
    bound; ``extra_stop_ids`` stop a row like ``eod_id``; ``stop_pairs``
    stop it on a (previous, current) bigram; ``ban_pairs`` (a, b) forbid
    token b after token a.  Sampled rows draw from ``generator``."""
    cfg = model.cfg
    dev = prompt_tokens.device
    b, max_prompt = prompt_tokens.shape
    total = max_prompt + max_new_tokens
    cache_total = total if (cache_len is None or rolling_cache) \
        else max(cache_len, total)
    caches = init_kv_caches(cfg, b, cache_total, rolling=rolling_cache,
                            quantized=int8_kv_cache, device=dev)
    tokens = torch.cat([prompt_tokens.long(),
                        torch.zeros((b, max_new_tokens), dtype=torch.long,
                                    device=dev)], dim=1)
    log_probs = torch.zeros((b, total), dtype=torch.float32, device=dev)
    prompt_lengths = prompt_lengths.to(dev)

    # prefill up to the shortest prompt, in C micro-batches
    prefill = max(min_prompt_len, 1)
    C = _prefill_chunks(b, prefill, batch_times_seqlen_threshold)
    bc = b // C
    last = []
    for i in range(C):
        rows = slice(i * bc, (i + 1) * bc)
        # views of the batch's caches: the chunk's forward writes its rows
        chunk_caches = [{key: (val if key in ("index", "rolling")
                               else val[rows])
                         for key, val in c.items()} for c in caches]
        toks_i = tokens[rows, :prefill]
        logits_i, _ = _forward_with_cache(model, params, toks_i,
                                          chunk_caches, 0)
        if return_log_probs:
            log_probs[rows, 1:prefill] = _picked_log_probs(logits_i, toks_i)
        last.append(logits_i[:, -1])
        del logits_i
    last_logits = torch.cat(last) if C > 1 else last[0]

    done = torch.zeros(b, dtype=torch.bool, device=dev)
    pos = prefill
    while pos < total and not bool(done.all()):
        prev = tokens[:, pos - 1]
        if ban_pairs:
            last_logits = last_logits.clone()
            for a, b_id in ban_pairs:
                last_logits[:, b_id] += torch.where(
                    prev == a, NEG_INF_LOGIT, 0.0).to(last_logits.dtype)
        if top_p_decay > 0.0 and top_p > 0.0:
            top_p_t = max(top_p * top_p_decay ** (pos - prefill),
                          top_p_bound)
        else:
            top_p_t = top_p
        nxt = sample(last_logits, generator, top_k=top_k, top_p=top_p_t,
                     temperature=temperature, greedy=greedy)
        in_prompt = pos < prompt_lengths
        cur = tokens[:, pos]
        new_tok = torch.where(in_prompt | done, cur, nxt)
        tokens[:, pos] = new_tok
        if return_log_probs:
            lp = torch.log_softmax(last_logits.float(), dim=-1)
            log_probs[:, pos] = torch.gather(lp, -1, new_tok[:, None])[:, 0]
        gen_tok = ~in_prompt
        if eod_id is not None:
            done = done | ((new_tok == eod_id) & gen_tok)
        for s in extra_stop_ids:
            done = done | ((new_tok == s) & gen_tok)
        for a, b_id in stop_pairs:
            done = done | ((prev == a) & (new_tok == b_id) & gen_tok)
        pos += 1
        if pos < total:     # the last token's logits would go unread
            logits, caches = _forward_with_cache(model, params,
                                                 new_tok[:, None], caches,
                                                 pos - 1)
            last_logits = logits[:, -1]
    return tokens, pos, log_probs


def greedy_generate(model, params, prompt_tokens, prompt_lengths,
                    max_new_tokens, eod_id=None):
    return generate_tokens(
        model, params, prompt_tokens, prompt_lengths, None,
        max_new_tokens=max_new_tokens,
        min_prompt_len=int(prompt_lengths.min()),
        greedy=True, eod_id=eod_id)


@torch.no_grad()
def beam_search(model, params, prompt_tokens: torch.Tensor, *,
                beam_size: int, max_new_tokens: int, eod_id: int,
                length_penalty: float = 1.0):
    """Single-prompt beam search over prompt_tokens [1, prompt_len] ->
    (beams [beam_size, total] best first, their scores: summed log-probs
    over each hypothesis's own length ** ``length_penalty``).

    The prompt is prefilled once at batch 1 and its caches copied to the
    beams; the first expansion takes the top beams of that one row; a
    finished beam proposes only EOD at no cost, and its length (prompt,
    its generated tokens and its closing EOD) stops growing."""
    cfg = model.cfg
    dev = prompt_tokens.device
    prompt_len = prompt_tokens.shape[1]
    total = prompt_len + max_new_tokens
    B = beam_size

    caches = init_kv_caches(cfg, 1, total, device=dev)
    logits, caches = _forward_with_cache(model, params,
                                         prompt_tokens.long(), caches, 0)
    zeros = torch.zeros(B, dtype=torch.long, device=dev)
    caches = [dict(c, k=c["k"].index_select(0, zeros),
                   v=c["v"].index_select(0, zeros)) for c in caches]
    lp = torch.log_softmax(logits[:, -1].float(), dim=-1)
    V = lp.shape[-1]

    tokens = torch.cat([prompt_tokens.long().repeat(B, 1),
                        torch.zeros((B, max_new_tokens), dtype=torch.long,
                                    device=dev)], dim=1)
    scores, top_idx = torch.topk(lp[0], B)
    tokens[:, prompt_len] = top_idx
    done = top_idx == eod_id
    hyp_len = torch.full((B,), prompt_len + 1, dtype=torch.long, device=dev)
    finished_lp = torch.full((B, V), -1e9, device=dev)
    finished_lp[:, eod_id] = 0.0

    pos = prompt_len
    while pos < total - 1 and not bool(done.all()):
        logits, caches = _forward_with_cache(
            model, params, tokens[:, pos:pos + 1], caches, pos)
        lp = torch.log_softmax(logits[:, -1].float(), dim=-1)
        lp = torch.where(done[:, None], finished_lp, lp)
        cand = scores[:, None] + lp
        scores, flat_idx = torch.topk(cand.reshape(-1), B)
        beam_src = flat_idx // V
        tok_next = flat_idx % V
        tokens = tokens.index_select(0, beam_src)
        tokens[:, pos + 1] = tok_next
        caches = [dict(c, k=c["k"].index_select(0, beam_src),
                       v=c["v"].index_select(0, beam_src)) for c in caches]
        was_done = done[beam_src]
        hyp_len = hyp_len[beam_src] + (~was_done).long()
        done = was_done | (tok_next == eod_id)
        pos += 1

    final = scores / (hyp_len.float() ** length_penalty)
    order = torch.argsort(-final)
    return tokens[order], final[order]
